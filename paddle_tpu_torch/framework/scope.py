"""Scope: name -> value store for persistent variables.

The port's copy of ``paddle_tpu/framework/scope.py`` (reference
``framework/scope.h:46``): a name -> value map with parent fallback.  Values
are ``torch.Tensor``s on the executor's device; an executor that finds a
numpy array or a tensor on another device moves it to its device and stores
it back.  Temporaries never enter a Scope: the executor frees each one after
its last reader.
"""

from __future__ import annotations

import contextlib
import itertools
import weakref
from typing import Any, Dict, Iterator, Optional

_scope_serials = itertools.count()

#: every live Scope (weak): the host's live-bytes reader
#: (``memory.live_bytes`` on the CPU) sums the tensors they hold
LIVE_SCOPES: "weakref.WeakSet" = weakref.WeakSet()


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self._vars: Dict[str, Any] = {}
        self.kids = []
        self._serial = next(_scope_serials)
        LIVE_SCOPES.add(self)

    def var(self, name: str):
        """Create-or-get, like ref Scope::Var."""
        if name not in self._vars:
            self._vars[name] = None
        return self._vars.get(name)

    def _owning_scope(self, name: str) -> Optional["Scope"]:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s
            s = s.parent
        return None

    def find_var(self, name: str):
        s = self._owning_scope(name)
        return s._vars[name] if s is not None else None

    def has_var(self, name: str) -> bool:
        return self._owning_scope(name) is not None

    def set_var(self, name: str, value) -> None:
        self._vars[name] = value

    def set_vars(self, mapping: Dict[str, Any]) -> None:
        self._vars.update(mapping)

    def erase(self, name: str) -> None:
        s = self._owning_scope(name)
        if s is not None:
            del s._vars[name]

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self.kids.append(kid)
        return kid

    def drop_kids(self) -> None:
        self.kids.clear()

    def local_var_names(self) -> Iterator[str]:
        return iter(list(self._vars))

    def items(self):
        return self._vars.items()


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """ref ``python/paddle/fluid/executor.py`` scope_guard."""
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()
