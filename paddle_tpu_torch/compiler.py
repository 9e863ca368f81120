"""CompiledProgram (ref ``python/paddle/fluid/compiler.py``; the port's
counterpart of ``paddle_tpu/compiler.py:138``).

It wraps a program and runs no passes yet: no verifier, no cost or memory
stamps, and no graph fusion (the executor runs the fusion pass on a plain
Program only).  The executor runs the wrapped program as it is.
"""

from __future__ import annotations

from .framework.core import Program


class CompiledProgram:
    def __init__(self, program: Program):
        self._program = program

    @property
    def program(self) -> Program:
        return self._program
