"""Program IR: Program / Block / Operator / Variable.

The port's copy of ``paddle_tpu/framework/core.py`` (the Fluid program model,
reference ``paddle/fluid/framework/framework.proto:24-187``,
``python/paddle/fluid/framework.py``).  The IR, its serialization and its
JSON format are the reference's, so a program serialized by ``paddle_tpu``
parses here and re-serializes to the same bytes.

The executor of the port (``paddle_tpu_torch.framework.executor``) runs a
Block op by op, eagerly, on torch tensors.
"""

from __future__ import annotations

import copy
import itertools
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import unique_name

# ---------------------------------------------------------------------------
# dtype handling.  The reference uses VarType::Type protobuf enums
# (framework.proto:91-124); we use numpy dtype strings canonically and accept
# numpy / torch dtypes / python types on input.
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "bfloat16": "bfloat16",
    "int": "int32",
    "long": "int64",
    "bool": "bool",
    bool: "bool",
    int: "int32",
    float: "float32",
}


def convert_dtype(dtype) -> str:
    """Normalize a dtype spec to a canonical string name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        d = _DTYPE_ALIASES.get(dtype, dtype)
    elif dtype in _DTYPE_ALIASES:
        d = _DTYPE_ALIASES[dtype]
    elif str(dtype).startswith("torch."):
        d = str(dtype)[len("torch."):]
    else:
        d = np.dtype(dtype).name if not hasattr(dtype, "name") else dtype.name
    allowed = {
        "float16", "bfloat16", "float32", "float64",
        "int8", "uint8", "int16", "int32", "int64", "bool",
    }
    if d not in allowed:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return d


class VarType:
    """Variable kinds (reference ``framework.proto:91-124`` VarType::Type)."""

    DENSE_TENSOR = "dense_tensor"     # ref: LOD_TENSOR
    SELECTED_ROWS = "selected_rows"   # sparse {rows, values} pairs (embeddings)
    TENSOR_ARRAY = "tensor_array"     # ref: LOD_TENSOR_ARRAY
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


class Variable:
    """A typed symbolic value in a Block.

    Mirrors ``python/paddle/fluid/framework.py:383`` (Variable): name, shape,
    dtype, persistable, stop_gradient.  ``lod_level`` from the reference is
    replaced by an optional ``segments`` marker: ragged sequences are carried as
    dense padded data plus an explicit length/segment-id companion var (SURVEY
    §5.7 — the TPU-native stand-in for LoD).
    """

    def __init__(self, block: "Block", name: str, shape=None, dtype=None,
                 type: str = VarType.DENSE_TENSOR, persistable: bool = False,
                 stop_gradient: bool = False, initializer=None,
                 is_parameter: bool = False, trainable: bool = True,
                 regularizer=None, need_clip: bool = True):
        self.block = block
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.initializer = initializer
        self.is_parameter = is_parameter
        self.trainable = trainable
        self.regularizer = regularizer
        self.need_clip = need_clip
        # companion var name holding sequence lengths (LoD replacement)
        self.seq_len_var: Optional[str] = None
        # GSPMD sharding annotation: tuple of mesh-axis names (or None) per
        # dim, e.g. (None, "mp") for a column-parallel weight.  This is the
        # TPU-native stand-in for the reference's per-var placement logic in
        # multi_devices_graph_pass (params were only ever replicated or
        # round-robin "Reduce"-sharded there).
        self.dist_spec = None

    # -- sugar mirroring the reference Variable's operator overloads ---------
    def _binary(self, other, op, reverse=False):
        from ..layers import math_ops
        return math_ops._elementwise_binary(self, other, op, reverse)

    def __add__(self, o): return self._binary(o, "elementwise_add")
    def __radd__(self, o): return self._binary(o, "elementwise_add", True)
    def __sub__(self, o): return self._binary(o, "elementwise_sub")
    def __rsub__(self, o): return self._binary(o, "elementwise_sub", True)
    def __mul__(self, o): return self._binary(o, "elementwise_mul")
    def __rmul__(self, o): return self._binary(o, "elementwise_mul", True)
    def __truediv__(self, o): return self._binary(o, "elementwise_div")
    def __rtruediv__(self, o): return self._binary(o, "elementwise_div", True)
    def __pow__(self, o): return self._binary(o, "elementwise_pow")
    def __neg__(self):
        from ..layers import math_ops
        return math_ops.scale(self, scale=-1.0)

    # comparisons build compare ops (==/!= are NOT overridden: Variables
    # must stay usable in python containers)
    def __lt__(self, o): return self._binary(o, "less_than")
    def __le__(self, o): return self._binary(o, "less_equal")
    def __gt__(self, o): return self._binary(o, "greater_than")
    def __ge__(self, o): return self._binary(o, "greater_equal")

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def astype(self, dtype):
        from ..layers import tensor as tensor_layers
        return tensor_layers.cast(self, dtype)

    def to_dict(self):
        return {
            "name": self.name, "shape": list(self.shape) if self.shape else None,
            "dtype": self.dtype, "type": self.type,
            "persistable": self.persistable, "stop_gradient": self.stop_gradient,
            "is_parameter": self.is_parameter, "trainable": self.trainable,
            # the feed marker (layers.data sets it post-construction) must
            # survive serialization: the verifier and the static memory
            # planner classify feeds by it (tools/analyze.py runs offline)
            "is_data": bool(getattr(self, "is_data", False)),
        }


# Parameter is a Variable that is persistable + trainable
# (reference framework.py:3718).
Parameter = Variable


class Operator:
    """One op invocation: type + named input/output var lists + attrs.

    Mirrors ``OpDesc`` (reference ``framework.proto:43-62``) and python
    ``Operator`` (framework.py:1107).  inputs/outputs are {slot: [var names]}.
    """

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {}
        self.outputs: Dict[str, List[str]] = {}
        self.attrs: Dict[str, Any] = dict(attrs or {})
        for slot, vs in (inputs or {}).items():
            self.inputs[slot] = [v.name if isinstance(v, Variable) else v
                                 for v in _as_list(vs)]
        for slot, vs in (outputs or {}).items():
            self.outputs[slot] = [v.name if isinstance(v, Variable) else v
                                  for v in _as_list(vs)]
        # role tagging (ref op_proto_maker.h OpRole + framework.py _op_role):
        # append_backward/optimizers set the program's current role so
        # clone(for_test=True) can prune the training-only tail
        role = getattr(block.program, "_current_role", None) if block else None
        if role is not None and "op_role" not in self.attrs:
            self.attrs["op_role"] = role

    def input(self, slot) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot) -> List[str]:
        return self.outputs.get(slot, [])

    def input_arg_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_arg_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"

    def to_dict(self):
        def _attr(v):
            if isinstance(v, Block):
                return {"__block__": v.idx}
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            return v
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs,
                "attrs": {k: _attr(v) for k, v in self.attrs.items()}}


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Block:
    """A straight-line list of ops over a var table; nests via parent_idx.

    Mirrors ``BlockDesc`` (framework.proto:178-187) / python Block
    (framework.py:1556).  Sub-blocks are used by control-flow ops
    (while/cond), which the port has not taken over yet.
    """

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name=None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, initializer=None,
                         trainable=True, regularizer=None,
                         need_clip=True) -> Variable:
        # parameters always live in block 0 / global scope (ref framework.py:1769)
        gb = self.program.global_block()
        v = Variable(gb, name, shape=shape, dtype=dtype, persistable=True,
                     initializer=initializer, is_parameter=True,
                     trainable=trainable, regularizer=regularizer,
                     need_clip=need_clip)
        gb.vars[name] = v
        return v

    def var(self, name) -> Variable:
        """Find var in this block or ancestors (ref Block._var_recursive)."""
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name) -> bool:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return True
            b = b.parent
        return False

    def var_local(self, name) -> Optional[Variable]:
        return self.vars.get(name)

    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        # build-time shape/dtype inference keeps Variable metadata populated,
        # standing in for the reference's C++ InferShape pass
        # (framework/operator.cc:913).
        from . import registry
        registry.infer_op(op, self)
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        from . import registry
        registry.infer_op(op, self)
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        from . import registry
        registry.infer_op(op, self)
        return op

    def remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def all_parameters(self) -> List[Variable]:
        return [v for v in self.vars.values() if v.is_parameter]

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": {n: v.to_dict() for n, v in self.vars.items()},
                "ops": [op.to_dict() for op in self.ops]}


_program_ids = itertools.count()

# serialized-program format version (ref framework/version.h kCurProgramVersion
# — a program saved by a newer format refuses to load on an older framework)
PROGRAM_FORMAT_VERSION = 1


class Program:
    """A list of Blocks; block 0 is global (ref framework.py:2899).

    Two process-global default programs exist — main + startup — exactly as in
    the reference (framework.py:3813,3846): layer calls append compute ops to
    the main program and parameter-init ops to the startup program.
    """

    def __init__(self):
        self.id = next(_program_ids)
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0          # mutation counter -> executor cache key
        self.random_seed = 0
        # name -> attr dict for program-level metadata (e.g. dist info)
        self._attrs: Dict[str, Any] = {}
        self._current_role: Optional[str] = None

    def _op_role_guard(self, role: str):
        """Ops created inside carry attrs['op_role']=role (ref
        framework.py _op_role / _optimized_guard)."""
        import contextlib

        @contextlib.contextmanager
        def guard():
            prev = self._current_role
            self._current_role = role
            try:
                yield
            finally:
                self._current_role = prev
        return guard()

    # -- blocks --------------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx=None) -> Block:
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def _rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    # -- queries -------------------------------------------------------------
    def all_parameters(self) -> List[Variable]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def fingerprint(self) -> Tuple[int, int]:
        """(program id, version) — the executor hashes this EVERY step
        (twice on the fast path), so the tuple is cached and only rebuilt
        after a version bump; ``getattr`` keeps ``Program.__new__``-style
        construction paths (clone/prune/ir) safe without each one having
        to initialize the cache slot."""
        fp = getattr(self, "_fp_cache", None)
        if fp is None or fp[1] != self._version:
            fp = self._fp_cache = (self.id, self._version)
        return fp

    # -- cloning / pruning ---------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program (ref framework.py Program.clone:3098).

        ``for_test=True`` switches ops with an ``is_test`` attr into inference
        mode (dropout off, batch_norm uses running stats), mirroring
        ``_prune_with_input``+``_inference_optimize`` in the reference.
        """
        p = Program.__new__(Program)
        p.id = next(_program_ids)
        p._version = 0
        p.random_seed = self.random_seed
        p._attrs = copy.deepcopy(self._attrs)
        p._current_block_idx = 0
        p._current_role = None
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            p.blocks.append(nb)
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                nv = Variable(nb, name, shape=v.shape, dtype=v.dtype,
                              type=v.type, persistable=v.persistable,
                              stop_gradient=v.stop_gradient,
                              initializer=v.initializer,
                              is_parameter=v.is_parameter,
                              trainable=v.trainable,
                              regularizer=v.regularizer,
                              need_clip=v.need_clip)
                nv.seq_len_var = v.seq_len_var
                # GSPMD layout: a clone (the optimized program) keeps the
                # parameter specs and the accumulators' parameter links
                nv.dist_spec = v.dist_spec
                if getattr(v, "shard_like", None):
                    nv.shard_like = v.shard_like
                if getattr(v, "is_data", False):
                    nv.is_data = True
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and op.attrs.get("op_role") in (
                        "backward", "optimize", "lrsched"):
                    # ref framework.py clone docstring: "We will prune the
                    # backward and optimize part of the program when you
                    # use clone after Optimizer.minimize"
                    continue
                attrs = {}
                for k, val in op.attrs.items():
                    if isinstance(val, Block):
                        attrs[k] = p.blocks[val.idx]
                    else:
                        attrs[k] = copy.deepcopy(val)
                if for_test and "is_test" in attrs:
                    attrs["is_test"] = True
                nop = Operator(nb, op.type, None, None, attrs)
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nb.ops.append(nop)
        return p

    def _prune(self, targets: Sequence[Variable]) -> "Program":
        """Keep only ops needed to compute ``targets`` (ref framework/prune.cc).

        Operates on block 0 with a reverse liveness sweep; control-flow ops are
        kept whole (their sub-blocks ride along).
        """
        target_names = {t.name if isinstance(t, Variable) else t for t in targets}
        pruned = self.clone()
        blk = pruned.global_block()
        needed = set(target_names)
        keep: List[Operator] = []
        for op in reversed(blk.ops):
            if op.type in ("feed", "fetch"):
                continue
            if needed & set(op.output_arg_names()):
                keep.append(op)
                needed |= set(op.input_arg_names())
        blk.ops = list(reversed(keep))
        pruned._bump_version()
        return pruned

    # -- serialization (stands in for protobuf ProgramDesc bytes) -----------
    def to_dict(self):
        from ..version import __version__
        return {"version": PROGRAM_FORMAT_VERSION,
                "framework_version": __version__,
                "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    def serialize_to_string(self) -> bytes:
        return json.dumps(self.to_dict()).encode("utf-8")

    @staticmethod
    def parse_from_string(data: bytes) -> "Program":
        d = json.loads(data.decode("utf-8"))
        # ref framework/version.h IsProgramVersionSupported: refuse blobs
        # from a NEWER format (older formats load — fields default)
        fmt = int(d.get("version", 0))
        if fmt > PROGRAM_FORMAT_VERSION:
            raise ValueError(
                f"program blob has format version {fmt}, newer than this "
                f"framework supports ({PROGRAM_FORMAT_VERSION}) — upgrade "
                "paddle_tpu_torch to load it (saved by framework "
                f"{d.get('framework_version', '<unknown>')!r})")
        p = Program.__new__(Program)
        p.id = next(_program_ids)
        p._version = 0
        p.random_seed = d.get("random_seed", 0)
        p._attrs = {}
        p._current_block_idx = 0
        p._current_role = None
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            p.blocks.append(b)
        for bd, b in zip(d["blocks"], p.blocks):
            for name, vd in bd["vars"].items():
                b.vars[name] = Variable(
                    b, name, shape=vd["shape"], dtype=vd["dtype"],
                    type=vd["type"], persistable=vd["persistable"],
                    stop_gradient=vd["stop_gradient"],
                    is_parameter=vd.get("is_parameter", False),
                    trainable=vd.get("trainable", True))
                if vd.get("is_data"):
                    b.vars[name].is_data = True
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__block__" in v:
                        attrs[k] = p.blocks[v["__block__"]]
                    elif isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    else:
                        attrs[k] = v
                op = Operator(b, od["type"], None, None, attrs)
                op.inputs = {k: list(v) for k, v in od["inputs"].items()}
                op.outputs = {k: list(v) for k, v in od["outputs"].items()}
                b.ops.append(op)
        return p

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"-- block {b.idx} (parent {b.parent_idx}) --")
            for op in b.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


def sub_blocks_of(op) -> List[Tuple[str, Block]]:
    """The Block-valued attrs of one op, sorted by attr name."""
    return sorted(((k, v) for k, v in op.attrs.items()
                   if isinstance(v, Block)), key=lambda kv: kv[0])


def sub_block_io(op) -> set:
    """Every name read or written inside ``op``'s sub-blocks, nested ones
    included (the reference's ``_collect_io``, ``control_flow.py:98``)."""
    out: set = set()
    for _, sub in sub_blocks_of(op):
        for inner in sub.ops:
            out.update(n for n in inner.input_arg_names() if n)
            out.update(n for n in inner.output_arg_names() if n)
            out |= sub_block_io(inner)
    return out


# ---------------------------------------------------------------------------
# default program machinery (ref framework.py:3813-3926)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


class program_guard:
    """``with program_guard(main, startup):`` scoped default-program switch
    (ref framework.py:3926)."""

    def __init__(self, main_program: Program, startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        self.old_main = switch_main_program(self.main)
        if self.startup is not None:
            self.old_startup = switch_startup_program(self.startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self.old_main)
        if self.startup is not None:
            switch_startup_program(self.old_startup)
        return False


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    """Reference grad-var naming convention (framework/operator.h:57)."""
    return name + GRAD_SUFFIX
