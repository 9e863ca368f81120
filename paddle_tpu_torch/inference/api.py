"""Predictor API (the port of ``paddle_tpu/inference/api.py``; ref
``inference/api/analysis_predictor.h:46`` AnalysisPredictor,
``inference/api/api_impl.h`` NativePaddlePredictor,
``inference/api/analysis_config.cc`` AnalysisConfig).

A predictor resolves an *engine* once per (model artifact, ir_optim,
device) in the process: the loaded program after the analysis passes, its
feed and fetch names, the parameters as tensors on the predictor's device,
and the callable that runs the program (``framework.function``).  A second
predictor on the same artifact shares it, so the load, the passes and
``conv_bn_fuse_pass``'s fold run once; ``paddle_tpu_predictor_engine_total
{cache=hit|miss}`` counts the outcomes.  Re-saving the artifact at the same
path changes its mtimes, misses, and evicts the stale engine.

The predictor runs on ``CUDAPlace(device_id)``, the card unless the config
asks for the host (``disable_gpu()``); without a card it raises, it never
carries on on the host.  Left out for now: ``export_stablehlo`` (it
becomes ``torch.export``).
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import io as _io
from .. import monitor as _monitor
from ..framework import ir
from ..framework.executor import _to_numpy
from ..framework.function import program_as_function
from ..framework.scope import Scope
from ..place import CPUPlace, CUDAPlace, checked_device

_ENGINE_CACHE: Dict[tuple, "_InferenceEngine"] = {}  # guarded-by: _ENGINE_LOCK
_ENGINE_LOCK = threading.Lock()
_ENGINE_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_predictor_engine_total",
    "AnalysisPredictor engine resolutions by cache outcome: a 'hit' "
    "predictor skipped the model load and the analysis passes",
    ("cache",))


class _InferenceEngine:
    """What predictors of one artifact share: the analyzed program, its
    feed and fetch names, the parameters on the device, the callable, the
    loaded scope (which the folding passes rewrote) and the passes'
    ``*_count`` attributes."""

    __slots__ = ("program", "feed_names", "fetch_names", "params", "fn",
                 "scope", "device", "pass_counts")

    def __init__(self, program, feed_names, fetch_names, params, fn,
                 scope, device, pass_counts):
        self.program = program
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.params = params
        self.fn = fn
        self.scope = scope
        self.device = device
        self.pass_counts = pass_counts


def _engine_cache_key(config: "AnalysisConfig",
                      device: torch.device) -> Optional[tuple]:
    """The artifact on disk, the config and the device, with the mtimes of
    the program file and of the params (``params_file``, or
    ``__meta__.json`` and the directory) last, so a re-save misses.  None:
    not cacheable."""
    if not config.model_dir:
        return None
    try:
        root = os.path.realpath(config.model_dir)
        stamps = [os.stat(os.path.join(
            root, config.prog_file or "__model__")).st_mtime_ns]
        if config.params_file:
            stamps.append(os.stat(
                os.path.join(root, config.params_file)).st_mtime_ns)
        else:
            meta = os.path.join(root, "__meta__.json")
            if os.path.exists(meta):
                stamps.append(os.stat(meta).st_mtime_ns)
            stamps.append(os.stat(root).st_mtime_ns)
    except OSError:
        return None
    return (root, config.prog_file, config.params_file,
            bool(config._ir_optim), str(device), tuple(stamps))


def clear_engine_cache() -> None:
    with _ENGINE_LOCK:
        _ENGINE_CACHE.clear()


class AnalysisConfig:
    """ref AnalysisConfig: the model's location and the execution
    switches.  The predictor runs on the card (``CUDAPlace(device_id)``)
    unless :meth:`disable_gpu` asks for the host."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        # the executor frees each temporary after its last reader: always
        self._memory_optim = True
        self._ir_optim = True

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        if memory_pool_init_size_mb != 100:
            from ..flags import warn_noop
            warn_noop("AnalysisConfig.enable_use_gpu("
                      "memory_pool_init_size_mb)",
                      "torch's caching allocator grows on demand")
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def enable_memory_optim(self):
        self._memory_optim = True

    def set_model(self, model_dir, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return self._device_id

    def place(self):
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    def model_dir_path(self):
        return self.model_dir


class PaddleTensor:
    """ref paddle_api.h PaddleTensor — name + ndarray payload."""

    def __init__(self, data=None, name: str = ""):
        self.name = name
        self.data = np.asarray(data) if data is not None else None

    @property
    def shape(self):
        return list(self.data.shape)

    def as_ndarray(self):
        return self.data


class ZeroCopyTensor:
    """ref ZeroCopyTensor — a named slot bound to a predictor's input or
    output; outputs stay tensors on the device until :meth:`copy_to_cpu`."""

    def __init__(self, name: str, predictor: "AnalysisPredictor",
                 is_input: bool):
        self.name = name
        self._pred = predictor
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        self._pred._inputs[self.name] = np.asarray(arr)

    def reshape(self, shape):
        pass  # shapes come from the array itself

    def copy_to_cpu(self):
        return _to_numpy(self._pred._outputs[self.name])


class AnalysisPredictor:
    """ref analysis_predictor.cc AnalysisPredictor::Init/Run/ZeroCopyRun:
    the engine of the config's artifact (built or shared), run on the
    config's device."""

    def __init__(self, config: AnalysisConfig):
        self.config = config
        self.device = checked_device(config.place(), "AnalysisPredictor")
        key = _engine_cache_key(config, self.device)
        engine = None
        if key is not None:
            with _ENGINE_LOCK:
                engine = _ENGINE_CACHE.get(key)
        if engine is None:
            _ENGINE_CTR.inc(1, cache="miss")
            engine = self._build_engine(config, self.device)
            if key is not None:
                with _ENGINE_LOCK:
                    # a re-saved artifact has a new key: the engines of
                    # its earlier saves go, so a refresh loop holds one
                    for stale in [k for k in _ENGINE_CACHE
                                  if k[:-1] == key[:-1] and k != key]:
                        del _ENGINE_CACHE[stale]
                    # the first build wins: every predictor shares it
                    engine = _ENGINE_CACHE.setdefault(key, engine)
        else:
            _ENGINE_CTR.inc(1, cache="hit")
        self._engine = engine
        self.scope = engine.scope
        self.program = engine.program
        self.feed_names = engine.feed_names
        self.fetch_names = engine.fetch_names
        self.pass_counts = engine.pass_counts
        self._params = engine.params
        self._fn = engine.fn
        self._inputs: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, Any] = {}

    @staticmethod
    def _build_engine(config: AnalysisConfig,
                      device: torch.device) -> _InferenceEngine:
        scope = Scope()
        program, feed_names, fetch_names = _io.load_inference_model(
            config.model_dir, model_filename=config.prog_file,
            params_filename=config.params_file, scope=scope)
        counts = {}
        if config._ir_optim:
            # the analysis pass pipeline (ref inference/analysis/
            # ir_pass_manager.cc), in the order of
            # ``paddle_tpu/inference/api.py:226-262``
            keep = frozenset(fetch_names)
            g = ir.Graph(program)
            g = ir.get_pass("conv_bn_fuse_pass", scope=scope).apply(g)
            # conv + bias + act before fuse_elewise_add_act, which would
            # take the add → act tail
            g = ir.get_pass("conv_elementwise_add_act_fuse_pass",
                            protected=keep).apply(g)
            g = ir.get_pass("fc_fuse_pass", protected=keep).apply(g)
            # the recurrent chains, the most specific first; the bias
            # folds need the scope
            for name in ("embedding_fc_lstm_fuse_pass",
                         "fc_gru_fuse_pass", "fc_lstm_fuse_pass"):
                g = ir.get_pass(name, protected=keep,
                                scope=scope).apply(g)
            g = ir.get_pass("seqconv_eltadd_relu_fuse_pass",
                            protected=keep).apply(g)
            g = ir.get_pass("fuse_elewise_add_act_pass",
                            protected=keep).apply(g)
            for name in ("repeated_fc_relu_fuse_pass",
                         "squared_mat_sub_fuse_pass",
                         "transpose_flatten_concat_fuse_pass",
                         "seqpool_concat_fuse_pass"):
                g = ir.get_pass(name, protected=keep).apply(g)
            # long dense attention onto flash_attention (K1 on the card);
            # the scope lets a frozen causal mask become causal=True
            g = ir.get_pass("attention_fuse_pass", protected=keep,
                            scope=scope).apply(g)
            program = g.to_program()
            counts = {k: v for k, v in g.attrs.items()
                      if k.endswith("_count")}
        params = {}
        for name, val in list(scope.items()):
            if val is None:
                continue
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.ascontiguousarray(val))
            params[name] = val.to(device)
            scope.set_var(name, params[name])
        fn = program_as_function(program, feed_names, fetch_names)
        return _InferenceEngine(program, feed_names, fetch_names, params,
                                fn, scope, device, counts)

    def _dispatch(self, arrays) -> tuple:
        feeds = []
        for a in arrays:
            t = a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(a))
            feeds.append(t.to(self.device))
        return self._fn(self._params, *feeds)

    # -- classic Run API (ref api_impl.cc NativePaddlePredictor::Run) --------
    def run(self, inputs: Sequence[PaddleTensor]) -> List[PaddleTensor]:
        by_name = {t.name: t.data for t in inputs if t.name}
        ordered = []
        for i, name in enumerate(self.feed_names):
            if name in by_name:
                ordered.append(by_name[name])
            elif i < len(inputs):
                ordered.append(inputs[i].data)
            else:
                raise ValueError(f"missing input for feed {name!r}")
        outs = self._dispatch(ordered)
        return [PaddleTensor(_to_numpy(o), name=n)
                for n, o in zip(self.fetch_names, outs)]

    # -- zero-copy API -------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self.feed_names)

    def get_output_names(self) -> List[str]:
        return list(self.fetch_names)

    def get_input_tensor(self, name: str) -> ZeroCopyTensor:
        return ZeroCopyTensor(name, self, True)

    def get_output_tensor(self, name: str) -> ZeroCopyTensor:
        return ZeroCopyTensor(name, self, False)

    def zero_copy_run(self):
        outs = self._dispatch([self._inputs[n] for n in self.feed_names])
        self._outputs = dict(zip(self.fetch_names, outs))


# ref api naming
PaddlePredictor = AnalysisPredictor


def create_paddle_predictor(config: AnalysisConfig) -> AnalysisPredictor:
    """ref CreatePaddlePredictor<AnalysisConfig>."""
    return AnalysisPredictor(config)


class NativePaddlePredictor(AnalysisPredictor):
    """ref inference/api/api_impl.h: the predictor without the analysis
    passes (the same engine with ir_optim off)."""

    def __init__(self, config: AnalysisConfig):
        cfg = copy.copy(config)       # never mutate the caller's config
        cfg.switch_ir_optim(False)
        super().__init__(cfg)
