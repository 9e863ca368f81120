"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Fluid programming model (a Program/Block/Op IR built by the layer
DSL, scopes, feed/fetch and ``Executor.run``) over torch tensors on an
NVIDIA GPU.  The executor runs a block op by op; where ``paddle_tpu`` runs
a Pallas kernel on the TPU, the port runs a CUDA kernel written for Hopper
(``paddle_tpu_torch.kernels``).  ``paddle_tpu`` is the reference the port is
held against; the port imports none of it and no JAX.

This package holds the serving slice (the GPT causal LM served through
:class:`paddle_tpu_torch.serving.InferenceServer`, and generating through
:class:`paddle_tpu_torch.serving.DecodeServer` over a paged KV cache, the
decode step one captured CUDA graph), the training slice
(``append_backward``, the static-graph optimizers, and an executor that runs
the backward pass) and ResNet training through the graph-fusion pass
(``analysis.fusion``), whose fused conv1x1 + batch-norm op runs a CUDA
kernel, and ring attention over the ``sp`` axis of a device mesh
(``parallel``), and the inference engine: ``save_inference_model``,
``load_inference_model`` and :mod:`paddle_tpu_torch.inference`'s
``AnalysisPredictor`` over the IR pass library (``framework.ir``), and the
time and memory planes: the executor's dispatch ledger and live MFU,
:mod:`paddle_tpu_torch.profiler` (host events, ``torch.profiler`` windows),
``analysis.device_profile``, ``analysis.memory``, :mod:`paddle_tpu_torch.
memory` and :mod:`paddle_tpu_torch.hbm`.
"""

from . import ops  # noqa  (registers the op lowerings)
from . import initializer, layers, regularizer  # noqa
from .clip import (GradientClipByGlobalNorm, GradientClipByNorm,  # noqa
                   GradientClipByValue)
from .compiler import CompiledProgram  # noqa
from .framework import (Program, Scope, Variable,  # noqa
                        append_backward, default_main_program,
                        default_startup_program, global_scope,
                        program_guard, scope_guard)
from .framework.executor import Executor  # noqa
from . import amp, io, models, optimizer, parallel, serving  # noqa
from . import inference  # noqa
from . import hbm, memory, profiler  # noqa
from .io import load_inference_model, save_inference_model  # noqa
from .param_attr import ParamAttr  # noqa
from .place import (CPUPlace, CUDAPlace, device_count,  # noqa
                    is_compiled_with_cuda)
from .version import __version__  # noqa
