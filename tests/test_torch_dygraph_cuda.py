"""The dygraph tape on the card (``cuda`` marker; each test skips without a
device).  Run on the GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_dygraph_cuda.py``.

- ``dropout``'s forward on the card is a raw kernel launch whose output has
  no autograd graph: the tape's gradient is its grad op, the dropout
  kernel on the output gradient with the forward's mask (mask x scale x
  upstream), the kernel launched twice;
- a traced ``flash_attention`` (K1, its backward K2 through the tape)
  gives q, k, v gradients within atol 1e-5 + rtol 1e-4 of autograd of the
  plain attention, after its inputs' gradients are scaled by the mean's
  count.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import dygraph as pdy

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return ptt.CUDAPlace(0)


def _mean(x):
    return pdy.default_tracer().trace_op("mean", {"X": [x]}, {})["Out"][0]


def test_dropout_kernel_gradient_on_the_card(card):
    from paddle_tpu_torch.kernels import dropout as dk
    dk.reset_launch_count()
    with pdy.guard(card):
        x = pdy.to_variable(np.random.RandomState(0).randn(64, 256)
                            .astype("float32"))
        outs = pdy.default_tracer().trace_op(
            "dropout", {"X": [x]},
            {"dropout_prob": 0.25,
             "dropout_implementation": "upscale_in_train"})
        y, mask = outs["Out"][0], outs["Mask"][0]
        _mean(y).backward()
        assert x.grad is not None and x.grad.device.type == "cuda"
        scale = torch.tensor(1 / 0.75, dtype=torch.float32, device="cuda")
        want = torch.where(mask.value != 0, y.grad * scale,
                           torch.zeros_like(y.grad))
        assert torch.equal(x.grad, want)
    assert dk.launch_count("dropout") == 2


def test_traced_flash_attention_on_the_card(card):
    from paddle_tpu_torch.kernels import flash_attention as fa
    fa.reset_launch_count()
    b, h, t, d = 1, 2, 128, 64
    rng = np.random.RandomState(1)
    with pdy.guard(card):
        q, k, v = (pdy.to_variable(rng.randn(b, h, t, d).astype("float32"))
                   for _ in range(3))
        o = pdy.default_tracer().trace_op(
            "flash_attention", {"Q": [q], "K": [k], "V": [v]},
            {"causal": True})["Out"][0]
        _mean(o * o).backward()
        leaves = [z.value.reshape(b * h, t, d).detach().requires_grad_(True)
                  for z in (q, k, v)]
        ref, _ = fa.flash_attention_reference(*leaves, causal=True)
        want = torch.autograd.grad(ref, leaves, o.grad.reshape(b * h, t, d))
        n = float(o.value.numel())
        for z, w in zip((q, k, v), want):
            torch.testing.assert_close(z.grad.reshape(b * h, t, d) * n,
                                       w * n, rtol=1e-4, atol=1e-5)
    assert fa.launch_count("flash_attn_fwd") == 1
    assert fa.launch_count("flash_attn_bwd") == 1
