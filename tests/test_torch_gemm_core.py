"""The host side of the kernels on the Hopper GEMM core (K5 and the bf16
K3, ``csrc/sm90_gemm.cuh``), on the CPU.

- ``conv_bn.bf16_operand``: the bf16 K3 reads x where it lies when its
  channels are a multiple of 8, its base is 16-byte aligned and its image
  rows are whole 16-byte chunks or at most 256 pixels (ResNet-50's x at
  every shape); otherwise it gets a copy with zero channels (and, past a
  wide ragged row, zero pixels) appended.  Appending zeros leaves the
  product exactly as it was (the plain version on the padded operands, bit
  for bit) and its statistics within float32 rounding (1e-6 relative: the
  sums run over another shape, so in another order);
- ``tools/gemm_flips.flips`` counts the bf16 outputs that differ from the
  plain version's and those nearer zero; the tool refuses to run without
  a CUDA device;
- the CPU path of both wrappers launches nothing and agrees with the
  reference's (``tests/test_torch_conv_bn.py`` and
  ``tests/test_torch_dense_epilogue.py`` hold them to the JAX package).
"""

import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import conv_bn as cb
from paddle_tpu_torch.kernels import dense_epilogue as de
from paddle_tpu_torch.tools import gemm_flips
from _port_fixtures import collect_garbage_after_module  # noqa: F401

BF16 = torch.bfloat16


def _x(n, c, p, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, c, p, generator=g).to(BF16)


@pytest.mark.parametrize("c, p", [(64, 3136), (256, 784), (1024, 196),
                                  (2048, 49), (8, 1), (16, 256)])
def test_bf16_k3_reads_resnet_shapes_where_they_lie(c, p):
    x = _x(2, c, p)
    assert cb.bf16_operand(x) is x


@pytest.mark.parametrize("c, p, cx, px", [(13, 65, 16, 65), (3, 1, 8, 1),
                                          (16, 300, 16, 304),
                                          (12, 261, 16, 264)])
def test_bf16_k3_pads_what_it_cannot_read(c, p, cx, px):
    x = _x(3, c, p, seed=c + p)
    xk = cb.bf16_operand(x)
    assert tuple(xk.shape) == (3, cx, px) and xk.is_contiguous()
    assert torch.equal(xk[:, :c, :p], x)
    assert not xk[:, c:].any() and not xk[:, :, p:].any()


def test_bf16_k3_copies_an_operand_off_16_bytes():
    flat = _x(1, 1, 2 * 64 * 49 + 1).reshape(-1)
    x = flat[1:].view(2, 64, 49)          # 2 bytes past an aligned start
    assert x.data_ptr() % 16
    xk = cb.bf16_operand(x)
    assert xk.data_ptr() % 16 == 0 and torch.equal(xk, x)


def test_padding_leaves_the_product_and_statistics_exact():
    """Zero channels (and zero pixels cut off again) add nothing: the plain
    version on the padded operands gives the same y bit for bit, and s and
    s2 within float32 rounding of their sums."""
    x = _x(2, 13, 300, seed=5)
    g = torch.Generator().manual_seed(6)
    w = torch.randn(20, 13, generator=g)
    xk = cb.bf16_operand(x)
    wk = torch.nn.functional.pad(w, (0, xk.shape[1] - 13))
    y, s, s2 = cb.conv1x1_stats_plain(x, w)
    yk, sk, s2k = cb.conv1x1_stats_plain(xk, wk)
    assert torch.equal(yk[..., :300], y) and not yk[..., 300:].any()
    torch.testing.assert_close(sk, s, rtol=1e-6, atol=1e-6 * float(
        y.float().abs().sum()))
    torch.testing.assert_close(s2k, s2, rtol=1e-6, atol=0)


def test_flips_counts_the_other_neighbour_and_its_side():
    ref = torch.tensor([1.0, -2.0, 3.0, 0.5, -0.25]).to(BF16)
    up = torch.tensor([1.0078125, -2.0, 2.984375, 0.5, -0.2490234375])
    got = up.to(BF16)
    n, toward, total = gemm_flips.flips(got, ref)
    assert (n, toward, total) == (3, 2, 5)


def test_digest_tells_bit_identical_outputs_apart():
    a = torch.tensor([1.0, 2.0, -3.0]).to(BF16)
    b = a.clone()
    assert gemm_flips.digest(a) == gemm_flips.digest(b)
    b[1] = 2.015625                      # the next bf16 above 2
    assert gemm_flips.digest(a) != gemm_flips.digest(b)
    f = torch.tensor([1.0, 2.0])
    assert len(gemm_flips.digest(f)) == 12


def test_gemm_flips_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gemm_flips.run(str(_build.CSRC.parent.parent))


def test_cpu_paths_launch_nothing():
    cb.reset_launch_count()
    de.reset_launch_count()
    x = _x(2, 16, 49)
    w = torch.randn(8, 16)
    y, _, _ = cb.conv1x1_stats_fwd(x, w)
    assert y.dtype == BF16 and cb.launch_count() == 0
    xd = torch.randn(9, 20).to(BF16)
    yd = de.dense_act_fwd(xd, torch.randn(20, 12).to(BF16),
                          torch.randn(12), "gelu")
    assert yd.dtype == BF16 and de.launch_count() == 0


def test_the_core_header_is_part_of_every_build_digest(tmp_path,
                                                       monkeypatch):
    """An edit to sm90_gemm.cuh rebuilds the libraries that include it, and
    K5 keeps no mma.sync GEMM of its own."""
    src = {name: (_build.CSRC / f).read_text()
           for name, f in _build.SOURCES.items()}
    assert '#include "sm90_gemm.cuh"' in src["dense_epilogue"]
    assert '#include "sm90_gemm.cuh"' in src["conv1x1_stats"]
    assert "mma.sync" not in src["dense_epilogue"]
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest("dense_epilogue")
    with open(tmp_path / "sm90_gemm.cuh", "a") as f:
        f.write("// edited\n")
    assert _build._digest("dense_epilogue") != before
