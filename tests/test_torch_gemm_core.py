"""The host side of the kernels on the Hopper GEMM core (K5, K3 in both
dtypes and K6, ``csrc/sm90_gemm.cuh``), on the CPU.

- ``conv_bn.bf16_operand``: the bf16 K3 reads x where it lies when its
  channels are a multiple of 8, its base is 16-byte aligned and its image
  rows are whole 16-byte chunks or at most 256 pixels (ResNet-50's x at
  every shape); otherwise it gets a copy with zero channels (and, past a
  wide ragged row, zero pixels) appended.  Appending zeros leaves the
  product exactly as it was (the plain version on the padded operands, bit
  for bit) and its statistics within float32 rounding (1e-6 relative: the
  sums run over another shape, so in another order);
- ``conv_bn.f32_operand`` and ``f32_route``: the float32 K3 reads all 15
  ResNet-50 shapes where they lie, by TMA at P = 3136, 784 and 196 and
  from bulk-copied slabs at P = 49; a row of P > 64 pixels off 16 bytes
  gets zero pixels appended, a slab of P <= 64 off 16 bytes zero channels,
  an unaligned base a copy (the same exactness as above);
- ``conv_bn.mm_operand``: K6 reads x where its rows are whole 16-byte
  chunks from an aligned base (the tool's x), else a copy with zero
  columns appended;
- ``tools/gemm_flips.flips`` counts the outputs that differ from the plain
  version's and those nearer zero; the tool refuses to run without a CUDA
  device;
- the CPU path of every wrapper launches nothing and agrees with the
  reference's (``tests/test_torch_conv_bn.py``,
  ``tests/test_torch_matmul_bn.py`` and ``tests/test_torch_dense_epilogue
  .py`` hold them to the JAX package);
- every source on the core includes its header, so an edit to the header
  rebuilds them all, and none keeps an ``mma.sync`` GEMM of its own.
"""

import re

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


CORE_LIBS = ("dense_epilogue", "conv1x1_stats", "matmul_bn_stats")


@pytest.mark.parametrize("header", ["sm90_gemm.cuh", "sm90.cuh",
                                    "elem.cuh"])
@pytest.mark.parametrize("lib", CORE_LIBS)
def test_the_core_header_is_part_of_every_build_digest(tmp_path,
                                                       monkeypatch, lib,
                                                       header):
    """An edit to a header (the core's, or one it builds on) rebuilds each
    library on the core, and none keeps an mma.sync GEMM of its own."""
    src = (_build.CSRC / _build.SOURCES[lib]).read_text()
    assert '#include "sm90_gemm.cuh"' in src
    assert "mma.sync.aligned" not in src         # no mma.sync GEMM
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest(lib)
    with open(tmp_path / header, "a") as f:
        f.write("// edited\n")
    assert _build._digest(lib) != before


@pytest.mark.parametrize("lib", CORE_LIBS)
def test_an_edited_source_changes_its_own_digest_only(tmp_path, monkeypatch,
                                                      lib):
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build._digest(name) for name in CORE_LIBS}
    with open(tmp_path / _build.SOURCES[lib], "a") as f:
        f.write("// edited\n")
    after = {name: _build._digest(name) for name in CORE_LIBS}
    assert {n for n in CORE_LIBS if after[n] != before[n]} == {lib}


# -- the float32 K3: its routes and its copy rule -----------------------------

#: ResNet-50's conv1x1 shapes (Cin, Cout, H*W) at 224x224
RN50_K3 = ((64, 64, 3136), (64, 256, 3136), (256, 64, 3136),
           (256, 128, 3136), (128, 512, 784), (256, 512, 784),
           (512, 128, 784), (512, 256, 784), (256, 1024, 196),
           (512, 1024, 196), (1024, 256, 196), (1024, 512, 196),
           (512, 2048, 49), (1024, 2048, 49), (2048, 512, 49))


def _xf(n, c, p, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, c, p, generator=g)


@pytest.mark.parametrize("ci, co, p", RN50_K3)
def test_f32_k3_reads_resnet_shapes_where_they_lie(ci, co, p):
    """Every ResNet-50 shape: TMA where a float32 row is whole 16-byte
    chunks (P = 3136, 784, 196: 30 of a step's 36 launches), the slab
    route at P = 49, and no copy."""
    x = _xf(1, ci, p)
    assert cb.f32_operand(x) is x
    assert cb.f32_route(p) == ("slab" if p == 49 else "TMA")


@pytest.mark.parametrize("c, p, cx, px", [(13, 65, 13, 68), (7, 66, 7, 68),
                                          (3, 1, 4, 1), (5, 49, 8, 49),
                                          (13, 62, 16, 62)])
def test_f32_k3_pads_what_it_cannot_read(c, p, cx, px):
    """A TMA row off 16 bytes gets zero pixels; a slab (P <= 64) whose
    channels x pixels are off 16 bytes gets zero channels."""
    x = _xf(3, c, p, seed=c + p)
    xk = cb.f32_operand(x)
    assert tuple(xk.shape) == (3, cx, px) and xk.is_contiguous()
    assert xk.data_ptr() % 16 == 0
    assert torch.equal(xk[:, :c, :p], x)
    assert not xk[:, c:].any() and not xk[:, :, p:].any()
    if cb.f32_route(p) == "slab":
        assert px == p and cx * px % 4 == 0
    else:
        assert px % 4 == 0 and cx == c


def test_f32_k3_slab_limit_is_the_kernels():
    """The wrapper names the route; the kernel refuses a slab wider than
    its buffers, so both sides must hold the same limit."""
    src = (_build.CSRC / "conv1x1_stats.cu").read_text()
    m = re.search(r"constexpr int SLAB_MAX_P = (\d+);", src)
    assert m and int(m.group(1)) == cb.SLAB_MAX_P
    assert cb.f32_route(cb.SLAB_MAX_P) == "slab"
    assert cb.f32_route(cb.SLAB_MAX_P + 1) == "TMA"


@pytest.mark.parametrize("c, p", [(6, 50), (16, 49), (4, 1), (8, 3136)])
def test_f32_k3_takes_slabs_and_rows_of_whole_chunks(c, p):
    x = _xf(2, c, p)
    assert cb.f32_operand(x) is x


def test_f32_k3_copies_an_operand_off_16_bytes():
    flat = _xf(1, 1, 2 * 64 * 196 + 1).reshape(-1)
    x = flat[1:].view(2, 64, 196)          # 4 bytes past an aligned start
    assert x.data_ptr() % 16
    xk = cb.f32_operand(x)
    assert xk.data_ptr() % 16 == 0 and torch.equal(xk, x)


@pytest.mark.parametrize("c, p", [(13, 65), (5, 49), (3, 1)])
def test_f32_padding_leaves_the_product_and_statistics_exact(c, p):
    """Zero channels and pixels add nothing: the plain version on the
    padded operands gives the same y bit for bit (pixels cut off again),
    and s and s2 within float32 rounding of their sums."""
    x = _xf(2, c, p, seed=5)
    g = torch.Generator().manual_seed(6)
    w = torch.randn(20, c, generator=g)
    xk = cb.f32_operand(x)
    wk = torch.nn.functional.pad(w, (0, xk.shape[1] - c))
    y, s, s2 = cb.conv1x1_stats_plain(x, w)
    yk, sk, s2k = cb.conv1x1_stats_plain(xk, wk)
    assert torch.equal(yk[..., :p], y) and not yk[..., p:].any()
    torch.testing.assert_close(sk, s, rtol=1e-6, atol=1e-6 * float(
        y.abs().sum()))
    torch.testing.assert_close(s2k, s2, rtol=1e-6, atol=0)


# -- K6: its operand rule -----------------------------------------------------

@pytest.mark.parametrize("m, k, dtype, kx", [
    (802816 // 64, 256, BF16, 256), (4096, 64, BF16, 64), (9, 13, BF16, 16),
    (300, 40, BF16, 40), (513, 24, torch.float32, 24),
    (1032, 13, torch.float32, 16), (1, 40, torch.float32, 40),
    (257, 33, torch.float32, 36)])
def test_k6_operand_rule(m, k, dtype, kx):
    """x where its rows are whole 16-byte chunks (K % 8 in bf16, K % 4 in
    float32); else zero columns appended up to the next such width."""
    g = torch.Generator().manual_seed(m + k)
    x = torch.randn(m, k, generator=g).to(dtype)
    xk = cb.mm_operand(x)
    assert xk.shape == (m, kx) and xk.dtype == dtype
    assert (xk is x) == (kx == k)
    assert torch.equal(xk[:, :k], x) and not xk[:, k:].any()
    assert xk.data_ptr() % 16 == 0 and kx * xk.element_size() % 16 == 0


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_k6_copies_an_operand_off_16_bytes(dtype):
    flat = torch.randn(129 * 64 + 1).to(dtype)
    x = flat[1:].view(129, 64)
    assert x.data_ptr() % 16
    xk = cb.mm_operand(x)
    assert xk.data_ptr() % 16 == 0 and torch.equal(xk, x)


@pytest.mark.parametrize("stats, relu", [(False, False), (True, True)])
def test_k6_zero_columns_add_nothing_without_the_prologue(stats, relu):
    """Appended zero columns, with zero rows of w, leave the plain product
    within float32 rounding when the statistics past K are finite (or
    absent); the next test shows why the kernel still zeroes them after
    its prologue."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 13, generator=g)
    w = torch.randn(13, 9, generator=g)
    ps = (torch.full((16,), 0.5), torch.ones(16), torch.ones(16),
          torch.zeros(16)) if stats else None
    xk = cb.mm_operand(x)
    wk = torch.nn.functional.pad(w, (0, 0, 0, xk.shape[1] - 13))
    y = cb.matmul_bn_stats_plain(x, w, None if ps is None else
                                 tuple(p[:13] for p in ps), relu)[0]
    yk = cb.matmul_bn_stats_plain(xk, wk, ps, relu)[0]
    torch.testing.assert_close(yk, y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("relu", [False, True])
def test_k6_columns_past_k_are_zeroed_after_the_prologue(relu):
    """Past K a stage holds no statistics of x, only what the ring held
    before: a padded zero column normalized by them can be anything, inf
    included, and a zero row of w does not cancel an inf (0 * inf is NaN).
    Zeroing those columns after the prologue, as the kernel does (its
    ``klim`` mask), gives the unpadded product; leaving them does not."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 13, generator=g)
    w = torch.randn(13, 9, generator=g)
    ps = (torch.randn(13, generator=g) * 0.1,
          torch.rand(13, generator=g) + 0.5, torch.ones(13),
          torch.full((13,), 0.1))
    past = (-1.0, float("inf"), 1.0, 1.0)     # a stale (mu, inv, g, b)
    xk = cb.mm_operand(x)
    kx = xk.shape[1]
    pk = tuple(torch.cat((q, torch.full((kx - 13,), v)))
               for q, v in zip(ps, past))
    wk = torch.nn.functional.pad(w, (0, 0, 0, kx - 13))
    want = cb.matmul_bn_stats_plain(x, w, ps, relu)[0]
    a = (xk - pk[0]) * pk[1] * pk[2] + pk[3]
    if relu:
        a = torch.relu(a)
    stale = cb.matmul_bn_stats_plain(a, wk, None, False)[0]
    assert not torch.isfinite(stale).any()
    a[:, 13:] = 0
    kept = cb.matmul_bn_stats_plain(a, wk, None, False)[0]
    torch.testing.assert_close(kept, want, rtol=1e-6, atol=1e-6)


def test_f32_k3_and_k6_cpu_paths_launch_nothing():
    cb.reset_launch_count()
    y, s, s2 = cb.conv1x1_stats_fwd(_xf(2, 16, 49), torch.randn(8, 16))
    assert y.dtype == torch.float32 and y.shape == (2, 8, 49)
    ym, _, _ = cb.matmul_bn_stats_fwd(torch.randn(9, 13), torch.randn(13, 5),
                                      None, True)
    assert ym.shape == (9, 5)
    assert cb.launch_count() == 0
    assert cb.launch_count("matmul_bn_stats") == 0


def test_gemm_flips_names_every_kernel_on_the_core(monkeypatch):
    assert set(gemm_flips.KERNELS) == {"dense_epilogue", "conv1x1_stats_bf16",
                                       "conv1x1_stats_f32",
                                       "matmul_bn_stats"}
    assert len(gemm_flips.K6_CASES) == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gemm_flips.run(str(_build.CSRC.parent.parent),
                       ("conv1x1_stats_f32", "matmul_bn_stats"))
