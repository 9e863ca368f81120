"""Measured device-time attribution (``analysis/device_profile.py``) of the
port against the JAX package's, on the CPU.

- one synthetic event list (three steps, kernels on two streams, a step
  annotated on both streams, a kernel outside every step, host frames
  that must not count) is written once as a Kineto trace for the port
  (``kernel`` events on GPU streams, ``gpu_user_annotation`` ranges named
  ``paddle_tpu.step#<id>``, host ``cpu_op`` / ``cuda_runtime`` /
  ``user_annotation`` events) and once in the reference's lane convention
  (a ``/device:GPU:0`` process, ``paddle_tpu.step`` spans carrying
  ``step_num``): both ``attribute()`` functions give the same per-step
  device and span ms, idle fractions, per-class ms and shares to 1e-9;
- ``classify_kernel`` on the port's own kernel names (demangled as Kineto
  writes them), on cuBLAS, cuDNN, NCCL, copy and memset names and on
  PyTorch's elementwise, reduce and index kernels;
- a malformed window warns and gives None (``summarize_and_publish``
  counts it and never raises); ``summarize_window``'s measured MFU is the
  analytic flops over the mean busy seconds over the peak.
"""

import gzip
import json
import os

import pytest

from paddle_tpu.analysis import device_profile as ref_dp
from paddle_tpu_torch import monitor
from paddle_tpu_torch.analysis import device_profile as dp
from _port_fixtures import collect_garbage_after_module  # noqa: F401

TOL = 1e-9

#: (name, stream, ts_us, dur_us): the device work of the synthetic window
KERNELS = [
    ("flash_fwd_sm90_kernel", 7, 100.0, 40.0),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn", 7, 150.0, 30.0),
    ("vectorized_elementwise_kernel", 8, 160.0, 50.0),   # overlaps
    ("conv_f32_kernel", 7, 400.0, 25.0),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 8, 420.0, 10.0),
    ("embedding_gather_kernel", 7, 700.0, 5.0),
    ("infeed_host_to_device", 8, 710.0, 12.5),
    ("flash_bwd_sm90_dq_kernel", 7, 760.0, 30.0),
    ("vectorized_elementwise_kernel", 7, 2000.0, 7.0),   # in no step
]
#: (step id, stream, ts_us, dur_us): step 3 is annotated on both streams
STEPS = [(1, 7, 90.0, 130.0), (2, 7, 390.0, 50.0), (3, 7, 690.0, 110.0),
         (3, 8, 705.0, 20.0)]


def _write(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _kineto_trace(path):
    ev = [{"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "GPU 0"}},
          {"ph": "M", "name": "process_name", "pid": 4242,
           "args": {"name": "python3"}}]
    for name, tid, ts, dur in KERNELS:
        cat = "gpu_memcpy" if "host_to_device" in name else "kernel"
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                   "tid": tid, "ts": ts, "dur": dur})
    for step, tid, ts, dur in STEPS:
        ev.append({"ph": "X", "cat": "gpu_user_annotation",
                   "name": f"paddle_tpu.step#{step}", "pid": 0, "tid": tid,
                   "ts": ts, "dur": dur})
        # the host side of the same range (ignored: the device form wins)
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": f"paddle_tpu.step#{step}", "pid": 4242,
                   "tid": 1, "ts": ts - 80.0, "dur": dur + 200.0})
    # host frames and runtime calls never count as device time
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242,
            "tid": 1, "ts": 95.0, "dur": 300.0},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 4242, "tid": 1, "ts": 99.0, "dur": 4.0}]
    _write(path, ev)


def _reference_trace(path):
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "/device:GPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 2,
           "args": {"name": "/host:CPU"}}]
    for name, tid, ts, dur in KERNELS:
        ev.append({"ph": "X", "name": name, "pid": 1, "tid": tid,
                   "ts": ts, "dur": dur})
    for step, tid, ts, dur in STEPS:
        ev.append({"ph": "X", "name": "paddle_tpu.step", "pid": 1,
                   "tid": tid, "ts": ts, "dur": dur,
                   "args": {"step_num": str(step)}})
    ev.append({"ph": "X", "name": "python_frame", "pid": 2, "tid": 1,
               "ts": 95.0, "dur": 300.0})
    _write(path, ev)


def _close(a, b, path="$"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_names_classify_alike_in_both_packages():
    for name, *_ in KERNELS:
        assert dp.classify_kernel(name) == ref_dp.classify_kernel(name), name


def test_attribute_matches_reference(tmp_path):
    _kineto_trace(str(tmp_path / "port.json.gz"))
    _reference_trace(str(tmp_path / "ref.json.gz"))
    got = dp.attribute(dp.parse_trace(str(tmp_path / "port.json.gz")))
    want = ref_dp.attribute(ref_dp.parse_trace(str(tmp_path /
                                                   "ref.json.gz")))
    _close(got, want)
    assert got["n_steps"] == 3
    assert [r["step"] for r in got["steps"]] == [1, 2, 3]
    # step 1: flash 100-140, gemm 150-180, elementwise 160-210 (overlap)
    assert abs(got["steps"][0]["device_ms"] - 0.1) <= TOL
    assert abs(got["steps"][0]["span_ms"] - 0.13) <= TOL
    assert abs(got["unattributed_ms"] - 0.007) <= TOL
    assert abs(sum(got["per_class_share"].values()) - 1.0) <= 1e-6
    for row in got["steps"]:
        assert row["device_ms"] <= row["span_ms"]


def test_step_join_and_lanes(tmp_path):
    _kineto_trace(str(tmp_path / "port.json.gz"))
    trace = dp.parse_trace(str(tmp_path / "port.json.gz"))
    steps = dp.step_intervals(trace)
    assert [(s["step"], s["ts"], s["dur"]) for s in steps] == [
        (1, 90.0, 130.0), (2, 390.0, 50.0), (3, 690.0, 110.0)]
    assert dp.device_lanes(trace) == [(0, 7), (0, 8)]
    by_step = dp.kernels_by_step(trace)
    assert {k: len(v) for k, v in by_step.items()} == {
        1: 3, 2: 2, 3: 3, None: 1}


def test_host_only_trace_has_spans_and_no_device_time(tmp_path):
    path = str(tmp_path / "host.json.gz")
    _write(path, [{"ph": "X", "cat": "user_annotation",
                   "name": "paddle_tpu.step#5", "pid": 1, "tid": 1,
                   "ts": 0.0, "dur": 1000.0},
                  {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                   "pid": 1, "tid": 1, "ts": 10.0, "dur": 500.0}])
    out = dp.attribute(dp.parse_trace(path))
    assert out["n_steps"] == 1 and out["steps"][0]["device_ms"] == 0.0
    assert out["idle_frac"] == 1.0 and out["per_class_share"] == {}


PORT_KERNELS = {
    # the port's kernels, as Kineto demangles them
    "void (anonymous namespace)::flash_fwd_sm90_kernel<64, 3>(CUtensorMap,"
    " CUtensorMap, CUtensorMap, float const*, float*, float*, int, int, "
    "float, bool)": "attention",
    "void (anonymous namespace)::flash_bwd_sm90_dkdv_kernel<64, 3, 2>("
    "CUtensorMap, CUtensorMap)": "attention",
    "void (anonymous namespace)::flash_bwd_sm90_dq_kernel<64, 3>("
    "CUtensorMap)": "attention",
    "void (anonymous namespace)::flash_bwd_sm90_delta_kernel<float>("
    "float const*, float const*, float*, int, int)": "attention",
    "void (anonymous namespace)::skeleton_fwd_sm90_kernel<64>("
    "CUtensorMap)": "attention",
    "void (anonymous namespace)::skeleton_bwd_sm90_kernel<64, true>("
    "CUtensorMap)": "attention",
    "void (anonymous namespace)::ring_merge_kernel<float, 4>(float const*,"
    " float const*, float const*)": "attention",
    "void sm90::split_planes_kernel<4>(float const*, __nv_bfloat16*, long "
    "long)": "elementwise",
    "void f32k::conv_f32_kernel<true, 2>(CUtensorMap, CUtensorMap, "
    "CUtensorMap, f32k::Args)": "conv",
    "void bf16k::conv_tma_kernel<(anonymous namespace)::Epi>(CUtensorMap,"
    " CUtensorMap)": "conv",
    "void bf16k::conv_gather_kernel(CUtensorMap, bf16k::Args)": "conv",
    "void (anonymous namespace)::stats_kernel(float const*, float const*, "
    "float*, int, int)": "elementwise",
    "void (anonymous namespace)::mm_stats_kernel<true, 1>(CUtensorMap, "
    "CUtensorMap, CUtensorMap, Args)": "matmul",
    "void (anonymous namespace)::dense_act_kernel<float, 1, true>("
    "CUtensorMap, CUtensorMap)": "matmul",
    "void (anonymous namespace)::round_pad_kernel<float>(float const*, "
    "__nv_bfloat16*, long, long)": "elementwise",
    "void sm90g::round_w_kernel<float>(float const*, __nv_bfloat16*, "
    "long)": "elementwise",
    "void (anonymous namespace)::ln_fwd_kernel<float, 4, 6>(float const*,"
    " float const*)": "elementwise",
    "void (anonymous namespace)::ln_bwd_row_kernel<float, 6>(float "
    "const*)": "elementwise",
    "void (anonymous namespace)::colsum_kernel(float const*, float*, int,"
    " int)": "elementwise",
    "void (anonymous namespace)::dropout_kernel<float, true>(float const*"
    ", float*, unsigned char*, long)": "elementwise",
}
LIBRARY_KERNELS = {
    # names read from a Kineto trace of the GPT and ResNet-50 steps on the
    # H100 (cuBLAS, cuDNN and PyTorch kernels, truncated as they were)
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warp"
    "size2x2x1_ffma_aligna4_alignc4_execute_kern": "matmul",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>("
    "cutlass_80_simt_sgemm_256x128_8x4_nn_align1": "matmul",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, "
    "float, false, float, float, float, true, ": "matmul",
    "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize64x64x8_stage3_"
    "warpsize2x2x1_ffma_aligna8_alignc8_execute_ker": "conv",
    "void fft2d_r2c_16x16<float>(float2*, float const*, int, int, int, "
    "int, int, int, int, int)": "conv",
    "void flip_filter<float, float>(float*, float const*, int, int, int, "
    "int)": "conv",
    "void cudnn::winograd_nonfused::winogradWgradData4x4<float, float>("
    "cudnn::winograd_nonfused::WinogradDataParams": "conv",
    "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>("
    "int, int, int, float const*, int, float con": "conv",
    "void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>(int, "
    "int, int, float const*, int, float*, float ": "conv",
    "void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, "
    "false, false, true>(int, int, int, float co": "conv",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, at::"
    "native::_cuda_scatter_gather_internal_kernel<f": "embedding",
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, "
    "long*, int, long, long, long, long, bool)": "embedding",
    "void (anonymous namespace)::indexing_backward_kernel<float, 4>(long "
    "const*, long const*, float const*, float*,": "embedding",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "AUnaryFunctor<float, float, float, at::native::b": "elementwise",
    "void at::native::elementwise_kernel<128, 2, at::native::"
    "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float": "elementwise",
    "Memcpy HtoD (Pinned -> Device)": "infeed",
    "Memcpy DtoH (Device -> Pageable)": "infeed",
    "void cudnn::engines_precompiled::scalePackedTensor_kernel<float, "
    "float>(long, float*, float)": "other",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_"
    "detail::cub::DeviceRadixSortPolicy<long, at::c": "other",
    "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_warpgroup"
    "size1x1x1_execute_segment_k_off_kernel__5x_cublas": "matmul",
    "nvjet_tst_128x192_64x4_2x1_v_bz_coopB_TNT": "matmul",
    "ampere_sgemm_128x64_tn": "matmul",
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_32x3_nn_"
    "align4>(cutlass_80_tensorop_s1688gemm_128x128_32x3_nn_align4::"
    "Params)": "matmul",
    "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nchwkcrs_nchw_"
    "tilesize128x128x32": "conv",
    "sm80_xmma_wgrad_implicit_gemm_indexed_tf32f32_tf32f32_f32_nhwckrsc":
        "conv",
    "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, "
    "1>(cudnnTensorStruct)": "elementwise",
    "void cudnn::ops::nchwToNhwcKernel<float, float, float, false, true>("
    "cudnn::ops::nchw2nhwc_params_t<float>)": "elementwise",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<"
    "4096ul>)": "collective",
    "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
        "collective",
    "Memcpy HtoD (Pageable -> Device)": "infeed",
    "Memcpy DtoH (Device -> Pinned)": "infeed",
    "Memcpy DtoD (Device -> Device)": "elementwise",
    "Memset (Device)": "elementwise",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "FillFunctor<float>, at::detail::Array<char*, 1> >(int, at::native::"
    "FillFunctor<float>, at::detail::Array<char*, 1>)": "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::MeanOps<float, float, float, float>, unsigned int, float,"
    " 4> >(at::native::ReduceOp<float>)": "elementwise",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)>": "elementwise",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<float,"
    " long, unsigned int, 2, 2, -2, true>(at::cuda::detail::TensorInfo)":
        "embedding",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
    "unsigned int, 3, 128, 1>(float*)": "elementwise",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
    "float>(float*, float const*, int)": "elementwise",
}


@pytest.mark.parametrize("name", sorted(PORT_KERNELS) +
                         sorted(LIBRARY_KERNELS))
def test_classify_kernel(name):
    want = {**PORT_KERNELS, **LIBRARY_KERNELS}[name]
    assert dp.classify_kernel(name) == want
    assert want in dp.MEASURED_CLASSES


def test_classify_unknown_is_other():
    assert dp.classify_kernel("qqq_kernel_zzz") == "other"


def _summary_ctr(outcome):
    return monitor.REGISTRY.get(
        "paddle_tpu_profile_summaries_total").value(outcome=outcome)


def test_malformed_window_warns_and_returns_none(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.warns(UserWarning, match="no trace"):
        assert dp.summarize_window(str(empty)) is None
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "trace.json.gz").write_bytes(b"\x1f\x8b truncated")
    with pytest.warns(UserWarning, match="unreadable trace"):
        assert dp.summarize_window(str(bad)) is None
    n = _summary_ctr("empty")
    with pytest.warns(UserWarning):
        assert dp.summarize_and_publish(str(bad)) is None
    assert _summary_ctr("empty") == n + 1
    assert not os.path.exists(bad / "summary.json")


def test_summarize_window_measured_mfu(tmp_path):
    _kineto_trace(str(tmp_path / "trace.json.gz"))
    s = dp.summarize_window(str(tmp_path), flops_per_step=3e9,
                            peak_flops=1e15,
                            analytic_share={"matmul": 0.5, "conv": 0.2,
                                            "attention": 0.2, "norm": 0.1})
    busy = [r["device_ms"] for r in s["steps"] if r["device_ms"] > 0]
    want = 3e9 / (sum(busy) / len(busy) / 1e3) / 1e15
    assert abs(s["measured"]["mfu_measured"] - round(want, 6)) <= 1e-12
    spans = [r["span_ms"] for r in s["steps"]]
    assert abs(s["measured"]["mfu_analytic_over_span"] - round(
        3e9 / (sum(spans) / len(spans) / 1e3) / 1e15, 6)) <= 1e-12
    table = {r["op_class"]: r for r in s["divergence"]["per_class"]}
    assert abs(table["elementwise"]["analytic_flop_share"] - 0.1) <= TOL
    assert s["divergence"]["wasted_headroom"][0]["wasted_ms"] >= \
        s["divergence"]["wasted_headroom"][-1]["wasted_ms"]
    # the same window through the reference's summary arithmetic
    run = tmp_path / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    _reference_trace(str(run / "x.trace.json.gz"))
    ref = ref_dp.summarize_window(
        str(tmp_path), flops_per_step=3e9, peak_flops=1e15,
        analytic_share={"matmul": 0.5, "conv": 0.2, "attention": 0.2,
                        "norm": 0.1})
    _close(s["measured"], ref["measured"])
    _close(s["divergence"], ref["divergence"])


def test_summarize_and_publish_sets_gauges(tmp_path):
    _kineto_trace(str(tmp_path / "trace.json.gz"))
    n = _summary_ctr("ok")
    path = dp.summarize_and_publish(str(tmp_path))
    assert path == str(tmp_path / "summary.json")
    assert _summary_ctr("ok") == n + 1
    s = json.load(open(path))
    assert dp.IDLE_FRAC_GAUGE.value() == s["idle_frac"]
    shares = {labels["op_class"]: cell.get()
              for labels, cell in dp.DEVICE_SHARE_GAUGE.series()
              if cell.get()}
    assert shares == s["per_class_share"]
