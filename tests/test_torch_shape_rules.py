"""Shape inference by rules (``paddle_tpu_torch/ops/shape_rules.py``)
in place of meta-tensor runs of the lowerings.

- The GPT (with dropout, Adam), ResNet-50 (Momentum) and DeepFM (SGD)
  training programs get the same shape and dtype for every var with the
  rules as with every lowering run on meta tensors (the inference before
  the rules);
- a fresh process that builds those three programs (shape inference
  included) has not imported ``torch._dynamo``, which torch's Python meta
  kernels import on their first call; the subprocess has its own 120 s
  deadline;
- each rule agrees with its lowering's meta run on symbolic and static
  inputs of a few op cases.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.framework import registry
from paddle_tpu_torch.ops import shape_rules
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BUILD = textwrap.dedent("""
    def build_all():
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.framework import (Program, program_guard,
                                                unique_name)
        from paddle_tpu_torch.models import ctr, resnet
        from paddle_tpu_torch.models import transformer as T
        progs = {}
        cfg = T.BertConfig(vocab_size=30522, d_model=768, n_layer=2,
                           n_head=12, d_inner=3072, max_pos=128,
                           dropout=0.1)
        for name, build, opt in (
                ("gpt", lambda: T.build_gpt_pretrain(cfg, 128)[2],
                 lambda: optimizer.AdamOptimizer(1e-4)),
                ("resnet50", lambda: resnet.build_resnet_train(
                    class_dim=1000, depth=50,
                    image_shape=(3, 224, 224))[2],
                 lambda: optimizer.MomentumOptimizer(0.1, 0.9)),
                ("deepfm", lambda: ctr.build_ctr_train(
                    sparse_dim=10000, embed_size=16, is_sparse=True)[0],
                 lambda: optimizer.SGDOptimizer(0.2))):
            main, startup = Program(), Program()
            with unique_name.guard(), program_guard(main, startup):
                opt().minimize(build())
            progs[name] = (main, startup)
        return progs
""")

exec(_BUILD)    # defines build_all() here too


def _shapes(progs):
    return {(name, i, v.name): (v.shape, v.dtype)
            for name, ps in progs.items() for i, p in enumerate(ps)
            for v in p.list_vars()}


def test_rules_give_the_meta_inference(monkeypatch):
    with_rules = _shapes(build_all())   # noqa: F821 (from _BUILD)
    for t in shape_rules.RULES:
        monkeypatch.setattr(registry.get_op_info(t), "shape", None)
    on_meta = _shapes(build_all())      # noqa: F821
    assert len(with_rules) > 1000
    assert with_rules == on_meta
    assert sum(s is not None for s, _ in with_rules.values()) > 1000


_FRESH = _BUILD + textwrap.dedent("""
    import sys
    import paddle_tpu_torch  # noqa: F401
    progs = build_all()
    n = sum(len(p.global_block().ops) for ps in progs.values() for p in ps)
    print("ops", n, "dynamo", "torch._dynamo" in sys.modules)
""")


def test_building_imports_no_dynamo():
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    words = out.stdout.split()
    assert words[-1] == "False", out.stdout
    assert int(words[1]) > 1000


def _var_meta_run(op_type, ins, attrs):
    """The lowering on meta tensors (the inference without a rule)."""
    metas = {s: [torch.empty(m.shape, dtype=m.dtype, device="meta")
                 for m in v] for s, v in ins.items()}
    outs = registry.get_op_info(op_type).lower(registry.AbstractCtx(),
                                               metas, attrs)
    return {s: [registry.Meta(tuple(t.shape), t.dtype) for t in v]
            for s, v in outs.items() if all(t is not None for t in v)}


M = registry.Meta
S = registry.SENTINEL
f32, i64, bf16 = torch.float32, torch.int64, torch.bfloat16

CASES = {
    "add_int64": ("elementwise_add", {"X": [M((4,), i64)], "Y": [M((4,), i64)]}, {"axis": -1}),
    "add_axis0": ("elementwise_add", {"X": [M((S, 3, 5), f32)], "Y": [M((S, 3), f32)]}, {"axis": 0}),
    "add_0d": ("elementwise_add", {"X": [M((S, 7), bf16)], "Y": [M((), f32)]}, {"axis": -1}),
    "div_int": ("elementwise_div", {"X": [M((2, 3), i64)], "Y": [M((3,), i64)]}, {"axis": -1}),
    "sub_trailing": ("elementwise_sub", {"X": [M((S, 4, 3), f32)], "Y": [M((3,), f32)]}, {"axis": -1}),
    "mul_mixed": ("elementwise_mul", {"X": [M((2, 3), bf16)], "Y": [M((2, 3), f32)]}, {"axis": -1}),
    "greater": ("greater_than", {"X": [M((S, 4), f32)], "Y": [M((4,), f32)]}, {"axis": -1}),
    "scale_tensor": ("scale", {"X": [M((3, 2), f32)], "ScaleTensor": [M((1,), f32)]}, {"scale": 2.0}),
    "sum3": ("sum", {"X": [M((2, 3), f32), M((2, 3), f32), M((2, 3), f32)]}, {}),
    "matmul_batch_ty": ("matmul", {"X": [M((S, 12, 8, 64), f32)], "Y": [M((S, 12, 8, 64), f32)]}, {"transpose_Y": True, "alpha": 0.125}),
    "matmul_2d_3d": ("matmul", {"X": [M((4, 5), f32)], "Y": [M((3, 5, 6), f32)]}, {}),
    "matmul_1d": ("matmul", {"X": [M((5,), f32)], "Y": [M((5, 2), f32)]}, {"transpose_X": False}),
    "lookup_squeeze": ("lookup_table", {"W": [M((10, 4), f32)], "Ids": [M((S, 3, 1), i64)]}, {"padding_idx": -1}),
    "layer_norm": ("layer_norm", {"X": [M((S, 8, 16), bf16)], "Scale": [M((16,), f32)], "Bias": [M((16,), f32)]}, {"begin_norm_axis": 2}),
    "bn_train": ("batch_norm", {"X": [M((S, 6, 5, 5), f32)], "Scale": [M((6,), f32)], "Bias": [M((6,), f32)], "Mean": [M((6,), f32)], "Variance": [M((6,), f32)]}, {"is_test": False}),
    "bn_test_nhwc": ("batch_norm", {"X": [M((S, 5, 5, 6), f32)], "Scale": [M((6,), f32)], "Bias": [M((6,), f32)], "Mean": [M((6,), f32)], "Variance": [M((6,), f32)]}, {"is_test": True, "data_layout": "NHWC"}),
    "bn_train_nhwc": ("batch_norm", {"X": [M((3, 5, 5, 6), f32)], "Scale": [M((6,), f32)], "Bias": [M((6,), f32)], "Mean": [M((6,), f32)], "Variance": [M((6,), f32)]}, {"data_layout": "NHWC"}),
    "range": ("range", {}, {"start": 1, "end": 10, "step": 2.5, "dtype": "float32"}),
    "range_int": ("range", {}, {"start": 0, "end": 7, "step": 1, "dtype": "int64"}),
    "uniform": ("uniform_random", {}, {"shape": [3, 4], "dtype": "float32"}),
    "gaussian": ("gaussian_random", {}, {"shape": [5], "dtype": "float32", "std": 0.02}),
    "accuracy": ("accuracy", {"Out": [M((S, 5), f32)], "Indices": [M((S, 5), i64)], "Label": [M((S, 1), i64)]}, {}),
    "ce_hard": ("cross_entropy", {"X": [M((S, 10), f32)], "Label": [M((S, 1), i64)]}, {}),
    "ce_soft": ("cross_entropy", {"X": [M((S, 10), f32)], "Label": [M((S, 10), f32)]}, {"soft_label": True}),
    "mean": ("mean", {"X": [M((S, 3), f32)]}, {}),
    "pool_max_pad": ("pool2d", {"X": [M((S, 64, 112, 112), f32)]}, {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1], "pooling_type": "max"}),
    "pool_ceil": ("pool2d", {"X": [M((2, 3, 7, 7), f32)]}, {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0], "pooling_type": "avg", "ceil_mode": True}),
    "pool_global": ("pool2d", {"X": [M((S, 2048, 7, 7), f32)]}, {"global_pooling": True, "pooling_type": "avg"}),
    "pool_adaptive": ("pool2d", {"X": [M((2, 3, 8, 8), f32)]}, {"ksize": [2, 4], "adaptive": True}),
    "concat": ("concat", {"X": [M((S, 3), f32), M((S, 5), f32)]}, {"axis": 1}),
    "concat_neg": ("concat", {"X": [M((2, 3), i64), M((4, 3), i64)]}, {"axis": -2}),
    "sigmoid_ce": ("sigmoid_cross_entropy_with_logits", {"X": [M((S, 1), f32)], "Label": [M((S, 1), f32)]}, {}),
    "adam": ("adam", {"Param": [M((4, 3), f32)], "Grad": [M((4, 3), f32)], "Moment1": [M((4, 3), f32)], "Moment2": [M((4, 3), f32)], "Beta1Pow": [M((1,), f32)], "Beta2Pow": [M((1,), f32)], "LearningRate": [M((1,), f32)]}, {}),
    "sgd": ("sgd", {"Param": [M((4, 3), f32)], "Grad": [M((4, 3), f32)], "LearningRate": [M((1,), f32)]}, {}),
    "momentum": ("momentum", {"Param": [M((4, 3), f32)], "Grad": [M((4, 3), f32)], "Velocity": [M((4, 3), f32)], "LearningRate": [M((1,), f32)]}, {"mu": 0.9, "use_nesterov": True}),
    "gelu": ("gelu", {"X": [M((S, 8), bf16)]}, {}),
    "relu_int": ("relu", {"X": [M((3,), i64)]}, {}),
    "sign": ("sign", {"X": [M((3, 2), f32)]}, {}),
    "less_than": ("less_than", {"X": [M((1,), i64)], "Y": [M((1,), i64)]}, {"axis": -1}),
    "log": ("log", {"X": [M((S, 4), f32)]}, {}),
    "log_int": ("log", {"X": [M((3,), i64)]}, {}),
    "logical_not": ("logical_not", {"X": [M((S, 1), torch.bool)]}, {}),
    "squeeze_axes": ("squeeze2", {"X": [M((1, S, 1, 4), f32)]}, {"axes": [0, 2]}),
    "squeeze_all": ("squeeze2", {"X": [M((1, 3, 1), i64)]}, {"axes": []}),
    "squeeze_not_one": ("squeeze2", {"X": [M((2, 3), f32)]}, {"axes": [-1]}),
    "stack": ("stack", {"X": [M((S, 6), f32), M((S, 6), f32)]}, {"axis": 0}),
    "stack_last": ("stack", {"X": [M((2, 3), i64)] * 3}, {"axis": -1}),
    "fill_bsl": ("fill_constant_batch_size_like", {"Input": [M((3, S, 5), f32)]}, {"shape": [-1, 7], "dtype": "int32", "value": 0.0, "input_dim_idx": 1, "output_dim_idx": 0}),
    "sequence_mask": ("sequence_mask", {"X": [M((S,), i64)]}, {"maxlen": 50, "out_dtype": "float32"}),
    "array_write_new": ("array_write", {"X": [M((S, 8), f32)], "I": [M((1,), i64)]}, {"max_len": 51}),
    "array_write": ("array_write", {"X": [M((4, 8), f32)], "I": [M((1,), i64)], "Array": [M((9, 4, 8), f32)], "ArrayLen": [M((), torch.int32)]}, {"max_len": 9}),
    "array_read": ("array_read", {"Array": [M((9, S, 1), i64)], "I": [M((1,), i64)]}, {}),
    "tanh": ("tanh", {"X": [M((S, 4), bf16)]}, {}),
    "sigmoid": ("sigmoid", {"X": [M((S, 4), f32)]}, {}),
    "sqrt": ("sqrt", {"X": [M((1,), f32)]}, {}),
    "increment": ("increment", {"X": [M((1,), i64)]}, {"step": 1.0}),
    "max_axis0": ("elementwise_max", {"X": [M((S, 3), f32)], "Y": [M((S,), f32)]}, {"axis": 0}),
    "swce": ("softmax_with_cross_entropy", {"Logits": [M((S, 50), f32)], "Label": [M((S, 1), i64)]}, {}),
    "swce_3d": ("softmax_with_cross_entropy", {"Logits": [M((4, S, 50), f32)], "Label": [M((4, S, 1), i64)]}, {"axis": -1}),
    "swce_soft": ("softmax_with_cross_entropy", {"Logits": [M((S, 6), f32)], "Label": [M((S, 6), f32)]}, {"soft_label": True}),
    "reduce_mean": ("reduce_mean", {"X": [M((S, 8, 4), f32)]}, {"dim": [1, 2], "keep_dim": False}),
    "reduce_mean_keep": ("reduce_mean", {"X": [M((S, 8), bf16)]}, {"dim": [-1], "keep_dim": True}),
    "reduce_sum_all": ("reduce_sum", {"X": [M((S, 8), f32)]}, {"reduce_all": True}),
    "reduce_sum_int": ("reduce_sum", {"X": [M((3, 4), torch.int32)]}, {"dim": [0]}),
    "reduce_sum_0d": ("reduce_sum", {"X": [M((), f32)]}, {"dim": None}),
    "gather": ("gather", {"X": [M((S, 8), f32)], "Index": [M((S,), i64)]}, {}),
    "gather_col": ("gather", {"X": [M((3, 9, 2), i64)], "Index": [M((4, 1), i64)]}, {"axis": -2}),
    "squared_l2_norm": ("squared_l2_norm", {"X": [M((7, 3), f32)]}, {}),
    "masked_update": ("drnn_masked_update", {"T": [M((), i64)], "SeqLen": [M((S,), i64)], "New": [M((S, 8), f32)], "Prev": [M((S, 8), f32)]}, {}),
    "beam_search": ("beam_search", {"pre_ids": [M((6, 1), i64)], "pre_scores": [M((6, 1), f32)], "ids": [M((6, 4), i64)], "scores": [M((6, 4), f32)]}, {"beam_size": 3, "end_id": 1}),
    "beam_search_decode": ("beam_search_decode", {"Ids": [M((5, 6, 1), i64)], "Scores": [M((5, 6, 1), f32)], "Parents": [M((5, 6), i64)]}, {"beam_size": 3}),
}


def test_every_rule_has_cases():
    assert {c[0] for c in CASES.values()} == set(shape_rules.RULES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_matches_meta_run(case):
    op_type, ins, attrs = CASES[case]
    got = registry.get_op_info(op_type).shape(ins, attrs)
    want = _var_meta_run(op_type, ins, attrs)
    assert {s: v for s, v in got.items() if s in want} == want
