"""Programs and weights carried between the JAX package and the port.

- a program serialized by ``paddle_tpu`` parses in the port and
  re-serializes to the same bytes;
- ``build_gpt_serving`` builds the same op list, names, shapes, dtypes and
  attrs in both packages (main and startup programs);
- the whole forward of a tiny GPT (the CFG of ``tests/test_serving.py``)
  matches: the reference initializes the weights, the port gets them as
  numpy, both executors run the same feed (tolerance 1e-4 on the logits);
- ``load_params`` reads a directory ``paddle_tpu.io.save_params`` wrote,
  bfloat16 included.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CFG = dict(vocab_size=48, d_model=16, n_layer=2, n_head=2, d_inner=32,
           max_pos=64, dropout=0.0)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh port default programs, scope and names for every test."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _build_ref(seq, attn_impl):
    main, startup = RefProgram(), RefProgram()
    with ref_guard(main, startup), ref_names.guard():
        _, logits = RT.build_gpt_serving(
            RT.BertConfig(**dict(CFG, max_pos=max(seq, 64))), seq,
            attn_impl=attn_impl)
    return main, startup, logits.name


def _build_port(seq, attn_impl):
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup), unique_name.guard():
        _, logits = T.build_gpt_serving(
            T.BertConfig(**dict(CFG, max_pos=max(seq, 64))), seq,
            attn_impl=attn_impl)
    return main, startup, logits.name


@pytest.mark.parametrize("attn_impl", ["flash", "base"])
def test_reference_blob_parses_and_reserializes_unchanged(attn_impl):
    main, startup, _ = _build_ref(16, attn_impl)
    for prog in (main, startup):
        blob = prog.serialize_to_string()
        parsed = core.Program.parse_from_string(blob)
        assert parsed.serialize_to_string() == blob
        assert [op.type for op in parsed.global_block().ops] == \
            [op.type for op in prog.global_block().ops]


@pytest.mark.parametrize("seq,attn_impl", [(16, "flash"), (16, "base"),
                                           (8, "auto"), (1024, "auto")])
def test_build_gpt_serving_same_program(seq, attn_impl):
    ref_main, ref_startup, ref_out = _build_ref(seq, attn_impl)
    main, startup, out = _build_port(seq, attn_impl)
    assert out == ref_out
    for ours, theirs in ((main, ref_main), (startup, ref_startup)):
        assert json.loads(ours.serialize_to_string()) == \
            json.loads(theirs.serialize_to_string())
    types = {op.type for op in main.global_block().ops}
    assert ("flash_attention" in types) == (
        attn_impl == "flash" or (attn_impl == "auto" and seq >= 1024))


@pytest.fixture(scope="module")
def ref_weights():
    """Reference-initialized parameters of the tiny GPT, as numpy."""
    _, startup, _ = _build_ref(8, "base")
    ref_scope = RefScope()
    RefExecutor().run(startup, scope=ref_scope, seed=7)
    return {v.name: np.asarray(ref_scope.find_var(v.name))
            for v in startup.global_block().vars.values()}


@pytest.mark.parametrize("attn_impl", ["flash", "base", "auto"])
def test_tiny_gpt_forward_matches_reference(ref_weights, attn_impl):
    ids = np.random.RandomState(1).randint(1, CFG["vocab_size"],
                                           (3, 16)).astype(np.int64)
    ref_main, _, ref_out = _build_ref(16, attn_impl)
    ref_scope = RefScope()
    for n, a in ref_weights.items():
        ref_scope.set_var(n, jnp.asarray(a))
    ref, = RefExecutor().run(ref_main, feed={"src_ids": ids},
                             fetch_list=[ref_out], scope=ref_scope)

    main, _, out = _build_port(16, attn_impl)
    port_scope = ptt.io.params_from_numpy(scope.Scope(), ref_weights)
    got, = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"src_ids": ids}, fetch_list=[out], scope=port_scope)
    assert got.shape == (3, 16, CFG["vocab_size"])
    np.testing.assert_allclose(got, np.asarray(ref), **LOGITS_TOL)


def test_port_startup_initializes_every_parameter():
    main, startup, out = _build_port(8, "base")
    port_scope = scope.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=port_scope, seed=3)
    params = main.all_parameters()
    assert params and all(
        tuple(port_scope.find_var(p.name).shape) == tuple(p.shape)
        for p in params)
    ids = np.ones((2, 8), np.int64)
    logits, = exe.run(main, feed={"src_ids": ids}, fetch_list=[out],
                      scope=port_scope)
    assert logits.shape == (2, 8, CFG["vocab_size"])
    assert np.isfinite(logits).all()


def test_run_before_startup_names_the_missing_parameter():
    main, _, out = _build_port(8, "base")
    with pytest.raises(RuntimeError, match="startup program"):
        ptt.Executor(ptt.CPUPlace()).run(
            main, feed={"src_ids": np.ones((1, 8), np.int64)},
            fetch_list=[out], scope=scope.Scope())


def test_load_params_reads_reference_directory(tmp_path, ref_weights):
    ref_main, _, _ = _build_ref(8, "base")
    ref_scope = RefScope()
    for n, a in ref_weights.items():
        ref_scope.set_var(n, jnp.asarray(a))
    # one parameter travels as bfloat16 (uint16 bits on disk)
    ref_scope.set_var("lm_out.b",
                      jnp.asarray(ref_weights["lm_out.b"], jnp.bfloat16))
    pt.io.save_params(dirname=str(tmp_path / "params"),
                      main_program=ref_main, scope=ref_scope)

    main, _, _ = _build_port(8, "base")
    port_scope = scope.Scope()
    ptt.io.load_params(dirname=str(tmp_path / "params"), main_program=main,
                       scope=port_scope)
    names = {p.name for p in main.all_parameters()}
    assert names == {p.name for p in ref_main.all_parameters()}
    for n in names - {"lm_out.b"}:
        np.testing.assert_array_equal(port_scope.find_var(n).numpy(),
                                      ref_weights[n])
    b = port_scope.find_var("lm_out.b")
    assert b.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        b.float().numpy(),
        np.asarray(jnp.asarray(ref_weights["lm_out.b"],
                               jnp.bfloat16).astype(jnp.float32)))


def _encoder_program(pkg_core, names, M, layers_mod):
    """A BERT-style encoder (pos/type embeddings, an additive attention
    bias) plus a cross-attention block with separate q/k/v projections."""
    main, startup = pkg_core.Program(), pkg_core.Program()
    with pkg_core.program_guard(main, startup), names.guard():
        src = layers_mod.data("src_ids", shape=[8], dtype="int64")
        pos = layers_mod.data("pos_ids", shape=[8], dtype="int64")
        typ = layers_mod.data("type_ids", shape=[8], dtype="int64")
        bias = layers_mod.data("bias", shape=[2, 8, 8], dtype="float32")
        enc = M.encoder(src, pos, 48, 16, 2, 16, 32, 2, attn_bias=bias,
                        type_ids=typ, attn_impl="base")
        mem = layers_mod.data("mem", shape=[6, 16], dtype="float32")
        M.multi_head_attention(enc, mem, mem, 16, 2, param_prefix="cross",
                               attn_impl="flash")
    return main, startup


def test_encoder_and_cross_attention_build_the_same_program():
    from paddle_tpu import layers as ref_layers
    from paddle_tpu_torch import layers
    ref_main, ref_startup = _encoder_program(
        pt.framework.core, ref_names, RT, ref_layers)
    main, startup = _encoder_program(core, unique_name, T, layers)
    for ours, theirs in ((main, ref_main), (startup, ref_startup)):
        assert json.loads(ours.serialize_to_string()) == \
            json.loads(theirs.serialize_to_string())


def test_load_params_reads_a_combined_file(tmp_path, ref_weights):
    ref_main, _, _ = _build_ref(8, "base")
    ref_scope = RefScope()
    for n, a in ref_weights.items():
        ref_scope.set_var(n, jnp.asarray(a))
    pt.io.save_params(dirname=str(tmp_path), main_program=ref_main,
                      scope=ref_scope, filename="params.npz")
    main, _, _ = _build_port(8, "base")
    port_scope = scope.Scope()
    ptt.io.load_params(dirname=str(tmp_path), main_program=main,
                       scope=port_scope, filename="params.npz")
    for p in main.all_parameters():
        np.testing.assert_array_equal(port_scope.find_var(p.name).numpy(),
                                      ref_weights[p.name])
