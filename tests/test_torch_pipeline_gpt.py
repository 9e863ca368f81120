"""Pipeline parallelism in the port on a tiny GPT, on the CPU (the MLP
cases: ``test_torch_pipeline.py``).

- a 2-layer, d-64 GPT (flash attention, the unfused LM head: jitted on the
  CPU, XLA drops the bf16 rounding of the fused head's product, which the
  port keeps) cut into 2 stages at its first layer's output, against the
  JAX package's pipeline with Adam at lr 1e-3, 2 microbatches, rtol 1e-4 +
  atol 1e-5; the parameters after ``sync_to_scope`` within a tenth of an
  Adam step (Adam turns float32 noise on near-zero gradients into steps),
  and ``qkv.b`` within steps x lr (its key third's exact gradient is 0);
- the same GPT with each stage on ``[cpu, cpu]`` (a stage's dp submesh)
  against each stage on one device: losses and parameters within 1e-5,
  ``qkv.b`` within steps x lr.
"""

import numpy as np

from test_torch_pipeline import (ADAM_TOL, GPT_LR, _adam_gpt,  # noqa: F401
                                 _device_list_case, _fresh, _port_run,
                                 _ref_run)
from _port_fixtures import collect_garbage_after_module  # noqa: F401


def test_gpt_two_stages_match_reference():
    steps = 3
    init, want, ref_final = _ref_run("gpt", _adam_gpt, 2, steps)
    got, sc = _port_run("gpt", _adam_gpt, init, 2, steps)
    np.testing.assert_allclose(got, want, **ADAM_TOL)
    for name, ref in ref_final.items():
        # Adam turns float32 noise on near-zero gradients into steps: a
        # tenth of a step, and qkv.b (its key third's exact gradient is 0)
        # within steps x lr
        atol = steps * GPT_LR if name.endswith("qkv.b") else GPT_LR / 10
        np.testing.assert_allclose(np.asarray(sc.find_var(name)), ref,
                                   rtol=0, atol=atol, err_msg=name)


def test_gpt_stages_on_device_lists_match_one_device():
    _device_list_case("gpt", _adam_gpt, 2)
