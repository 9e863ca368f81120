"""GSPMD with the default mesh in the port: one model-parallel axis over
every device (``FLAGS_gspmd_mesh`` empty), on the CPU over four virtual
ranks, the toy flash GPT against the one-device run (the helpers of
``test_torch_gspmd.py``)."""

import numpy as np
import torch

from paddle_tpu_torch import monitor
from paddle_tpu_torch.analysis.sharding import plan_sharding
from test_torch_gspmd import TOL, _port_run, _ref_single
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")


def test_default_mesh_is_model_parallel_over_every_device():
    """``with_gspmd()`` with no axes: one mp axis over the devices
    (``FLAGS_gspmd_mesh`` empty).  With no dp the plan pins no activation,
    so the toy flash GPT's residual stream stays split: its layer_norms
    reduce their statistics over the ring (``norm_stats``), the residual
    joins take the whole operand's block, and one-sided contractions
    gather their split input; the backward traffic those add outside the
    plan counts under ``paddle_tpu_gspmd_unplanned_bytes_total``."""
    init, want = _ref_single("gpt", 3)
    _, _, single, _, _ = _port_run("gpt", init, grads=True)
    ctr = monitor.REGISTRY.get("paddle_tpu_gspmd_unplanned_bytes_total")
    reasons = ("norm_stats_bwd", "join_bwd", "gather_bwd")
    before = {r: ctr.value(reason=r) for r in reasons}
    main, sc, got, moved, loss = _port_run(
        "gpt", init, lambda c: c.with_gspmd(rules="mp_hidden_vocab",
                                            devices=[CPU] * 4),
        grads=True)
    assert main._attrs["partition"]["mesh_axes"] == {"dp": 1, "mp": 4}
    np.testing.assert_allclose([float(g[0]) for g in got], want, **TOL)
    for step, (g, s) in enumerate(zip(got, single)):
        for k, (a, b) in enumerate(zip(g[1:], s[1:])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=f"step {step} grad {k}")
    plan = plan_sharding(main, [loss], batch_size=8)
    assert {"norm_stats", "spec_mismatch"} <= {e.reason for e in plan.edges}
    assert moved == 3 * plan.payload_bytes
    assert all(ctr.value(reason=r) > before[r] for r in reasons)
