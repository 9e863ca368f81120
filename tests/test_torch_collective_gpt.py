"""A tiny GPT (2 layers, d 32, seq 16, batch 8) with Adam under
``GradAllReduce`` in the port's collective mode against the JAX package's,
4 steps at dp 2 and dp 4 on the CPU: the cases and bounds of
``test_torch_collective.py`` (``check_training``), in a file of their own
because the reference's two ``shard_map`` compiles take ~10 s each."""

import pytest

from test_torch_collective import _fresh, check_training  # noqa: F401
from _port_fixtures import collect_garbage_after_module  # noqa: F401


@pytest.mark.parametrize("n", [2, 4])
def test_gpt_training_matches_reference(n):
    check_training("gpt", "grad_allreduce", n)
