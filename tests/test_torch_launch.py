"""The port's launcher (``paddle_tpu_torch/distributed/launch.py``) against
the reference's, on the CPU: the same arguments give the same per-rank
environments (``get_cluster_env``; the port names the card in
``FLAGS_selected_gpus`` where the reference names a TPU host's chips in
``FLAGS_selected_tpus``), the same coordinator and standby addresses,
the same coordinator hosting decisions, and the same parsed options.
"""

import argparse

import pytest

from paddle_tpu.distributed import launch as ref
from paddle_tpu_torch.distributed import launch
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CASES = [
    dict(cluster_node_ips="127.0.0.1", node_ip="127.0.0.1",
         nproc_per_node=2, started_port=6170),
    dict(cluster_node_ips="10.0.0.1,10.0.0.2", node_ip="10.0.0.2",
         nproc_per_node=4, started_port=7000),
    dict(cluster_node_ips="10.0.0.1,10.0.0.2,10.0.0.3", node_ip="10.0.0.1",
         nproc_per_node=1, started_port=6170),
]


def _args(case, tmp_path, **kw):
    base = dict(case, log_dir=None, gang_dir=str(tmp_path / "gang"),
                gang_backend="socket", coordinator_standby=None,
                max_restarts=0, grace_secs=60.0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("standby", [None, True])
@pytest.mark.parametrize("backend", ["socket", "file"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_cluster_env_equals_the_references(tmp_path, case, backend,
                                           standby, monkeypatch):
    monkeypatch.setattr(launch, "_visible_cards", lambda: 1)
    got = launch.get_cluster_env(_args(CASES[case], tmp_path,
                                       gang_backend=backend,
                                       coordinator_standby=standby))
    want = ref.get_cluster_env(_args(CASES[case], tmp_path,
                                     gang_backend=backend,
                                     coordinator_standby=standby))
    for g, w in zip(got, want):
        assert g.pop("FLAGS_selected_gpus") == "0"     # one card a host
        w.pop("FLAGS_selected_tpus")
    assert got == want
    if backend == "socket" and len(got) > 1:
        assert got[0]["PADDLE_GANG_COORD"].split(",")[0] == \
            launch.gang_coord_address(_args(CASES[case], tmp_path))


def test_each_rank_gets_its_card_modulo_the_visible_cards(tmp_path,
                                                          monkeypatch):
    args = _args(dict(CASES[0], nproc_per_node=4), tmp_path)
    monkeypatch.setattr(launch, "_visible_cards", lambda: 2)
    assert [e["FLAGS_selected_gpus"]
            for e in launch.get_cluster_env(args)] == ["0", "1", "0", "1"]
    monkeypatch.setattr(launch, "_visible_cards", lambda: 0)
    assert {e["FLAGS_selected_gpus"]
            for e in launch.get_cluster_env(args)} == {"0"}


@pytest.mark.parametrize("case", range(len(CASES)))
def test_coordinator_addresses_equal_the_references(tmp_path, case):
    a = _args(CASES[case], tmp_path)
    assert launch.gang_coord_address(a) == ref.gang_coord_address(a)
    assert launch.gang_standby_address(a) == ref.gang_standby_address(a)
    ips = CASES[case]["cluster_node_ips"].split(",")
    assert launch.standby_node(ips) == ref.standby_node(ips)


def test_parsed_options_equal_the_references():
    argv = ["--nproc_per_node", "2", "--started_port", "7100",
            "--log_dir", "/tmp/l", "--max_restarts", "1", "--grace_secs",
            "5", "train.py", "--lr", "0.1"]
    assert vars(launch._parse_args(argv)) == vars(ref._parse_args(argv))


def test_one_rank_hosts_no_coordinator(tmp_path):
    a = _args(dict(CASES[0], nproc_per_node=1), tmp_path)
    assert launch.start_coordinator(a) == [] == ref.start_coordinator(a)
    from paddle_tpu_torch.tools.gang_smoke import free_port
    coords = launch.start_coordinator(_args(CASES[0], tmp_path,
                                            started_port=free_port()))
    try:
        assert len(coords) == 1 and coords[0].world_size == 2
    finally:
        for c in coords:
            c.stop()
