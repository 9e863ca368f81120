"""The gang coordinator's high availability and the fleet's use of it in
the port, on the CPU: counterparts of ``tests/test_fleet.py:296-427`` (a
warm standby mirrors the manifest and the roles, refuses mutations until
promoted, promotes on the primary's silence and fences the zombie's
manifest write by epoch, a frame carrying a newer epoch is refused, a
client rotates through its address list) and of ``tests/
test_autoscaler.py:485-535`` (a status section riding
``status_snapshot``, the autoscaler attached to a coordinator, gangtop's
fleet footer, the standby's cross-node placement and address).
"""

import argparse
import time

import pytest

from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed.coordinator import (GangClient,
                                                      GangCoordinator)
from paddle_tpu_torch.serving.autoscaler import (AutoscalerPolicy,
                                                 FleetAutoscaler)
from _port_fixtures import collect_garbage_after_module  # noqa: F401


def _ha_pair(tmp_path, world=1, hb=0.3):
    prim = GangCoordinator(world, port=0, heartbeat_timeout_s=hb,
                           manifest_dir=str(tmp_path)).start()
    sb = GangCoordinator(world, port=0, heartbeat_timeout_s=hb,
                         manifest_dir=str(tmp_path),
                         standby_of=prim.address).start()
    return prim, sb


def test_standby_mirrors_manifest_and_roles(tmp_path):
    prim, sb = _ha_pair(tmp_path)
    client = GangClient(address=f"{prim.address},{sb.address}", rank=0,
                        world_size=1, heartbeat_interval_s=0.05,
                        role="replica", endpoint="127.0.0.1:7").connect()
    try:
        client.publish(5)
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            snap = sb.status_snapshot()
            if snap["manifest"] == 5 and \
                    snap["ranks"].get("0", {}).get("role") == "replica":
                break
            time.sleep(0.02)
        snap = sb.status_snapshot()
        assert snap["coord_role"] == "standby"
        assert snap["manifest"] == 5
        assert snap["ranks"]["0"]["role"] == "replica"
        assert snap["ranks"]["0"]["endpoint"] == "127.0.0.1:7"
    finally:
        client.close(goodbye=False)
        prim.stop()
        sb.stop()


def test_standby_refuses_mutations_until_promoted(tmp_path):
    prim, sb = _ha_pair(tmp_path)
    direct = GangClient(address=sb.address, rank=0, world_size=1,
                        heartbeat_interval_s=0.05)
    try:
        # every mutating op is refused by the standby; the
        # single-address client exhausts its redial budget fail-loud
        with pytest.raises(ConnectionError, match="unreachable"):
            direct.publish(1)
    finally:
        direct.close(goodbye=False)
        prim.stop()
        sb.stop()


def test_promotion_epoch_fences_zombie_manifest_write(tmp_path):
    prim, sb = _ha_pair(tmp_path)
    addr = f"{prim.address},{sb.address}"
    client = GangClient(address=addr, rank=0, world_size=1,
                        heartbeat_interval_s=0.05).connect()
    try:
        client.publish(3)
        prim.stop()
        deadline = time.monotonic() + 5.0
        while sb.status_snapshot()["coord_role"] != "primary":
            assert time.monotonic() < deadline, "standby never promoted"
            time.sleep(0.02)
        assert sb.status_snapshot()["epoch"] >= 1
        # client fails over transparently (bounded redial + rotation)
        client.publish(7)
        assert sb.status_snapshot()["manifest"] == 7
        with open(tmp_path / "EPOCH") as f:
            fence = int(f.read().strip())
        assert fence >= 1
        # the zombie primary (epoch 0) re-mirroring its stale manifest
        # must be DROPPED by the durable fence
        fenced0 = monitor.COORD_FENCED_CTR.value(path="manifest")
        with prim._cv:
            prim._manifest = 2          # older step, stale epoch
        prim._mirror_manifest()
        assert monitor.COORD_FENCED_CTR.value(
            path="manifest") == fenced0 + 1
        from paddle_tpu_torch.distributed.env import parse_manifest
        with open(tmp_path / "MANIFEST") as f:
            assert parse_manifest(f.read()) == 7   # not regressed
    finally:
        client.close(goodbye=False)
        prim.stop()
        sb.stop()


def test_frame_epoch_fences_stale_leader(tmp_path):
    prim, _ = GangCoordinator(1, port=0, heartbeat_timeout_s=0.3,
                              manifest_dir=str(tmp_path)).start(), None
    try:
        import socket as _s
        from paddle_tpu_torch.distributed.coordinator import (
            recv_frame, send_frame)
        host, _, port = prim.address.rpartition(":")
        with _s.create_connection((host, int(port)), timeout=5) as s:
            # a request carrying a NEWER epoch proves a newer leader
            # exists: this coordinator must refuse as fenced
            send_frame(s, {"op": "status", "epoch": 99})
            resp = recv_frame(s)
        assert resp["ok"] is False and resp["error"] == "fenced"
    finally:
        prim.stop()


def test_client_rotates_through_address_list():
    coord = GangCoordinator(1, port=0, heartbeat_timeout_s=0.5).start()
    try:
        # dead first address: the bounded redial ladder rotates to the
        # live one instead of failing loud on the first refusal
        client = GangClient(address=f"127.0.0.1:1,{coord.address}",
                            rank=0, world_size=1,
                            heartbeat_interval_s=0.05)
        client.connect()
        assert client.wait_ready(timeout_s=5.0)
    finally:
        client.close(goodbye=False)
        coord.stop()


def test_attach_status_section_rides_status_snapshot():
    coord = GangCoordinator(1, port=0)
    coord.attach_status_section("autoscaler", lambda: {"target": 3})
    st = coord.status_snapshot()
    assert st["autoscaler"] == {"target": 3}
    # a broken section must not break the whole view
    coord.attach_status_section("autoscaler",
                                lambda: 1 / 0)     # re-attach replaces
    st = coord.status_snapshot()
    assert "error" in st["autoscaler"]


def test_gangtop_renders_the_fleet_footer():
    from paddle_tpu_torch.tools.gangtop import render
    txt = render({"ranks": {}, "autoscaler": {
        "target": 2, "size": 1, "min": 1, "max": 4, "shedding": True,
        "cooldown_ticks": 3, "spawn_inflight": True,
        "last": {"action": "spawn", "reason": "burn_queue"}}})
    assert "fleet: TGT=2 SIZE=1" in txt
    assert "bounds=[1,4]" in txt and "shed=ON" in txt
    assert "last=spawn/burn_queue" in txt
    assert "SPAWN IN FLIGHT" in txt
    # no autoscaler attached: no footer
    assert "fleet: TGT" not in render({"ranks": {}})


# ---------------------------------------------------------------------------
# cross-node standby placement
# ---------------------------------------------------------------------------

def test_standby_lands_on_second_node_when_one_exists():
    from paddle_tpu_torch.distributed.launch import standby_node
    assert standby_node(["10.0.0.1"]) == "10.0.0.1"
    assert standby_node(["10.0.0.1", "10.0.0.2"]) == "10.0.0.2"
    assert standby_node(["a", "b", "c"]) == "b"


def test_gang_standby_address_is_cross_node_and_derivable():
    from paddle_tpu_torch.distributed.launch import (gang_coord_address,
                                                     gang_standby_address)
    args = argparse.Namespace(cluster_node_ips="10.0.0.1,10.0.0.2",
                              node_ip="10.0.0.1", nproc_per_node=2,
                              started_port=6170)
    # every node's launcher derives the SAME pair with no exchange
    assert gang_coord_address(args) == "10.0.0.1:6174"
    assert gang_standby_address(args) == "10.0.0.2:6175"
    solo = argparse.Namespace(cluster_node_ips="127.0.0.1",
                              node_ip="127.0.0.1", nproc_per_node=2,
                              started_port=6170)
    assert gang_standby_address(solo).startswith("127.0.0.1:")


def test_the_autoscaler_attaches_to_a_coordinator():
    """``FleetAutoscaler.attach_to`` puts the controller's status in the
    coordinator's ``status`` frame, which gangtop renders as its footer."""
    from paddle_tpu_torch.tools.gangtop import fetch_status, render

    class Router:
        def replica_view(self):
            return {}

    coord = GangCoordinator(1, port=0).start()
    try:
        sc = FleetAutoscaler(Router(), lambda: "x:9", lambda a: None,
                             policy=AutoscalerPolicy(initial_target=2),
                             interval_s=0.05)
        sc.attach_to(coord)
        st = fetch_status(coord.address)
        assert st["autoscaler"]["target"] == 2
        assert "fleet: TGT=2" in render(st)
    finally:
        coord.stop()
