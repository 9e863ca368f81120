#!/usr/bin/env python
"""gangtop: a live per-rank table of the gang, rendered from the
coordinator's ``status`` view — `top` for a training gang.

Each row is one rank: liveness, current training step, durably-committed
step, and the heartbeat metrics digest (step-time estimate, live MFU,
measured MFU_M% from the rank's last parsed profiler window (digest key
``mfu_m``, presence-gated — only ranks with a recent window summary
carry it), the GSPMD RULES table the rank's planner chose (from the
fingerprint's ``#rules=`` suffix; a mixed-table gang gets a footer flag
BEFORE the step barrier refuses), the hbm plane's live HBM bytes and
HDRM% headroom-of-budget — a rank
under the risk threshold is flagged ``<-- OOM-RISK`` — the comms
plane's COMM time and BW% bus bandwidth, dataloader queue depth,
executor in-flight depth, plus the serving-load columns a fleet router
reads — serving queue depth SRVQ, last batch occupancy OCC, free
decode slots SLOT, decode TOK/S).  The slowest live rank NET of comm
wait is flagged ``<-- straggler`` (the same rank the coordinator's
``paddle_tpu_gang_straggler_rank`` gauge names); a rank whose step is
dominated by WIRE time (not straggler wait) is flagged
``<-- COMM-BOUND``.  The footer carries the gang-level view: status,
step skew, manifest, fingerprint mismatch.

Usage:
    python -m paddle_tpu_torch.tools.gangtop [--coord HOST:PORT]
        [--interval 2.0] [--once]

(the port of ``tools/gangtop.py``; it reads the same ``status`` frame from
a port or a reference coordinator).

``--coord`` defaults to ``$PADDLE_GANG_COORD`` (the launcher exports it
for every rank).  ``--once`` prints a single snapshot and exits — the
scriptable/CI form; without it the table refreshes in place.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def fetch_status(address: str, timeout_s: float = 5.0) -> dict:
    """One status round-trip on a one-shot connection (the coordinator's
    frame codec: a 4-byte big-endian length, then JSON)."""
    from paddle_tpu_torch.distributed.coordinator import (recv_frame,
                                                          send_frame)
    host, _, port = address.rpartition(":")
    with socket.create_connection((host, int(port)),
                                  timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        send_frame(s, {"op": "status"})
        return recv_frame(s)


def _fmt(v, spec="{:.1f}", dash="-"):
    if v is None:
        return dash
    try:
        return spec.format(v)
    except (TypeError, ValueError):
        return dash


#: a rank is flagged <-- OOM-RISK when its measured headroom fraction
#: (hdrm / (hbm + hdrm) = headroom over budget) falls under this
#: (the reference's ``hbm.OOM_RISK_HEADROOM_FRAC``; the tool imports no
#: more of the package than the frame codec)
OOM_RISK_FRAC = 0.10


def hdrm_frac(digest: dict):
    """Headroom fraction of budget from the digest's hbm/hdrm keys
    (budget = live + headroom by construction); None when the rank
    carries no headroom signal (no budget known, or keys shed)."""
    hbm = digest.get("hbm")
    hdrm = digest.get("hdrm")
    if not isinstance(hbm, (int, float)) or \
            not isinstance(hdrm, (int, float)) or hbm + hdrm <= 0:
        return None
    return hdrm / float(hbm + hdrm)


def oom_risk(digest: dict) -> bool:
    """True when the rank's measured HBM headroom fraction is under the
    risk threshold — the gang is one allocation spike from a dead rank,
    and the runbook (README 'Memory observability') should fire BEFORE
    the OOM forensics dump has to."""
    frac = hdrm_frac(digest)
    return frac is not None and frac < OOM_RISK_FRAC


def comm_bound(digest: dict) -> bool:
    """A rank is COMM-BOUND when over half its step is comm time AND
    that comm time is wire-dominated (less than half of it is straggler
    wait).  Wait-dominated comm means the rank is stalled on a slow
    PEER — that peer gets the straggler flag; flagging the waiting rank
    comm-bound would send the runbook after the wrong problem."""
    step = digest.get("step_ms")
    comm = digest.get("comm_ms")
    if not isinstance(step, (int, float)) or \
            not isinstance(comm, (int, float)) or step <= 0 or comm <= 0:
        return False
    wait = digest.get("comm_wait")
    wait = float(wait) if isinstance(wait, (int, float)) else 0.0
    return comm / step > 0.5 and wait / comm < 0.5


def render(status: dict) -> str:
    ranks = status.get("ranks", {})
    rows = []
    header = (f"{'RANK':>4}  {'STATE':<8} {'ROLE':<8} "
              f"{'STEP':>8} {'SAVED':>7} "
              f"{'STEP_MS':>9} {'MFU%':>6} {'MFU_M%':>6} "
              f"{'HBM':>8} {'HDRM%':>6} "
              f"{'COMM':>7} {'BW%':>6} "
              f"{'GNORM':>8} {'NANF':>6} "
              f"{'QUEUE':>5} {'INFL':>4} "
              f"{'SRVQ':>5} {'OCC':>5} {'SLOT':>4} {'TOK/S':>7} "
              f"{'RULES':>10} "
              f"{'HB_AGE':>7} {'DEATHS':>6}")
    rows.append(header)
    rows.append("-" * len(header))
    # the coordinator computes the aggregates ONCE (_aggregates_locked)
    # and ships them in the status payload, so this table can never
    # disagree with the paddle_tpu_gang_straggler_rank gauge
    agg = status.get("aggregates") or {}
    straggler = str(agg.get("straggler", -1))
    for r in sorted(ranks, key=int):
        e = ranks[r]
        state = ("done" if e.get("finished")
                 else "alive" if e.get("alive") else "DEAD")
        d = e.get("digest") or {}
        mfu = d.get("mfu")
        # measured MFU (digest key mfu_m): presence-gated like the
        # serving keys — only ranks that recently parsed a profiler
        # window carry it, everyone else renders '-'
        mfu_m = d.get("mfu_m")
        nanf = d.get("nanf")
        bw = d.get("comm_bw")
        hbm = d.get("hbm")
        hfrac = hdrm_frac(d)
        line = (f"{r:>4}  {state:<8} "
                f"{str(e.get('role') or 'trainer')[:8]:<8} "
                f"{_fmt(e.get('cur_step'), '{}'):>8} "
                f"{_fmt(e.get('step'), '{}'):>7} "
                f"{_fmt(d.get('step_ms')):>9} "
                f"{_fmt(mfu * 100 if isinstance(mfu, (int, float)) else None):>6} "
                f"{_fmt(mfu_m * 100 if isinstance(mfu_m, (int, float)) else None):>6} "
                f"{_fmt(hbm / 2**30 if isinstance(hbm, (int, float)) else None, '{:.2f}G'):>8} "
                f"{_fmt(hfrac * 100 if hfrac is not None else None, '{:.0f}'):>6} "
                f"{_fmt(d.get('comm_ms')):>7} "
                f"{_fmt(bw * 100 if isinstance(bw, (int, float)) else None):>6} "
                f"{_fmt(d.get('gnorm'), '{:.3g}'):>8} "
                f"{_fmt(nanf, '{:.0f}'):>6} "
                f"{_fmt(d.get('queue'), '{:.0f}'):>5} "
                f"{_fmt(d.get('inflight'), '{}'):>4} "
                f"{_fmt(d.get('srv_q'), '{:.0f}'):>5} "
                f"{_fmt(d.get('occ'), '{:.1f}'):>5} "
                f"{_fmt(d.get('slots'), '{:.0f}'):>4} "
                f"{_fmt(d.get('tps'), '{:.1f}'):>7} "
                f"{str(e.get('gspmd_rules') or '-')[:10]:>10} "
                f"{_fmt(e.get('age_s'), '{:.1f}s'):>7} "
                f"{_fmt(e.get('deaths'), '{}'):>6}")
        if r == straggler:
            line += "   <-- straggler"
        elif comm_bound(d):
            # straggler-consistent by construction: the flag fires only
            # on WIRE-dominated comm time, and never on the straggler
            # itself — a rank whose comm is mostly WAIT is a victim of
            # the straggler (already flagged above), not of the network
            line += "   <-- COMM-BOUND"
        if isinstance(nanf, (int, float)) and nanf > 0:
            line += "   <-- NONFINITE"
        if oom_risk(d):
            line += "   <-- OOM-RISK"
        rows.append(line)
    rows.append("")
    rows.append(f"gang: {status.get('status', '?')}"
                f"  dead={status.get('dead', [])}"
                f"  step_skew={_fmt(agg.get('step_skew'), '{}')}"
                f"  manifest={status.get('manifest')}"
                f"  coord={status.get('coord_role', 'primary')}"
                f"/epoch={status.get('epoch', 0)}")
    # fleet autoscaler footer (the controller attaches its status to
    # the coordinator via attach_status_section): target vs live size,
    # shed state, and the last decision — the self-driving fleet's
    # one-line health read
    asc = status.get("autoscaler")
    if isinstance(asc, dict) and "target" in asc:
        last = asc.get("last") or {}
        line = (f"fleet: TGT={asc.get('target')} SIZE={asc.get('size')}"
                f"  bounds=[{asc.get('min')},{asc.get('max')}]"
                f"  shed={'ON' if asc.get('shedding') else 'off'}"
                f"  cooldown={asc.get('cooldown_ticks', 0)}t"
                f"  last={last.get('action', 'none')}"
                f"/{last.get('reason', '-') or '-'}")
        if asc.get("spawn_inflight"):
            line += "  <-- SPAWN IN FLIGHT"
        rows.append(line)
    # a non-zero epoch means the serving coordinator answering this
    # status is a PROMOTED standby (or a chain of failovers): flag it —
    # the degraded-mode runbook (README "Fleet") starts here
    if int(status.get("epoch") or 0) >= 1:
        rows.append(f"COORD FAILOVER: epoch {status['epoch']} — a warm "
                    "standby promoted after primary heartbeat loss "
                    "(manifest epoch-fenced; zombie primary writes are "
                    "dropped)")
    # mixed GSPMD rule tables among live ranks: the next step barrier
    # WILL refuse — flag it now, while the gang still renders healthy
    tables = agg.get("gspmd_rule_tables") or []
    if len(tables) > 1:
        rows.append("MIXED GSPMD RULE TABLES: "
                    + ", ".join(str(t) for t in tables)
                    + "  (step barrier will refuse)")
    mm = status.get("mismatch")
    if mm:
        rows.append(f"FINGERPRINT MISMATCH: {mm.get('detail', mm)}")
    return "\n".join(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coord", default=os.getenv("PADDLE_GANG_COORD", ""),
                   help="coordinator host:port "
                        "(default: $PADDLE_GANG_COORD)")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit (scriptable form)")
    p.add_argument("--json", action="store_true",
                   help="with --once: dump the raw status JSON instead "
                        "of the table")
    args = p.parse_args(argv)
    if not args.coord or ":" not in args.coord:
        p.error("no coordinator address: pass --coord HOST:PORT or "
                "export PADDLE_GANG_COORD")
    while True:
        try:
            status = fetch_status(args.coord)
        except (OSError, ConnectionError, ValueError) as e:
            print(f"gangtop: coordinator at {args.coord} unreachable: "
                  f"{e}", file=sys.stderr)
            return 1
        if args.once:
            print(json.dumps(status, indent=1) if args.json
                  else render(status))
            return 0
        # in-place refresh: clear screen + home, like top
        sys.stdout.write("\x1b[2J\x1b[H")
        print(f"gangtop — {args.coord} — "
              f"{time.strftime('%H:%M:%S')}  (Ctrl-C to quit)\n")
        print(render(status))
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
