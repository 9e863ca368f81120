"""Distributed (the port of ``paddle_tpu.distributed``).

So far only the gang coordinator's frame protocol (:mod:`coordinator`:
``send_frame`` / ``recv_frame``), which the serving fleet's router and
replica endpoints speak.  The coordinator itself, the collective ops, the
launchers, the PS and the transpilers are ROADMAP Queue 1 item 3.
"""

from .coordinator import MAX_FRAME_BYTES, recv_frame, send_frame  # noqa
