"""Serving (the port of ``paddle_tpu.serving``).

- :mod:`bucketing` — pad arbitrary request shapes onto a few buckets, one
  program per bucket.
- :mod:`scheduler` — continuous batching: coalesce queued requests into the
  widest same-bucket batch, dispatch, materialize on a completion thread;
  and the decode loop over the paged KV cache.
- :mod:`kv_cache` — the paged KV cache, the single-token GPT decode step
  (one captured CUDA graph on the card) and the decode engine.
- :mod:`server` — the tenant plane (quotas, eviction), the SLO loop,
  graceful drain, and the two servers: ``InferenceServer``
  (request/response) and ``DecodeServer`` (token generation).
- :mod:`slo` — per-tenant SLO objectives and multi-window burn rates.
- :mod:`httpd` — the live scrape surface: ``/metrics`` ``/healthz``
  ``/statusz`` on ``FLAGS_metrics_port``.

Every request carries a trace id from admission through queueing, batch
coalescing, dispatch (with the executor's step id) and materialization: its
phase spans partition submit to resolve.
"""

from .bucketing import BucketPlan, bucket_for, pad_to_bucket, parse_buckets  # noqa
from .kv_cache import (DecodeEngine, GPTDecodeModel, PagedKVCache,  # noqa
                       params_from_scope)
from .scheduler import (ContinuousBatcher, DecodeScheduler,  # noqa
                        Request, ServingFuture)
from .httpd import MetricsHTTPServer  # noqa
from .server import (AdmissionError, DecodeServer,  # noqa
                     InferenceServer, TenantPlane)
from .slo import BurnRateEvaluator, SLOTarget, parse_slo  # noqa
