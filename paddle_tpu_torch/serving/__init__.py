"""Serving (the port of ``paddle_tpu.serving``).

- :mod:`bucketing` — pad arbitrary request shapes onto a few buckets, one
  program per bucket.
- :mod:`scheduler` — continuous batching: coalesce queued requests into the
  widest same-bucket batch, dispatch, materialize on a completion thread;
  and the decode loop over the paged KV cache.
- :mod:`kv_cache` — the paged KV cache, the single-token GPT decode step
  (one captured CUDA graph on the card) and the decode engine.
- :mod:`server` — the tenant plane (quotas), graceful drain, and the two
  servers: ``InferenceServer`` (request/response) and ``DecodeServer``
  (token generation).
"""

from .bucketing import BucketPlan, bucket_for, pad_to_bucket, parse_buckets  # noqa
from .kv_cache import (DecodeEngine, GPTDecodeModel, PagedKVCache,  # noqa
                       params_from_scope)
from .scheduler import (ContinuousBatcher, DecodeScheduler,  # noqa
                        Request, ServingFuture)
from .server import (AdmissionError, DecodeServer,  # noqa
                     InferenceServer, TenantPlane)
