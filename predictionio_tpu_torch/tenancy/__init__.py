"""Multi-tenant serving plane: one query server, many engines and
models, fair shares and per-tenant quotas.

Counterpart of the JAX package's ``tenancy/``:

- tenants.py: tenant records (engine variant, weight, quotas, deadline
  floor) on the shared lifecycle record store
- fair.py: the deficit-round-robin fair queue in front of the
  micro-batch dispatcher
- quota.py: qps, concurrency and device-seconds admission (429 +
  Retry-After, kept apart from the deadline 503s)
- cache.py: the LRU model cache (leases, pins, registry-driven prefetch,
  eviction by entry count or by measured device bytes)
- mux.py: the multiplexer a QueryServer attaches (admission, routing,
  per-tenant metrics under bounded labels, per-tenant rollouts)

Nothing here imports torch at module import.
"""

from predictionio_tpu_torch.tenancy.cache import CacheEntry, ModelCache, ModelLoadError
from predictionio_tpu_torch.tenancy.fair import FairQueue
from predictionio_tpu_torch.tenancy.mux import TenantMux, UnknownTenant
from predictionio_tpu_torch.tenancy.quota import (
    QuotaEnforcer,
    QuotaExceeded,
    TokenBucket,
)
from predictionio_tpu_torch.tenancy.tenants import Tenant, TenantStore

__all__ = [
    "CacheEntry",
    "FairQueue",
    "ModelCache",
    "ModelLoadError",
    "QuotaEnforcer",
    "QuotaExceeded",
    "Tenant",
    "TenantMux",
    "TenantStore",
    "TokenBucket",
    "UnknownTenant",
]
