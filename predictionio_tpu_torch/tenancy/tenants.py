"""Tenant records: who shares the serving fleet, and on what terms.

Counterpart of the JAX package's ``tenancy/tenants.py``. A ``Tenant``
names the engine variant it serves, its fair-share ``weight`` in the
micro-batch scheduler, its admission quotas (qps, concurrency,
device-seconds) and a deadline floor. Records live on the lifecycle
record layer (``LifecycleRecordStore``, entity type ``pio_tenant``), so
every process over the shared stores sees the same tenant set; the
namespace, entity type, field names and fold are the JAX package's, so a
tenant that either package writes is read the same by the other.
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass
from typing import Any, Optional

from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore

TENANT_ENTITY = "pio_tenant"

# tenant ids land in URLs (/tenants/{id}/queries.json) and metric labels
_TENANT_ID_RE = re.compile(r"[A-Za-z0-9._-]{1,64}")


def _utcnow_iso() -> str:
    return _dt.datetime.now(_dt.timezone.utc).isoformat()


@dataclass
class Tenant:
    """One tenant's serving contract. A quota of ``None`` (or 0) is
    unlimited; `weight` is the deficit-round-robin share in the fair
    scheduler (2.0 drains twice as fast as 1.0 under contention);
    `deadline_floor_ms` caps how long one of its requests may live in
    the serving pipeline: a request with no deadline, or a longer one,
    is clamped to it at admission."""

    id: str
    engine_id: str
    engine_version: str = "0"
    engine_variant: str = ""
    weight: float = 1.0
    qps: Optional[float] = None
    max_concurrency: Optional[int] = None
    device_seconds_per_s: Optional[float] = None
    deadline_floor_ms: Optional[float] = None
    enabled: bool = True
    description: str = ""
    created_at: str = ""
    updated_at: str = ""

    def __post_init__(self):
        if not _TENANT_ID_RE.fullmatch(self.id or ""):
            raise ValueError(
                f"tenant id {self.id!r} must match [A-Za-z0-9._-]{{1,64}} "
                "(it becomes a URL segment and a metric label)")
        if not self.engine_id:
            raise ValueError("tenant needs an engine_id")
        if not self.engine_variant:
            self.engine_variant = self.engine_id
        self.weight = float(self.weight)
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        for name in ("qps", "device_seconds_per_s", "deadline_floor_ms"):
            v = getattr(self, name)
            if v is not None:
                v = float(v)
                if v < 0:
                    raise ValueError(f"{name} must be >= 0, got {v}")
                setattr(self, name, v or None)  # 0 means unlimited
        if self.max_concurrency is not None:
            mc = int(self.max_concurrency)
            if mc < 0:
                raise ValueError(f"max_concurrency must be >= 0, got {mc}")
            self.max_concurrency = mc or None

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "engine_id": self.engine_id,
            "engine_version": self.engine_version,
            "engine_variant": self.engine_variant,
            "weight": self.weight,
            "qps": self.qps,
            "max_concurrency": self.max_concurrency,
            "device_seconds_per_s": self.device_seconds_per_s,
            "deadline_floor_ms": self.deadline_floor_ms,
            "enabled": self.enabled,
            "description": self.description,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }

    @staticmethod
    def from_dict(d: dict) -> "Tenant":
        return Tenant(
            id=d.get("id", ""),
            engine_id=d.get("engine_id", ""),
            engine_version=d.get("engine_version") or "0",
            engine_variant=d.get("engine_variant") or "",
            weight=d.get("weight", 1.0),
            qps=d.get("qps"),
            max_concurrency=d.get("max_concurrency"),
            device_seconds_per_s=d.get("device_seconds_per_s"),
            deadline_floor_ms=d.get("deadline_floor_ms"),
            enabled=bool(d.get("enabled", True)),
            description=d.get("description") or "",
            created_at=d.get("created_at") or "",
            updated_at=d.get("updated_at") or "",
        )


QUOTA_FIELDS = ("weight", "qps", "max_concurrency", "device_seconds_per_s",
                "deadline_floor_ms")


class TenantStore:
    """CRUD over tenant records: the admin server, the console and every
    query server's multiplexer share it."""

    def __init__(self, storage):
        self.storage = storage
        self._store = LifecycleRecordStore(storage)

    def upsert(self, tenant: Tenant) -> Tenant:
        existing = self.get(tenant.id)
        now = _utcnow_iso()
        tenant.created_at = existing.created_at if existing else now
        tenant.updated_at = now
        self._store.append(TENANT_ENTITY, tenant.id, tenant.to_dict())
        return tenant

    def set_quota(self, tenant_id: str, **fields: Any) -> Tenant:
        """Update only the fair-share and quota fields of one tenant."""
        tenant = self.get(tenant_id)
        if tenant is None:
            raise KeyError(f"no tenant {tenant_id!r}")
        unknown = set(fields) - set(QUOTA_FIELDS)
        if unknown:
            raise ValueError(f"unknown quota fields {sorted(unknown)} "
                             f"(known: {', '.join(QUOTA_FIELDS)})")
        for k, v in fields.items():
            setattr(tenant, k, v)
        tenant.__post_init__()  # validate the merged record
        tenant.updated_at = _utcnow_iso()
        self._store.append(TENANT_ENTITY, tenant_id, {
            **{k: getattr(tenant, k) for k in QUOTA_FIELDS},
            "updated_at": tenant.updated_at,
        })
        return tenant

    def get(self, tenant_id: str) -> Optional[Tenant]:
        d = self._store.fold(TENANT_ENTITY, tenant_id).get(tenant_id)
        if not d:
            return None
        try:
            return Tenant.from_dict(d)
        except ValueError:
            return None

    def list(self) -> list[Tenant]:
        out = []
        for d in self._store.fold(TENANT_ENTITY).values():
            try:
                out.append(Tenant.from_dict(d))
            except ValueError:
                continue  # a corrupt record must not hide the rest
        out.sort(key=lambda t: t.id)
        return out

    def delete(self, tenant_id: str) -> int:
        return self._store.purge(TENANT_ENTITY, tenant_id)

    def compact(self, min_events: int = 8) -> int:
        """Fold-compact the tenant records (quota edits accumulate)."""
        return self._store.compact_all(TENANT_ENTITY, min_events=min_events)
