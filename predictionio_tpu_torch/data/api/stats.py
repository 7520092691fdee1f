"""Per-app ingestion counts in hourly buckets, for ``GET /stats.json``.

Counterpart of the JAX package's ``data/api/stats.py`` (reference
data/.../api/Stats.scala:48, StatsActor.scala:33): a count per (status,
event, entity type) and hour. Buckets older than `RETENTION_HOURS` are
pruned when a new hour's bucket is first made, so a long-lived server
keeps a bounded number of them.
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.data.event import Event


@dataclass(frozen=True)
class KV:
    status: int
    event: str
    entity_type: str


RETENTION_HOURS = 24


class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        # (app_id, hour "YYYY-MM-DDTHH") → {KV: count}
        self._buckets: dict[tuple[int, str], defaultdict[KV, int]] = {}
        self.start_time = _dt.datetime.now(_dt.timezone.utc)

    @staticmethod
    def _hour(t: _dt.datetime) -> str:
        return t.astimezone(_dt.timezone.utc).strftime("%Y-%m-%dT%H")

    def update(self, app_id: int, status: int, event: Event,
               now: Optional[_dt.datetime] = None) -> None:
        kv = KV(status=status, event=event.event, entity_type=event.entity_type)
        ts = now or _dt.datetime.now(_dt.timezone.utc)
        key = (app_id, self._hour(ts))
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = defaultdict(int)
                # the hour keys sort in time order as strings
                cutoff = self._hour(ts - _dt.timedelta(hours=RETENTION_HOURS))
                for k in [k for k in self._buckets if k[1] < cutoff]:
                    del self._buckets[k]
            bucket[kv] += 1

    def get(self, app_id: int) -> dict:
        """The app's hourly buckets as ``/stats.json`` answers them
        (reference EventServer.scala:441-467)."""
        with self._lock:
            hours = [
                {"hour": hour, "counts": [
                    {"status": kv.status, "event": kv.event,
                     "entityType": kv.entity_type, "count": n}
                    for kv, n in sorted(bucket.items(),
                                        key=lambda it: (it[0].status, it[0].event))
                ]}
                for (aid, hour), bucket in sorted(self._buckets.items())
                if aid == app_id
            ]
        return {"appId": app_id, "startTime": self.start_time.isoformat(),
                "hours": hours}
