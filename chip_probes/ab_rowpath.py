"""The cut of chip_smoke.py phase 9b's row-path gate, parent against
change, in turns (parent, change, change, parent) on one host: the
gate's `EventFrame.from_events(find)` and columnar read of entity
partition 0 of 4 (the parent's) or of 16 (this tree's) on the store a
run of the script left under `build/segments/events`, each held equal.

    python3 chip_smoke.py; python chip_probes/ab_rowpath.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

# phase 9b's app: the first app id (the lifecycle records' namespace is far above)
app_id = min(int(p.name.split("_")[1]) for p in (cs.SEGMENTS_DIR / "events").glob("app_*"))
q = cs.EventQuery(app_id=app_id, entity_type="user", target_entity_type="item",
                  event_names=["rate"])
store = cs.segmentfs.SegmentFSEventStore({"PATH": str(cs.SEGMENTS_DIR / "events"),
                                          "SEAL_INTERVAL_S": "3600"})
runs = []
try:
    for n in (4, cs.SEGMENTS_ROW_SHARDS, cs.SEGMENTS_ROW_SHARDS, 4):
        qp = cs.dataclasses.replace(q, shard=(0, n))
        t0 = time.perf_counter()
        ref = cs.EventFrame.from_events(store.find(qp), value_prop="rating", default_value=1.0)
        part = store.find_frame(qp, value_prop="rating", default_value=1.0)
        assert len(ref) > 0 and cs._same_frame(part, ref), f"partition 0 of {n}"
        runs.append({"shards": n, "rows": len(ref), "s": time.perf_counter() - t0})
finally:
    store.close()
print(json.dumps({"app_id": app_id, "runs": runs}), flush=True)
