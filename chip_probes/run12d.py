"""Phase 12d of chip_smoke.py alone on the card: device, build, ingest (its
prerequisite) and backends; the phase's report goes to
`chiprun_out/run12d.json`.

    python chip_probes/run12d.py
"""
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

os.environ["PIO_DEVPROF_STRICT"] = "1"
os.environ["PIO_WAL_DIR"] = str(ROOT / "build" / "wal")
report, shared = {"busy": {}}, {}
(cs.LOOP_DIR / "store").mkdir(parents=True, exist_ok=True)
t_all = time.perf_counter()
for name, phase in (("device", cs.phase_device), ("build", cs.phase_build),
                    ("ingest", cs.phase_ingest), ("backends", cs.phase_backends)):
    t0 = time.perf_counter()
    try:
        phase(report, shared)
    except Exception:
        traceback.print_exc()
        print(f"FAILED phase {name}", flush=True)
        sys.exit(1)
    print(f"[run12d] phase {name} {time.perf_counter() - t0:.1f} s", flush=True)
out = ROOT / "chiprun_out"
out.mkdir(exist_ok=True)
(out / "run12d.json").write_text(json.dumps(report.get("backends", {}), indent=1, default=str))
print(f"[run12d] total {time.perf_counter() - t_all:.1f} s", flush=True)
