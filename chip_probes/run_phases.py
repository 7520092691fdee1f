"""Some phases of chip_smoke.py on the card, in the script's order, with
the environment `main` sets; each phase's seconds and the report of the
phases named go to `chiprun_out/run_phases.json`. The phases a phase
reads from (through `shared`) must be named before it:

    python chip_probes/run_phases.py device build data train loop segments \\
        replication tenancy monitor
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
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
os.environ["PYTHONPYCACHEPREFIX"] = str(ROOT / "build" / "pycache")

names = sys.argv[1:]
report, shared, seconds = {"busy": {}}, {}, {}
t_all = time.perf_counter()
code = 0
for name in names:
    phase = getattr(cs, f"phase_{name.replace(' ', '_')}")
    t0 = time.perf_counter()
    try:
        phase(report, shared)
    except Exception:
        traceback.print_exc()
        print(f"FAILED phase {name}", flush=True)
        code = 1
        break
    seconds[name] = time.perf_counter() - t0
    print(f"[run_phases] phase {name} {seconds[name]:.1f} s", flush=True)
out = ROOT / "chiprun_out"
out.mkdir(exist_ok=True)
(out / "run_phases.json").write_text(json.dumps(
    {"seconds": seconds, **{k: report.get(k.replace(" ", "_")) for k in names}},
    indent=1, default=str))
print(f"[run_phases] total {time.perf_counter() - t_all:.1f} s", flush=True)
sys.exit(code)
