"""Phase 10b (d) of chip_smoke.py, the UR self-cleaning step, in two
trees, in turns (parent, change, change, parent), each in a process of
its own on one host. The parent is unpacked into `build/parent_full`
(`git archive`):

    python chip_probes/ab_clean.py            # both trees, in turns
    python chip_probes/ab_clean.py TREE       # one tree: device, build, (d)
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if len(sys.argv) > 1:
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    report, shared = {"busy": {}}, {}
    out = {"tree": str(tree)}
    for name, phase in (("device", cs.phase_device), ("build", cs.phase_build)):
        t0 = time.perf_counter()
        phase(report, shared)
        out[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = cs._ur_self_cleaning()
    out["clean_s"] = time.perf_counter() - t0
    out["users"] = cs.UR_CLEAN_USERS
    out["events"] = d["events"]
    out["smi"] = report["nvidia_smi"]
    print(json.dumps(out, default=str), flush=True)
    sys.exit(0)
for tree in ("build/parent_full", ".", ".", "build/parent_full"):
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(ROOT / tree)],
                         cwd=ROOT, capture_output=True, text=True)
    lines = res.stdout.strip().splitlines()
    print(lines[-1] if res.returncode == 0 and lines else res.stderr[-3000:], flush=True)
