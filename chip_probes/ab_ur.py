"""The UR train phase of chip_smoke.py in two trees, in turns (parent,
change, change, parent), each in a process of its own on one host. The
parent is unpacked into `build/parent_full` (`git archive`):

    python chip_probes/ab_ur.py            # both trees, in turns
    python chip_probes/ab_ur.py TREE       # one tree: device, ur data, ur train
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
    for name, phase in (("device", cs.phase_device), ("ur data", cs.phase_ur_data),
                        ("ur train", cs.phase_ur_train)):
        t0 = time.perf_counter()
        phase(report, shared)
        out[name] = time.perf_counter() - t0
    out["cpu_check_s"] = report["ur_train"]["cpu_check_s"]
    out["blocks"] = [cs.UR_CPU_BLOCKS, cs.UR_CPU_BLOCK_ROWS]
    out["smi"] = report["nvidia_smi"]
    print(json.dumps(out), flush=True)
    sys.exit(0)
for tree in ("build/parent_full", ".", ".", "build/parent_full"):
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(ROOT / tree)],
                         cwd=ROOT, capture_output=True, text=True)
    lines = res.stdout.strip().splitlines()
    print(lines[-1] if res.returncode == 0 and lines else res.stderr[-3000:], flush=True)
