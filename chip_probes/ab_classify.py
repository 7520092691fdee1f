"""The classify phase of chip_smoke.py in two trees, in turns (parent,
change, change, parent), each in a process of its own on one host. The
parent is unpacked into `build/parent_full` (`git archive`):

    python chip_probes/ab_classify.py            # both trees, in turns
    python chip_probes/ab_classify.py TREE       # one tree: device, classify
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if len(sys.argv) > 1:
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(tree))
    os.environ["PIO_DEVPROF_STRICT"] = "1"
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(tree / "build" / "pycache")
    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    report, shared = {"busy": {}}, {}
    out = {"tree": str(tree)}
    for name, phase in (("device", cs.phase_device), ("classify", cs.phase_classify)):
        t0 = time.perf_counter()
        phase(report, shared)
        out[name] = time.perf_counter() - t0
    c = report["classify"]
    out["entities"] = [cs.CLASSIFY_ENTITIES, cs.REGRESS_ENTITIES]
    out["store_s"] = {k: {"import_s": c[k]["import_s"], **c[k]["stages"]}
                      for k in ("store_classify", "store_regress")}
    out["smi"] = report["nvidia_smi"]
    print(json.dumps(out), flush=True)
    sys.exit(0)
for tree in ("build/parent_full", ".", ".", "build/parent_full"):
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(ROOT / tree)],
                         cwd=ROOT, capture_output=True, text=True)
    lines = res.stdout.strip().splitlines()
    print(lines[-1] if res.returncode == 0 and lines else res.stderr[-3000:], flush=True)
