"""The parent's and the change's `console import` and train read
(`ab_probe.py`), in turns (parent, change, change, parent), each tree in
a process of its own on one host. The parent is unpacked into
`build/parent` (`git archive`):

    python chip_probes/ab_host.py N     # N ML-1M-shaped events
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
n = int(sys.argv[1])
rng = np.random.default_rng(1)
u, i, r = rng.integers(0, 6040, n), rng.integers(0, 3706, n), rng.integers(1, 6, n)
t = 956_703_932_000 + 1000 * np.arange(n)
stamps = np.datetime_as_string(t.astype("datetime64[ms]"), unit="ms")
path = ROOT / "build" / "ab_events.jsonl"
with open(path, "w") as f:
    for a, b, c, s in zip(u.tolist(), i.tolist(), r.tolist(), stamps):
        f.write(json.dumps({"event": "rate", "entityType": "user", "entityId": f"u{a}",
                            "targetEntityType": "item", "targetEntityId": f"i{b}",
                            "properties": {"rating": c}, "eventTime": f"{s}Z"}) + "\n")
try:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
except FileNotFoundError:
    print("no nvidia-smi", flush=True)
for k, tree in enumerate(("build/parent", ".", ".", "build/parent")):
    out = subprocess.run([sys.executable, str(Path(__file__).with_name("ab_probe.py")), tree, str(path),
                          str(ROOT / "build" / f"ab_work{k}")], cwd=ROOT, capture_output=True,
                         text=True)
    print(out.stdout.strip().splitlines()[-1] if out.returncode == 0 else out.stderr[-2000:],
          flush=True)
