"""Whether an `import torch` compiles bytecode in each process: the
interpreter's bytecode settings, a child's `import torch` as is and with
`PYTHONPYCACHEPREFIX=build/pycache`, and the slowest imports.

    python chip_probes/pyc_probe.py
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
site = subprocess.run([sys.executable, "-c", "import torch, os; print(os.path.dirname(torch.__file__))"],
                      capture_output=True, text=True).stdout.strip()
print("torch at", site, "writable:", os.access(site, os.W_OK), flush=True)
pyc = Path(site) / "__pycache__"
print("torch/__pycache__ exists:", pyc.exists(), "files:", len(list(pyc.glob("*.pyc"))) if pyc.exists() else 0)
print("sys.flags.dont_write_bytecode", sys.flags.dont_write_bytecode, "PYTHONDONTWRITEBYTECODE",
      os.environ.get("PYTHONDONTWRITEBYTECODE"), "PYTHONPYCACHEPREFIX", os.environ.get("PYTHONPYCACHEPREFIX"))
print(sys.version, flush=True)


def run(env, label):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", "import torch"], env=env, capture_output=True, text=True)
    print(f"{label:40s} {time.perf_counter() - t0:6.2f} s rc={out.returncode}", flush=True)


base = dict(os.environ)
for _ in range(2):
    run(base, "import torch (as is)")
pref = dict(base, PYTHONPYCACHEPREFIX=str(ROOT / "build" / "pycache"))
for _ in range(3):
    run(pref, "import torch (PYTHONPYCACHEPREFIX)")
prof = subprocess.run([sys.executable, "-X", "importtime", "-c", "import torch"], env=base,
                      capture_output=True, text=True).stderr.splitlines()
rows = []
for line in prof:
    parts = line.split("|")
    if len(parts) == 3 and parts[0].startswith("import time:") and parts[1].strip().isdigit():
        rows.append((int(parts[0].split(":")[1]), int(parts[1]), parts[2]))
print("top self times (us):")
for self_us, cum, name in sorted(rows, reverse=True)[:15]:
    print(f"  {self_us:9d} {cum:9d} {name}")
