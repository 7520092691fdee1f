"""Where a `console deploy` child's start goes: the time to start Python,
import numpy, torch, CUDA, the console and the server, a profile of an
in-process deploy, and a deploy child's time to its banner.

    python chip_probes/child_probe.py
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.chdir(ROOT)
sys.path.insert(0, str(ROOT))


def timed(code, label):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    print(f"{label:50s} {time.perf_counter() - t0:7.2f} s rc={out.returncode} "
          f"{out.stderr.strip()[-300:] if out.returncode else ''}", flush=True)


from predictionio_tpu_torch.ops import _build  # noqa: E402

t0 = time.perf_counter()
_build.build()
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
import numpy as np  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402

rng = np.random.default_rng(1)
f = convert.als_factors_from_numpy(rng.standard_normal((943, 10)).astype(np.float32),
                                   rng.standard_normal((1682, 10)).astype(np.float32),
                                   [f"u{i}" for i in range(943)], [f"i{i}" for i in range(1682)], {})
(ROOT / "build" / "probe_f.npz").write_bytes(f.to_bytes())
for _ in range(2):
    timed("pass", "python")
    timed("import numpy", "import numpy")
    timed("import torch", "import torch")
    timed("import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()", "torch + CUDA init")
    timed("import predictionio_tpu_torch.tools.console", "import the console")
    timed("from predictionio_tpu_torch.workflow.server import QueryServer; "
          "from predictionio_tpu_torch.engines.recommendation.engine import ALSModel",
          "import server + engine")
code = r'''
import cProfile, pstats, io, time, sys
t0 = time.perf_counter()
pr = cProfile.Profile(); pr.enable()
from predictionio_tpu_torch.tools import console
args = console._parser().parse_args(["deploy", "--model", "build/probe_f.npz", "--ip", "127.0.0.1", "--port", "0"])
srv = console.build_server(args)
port = srv.start()
pr.disable()
print("deploy to ready in process", time.perf_counter() - t0, file=sys.stderr)
srv.stop()
s = io.StringIO(); pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(35)
print(s.getvalue()[:9000], file=sys.stderr)
'''
out = subprocess.run([sys.executable, "-X", "importtime", "-c", code], capture_output=True,
                     text=True, cwd=ROOT)
lines = out.stderr.splitlines()
imports = sorted((l for l in lines if l.startswith("import time:") and "|" in l),
                 key=lambda l: -int(l.split("|")[1]))[:25]
print("\n".join(imports))
print("\n".join(l for l in lines if not l.startswith("import time:"))[-9000:])
t0 = time.perf_counter()
p = subprocess.Popen([sys.executable, "-m", "predictionio_tpu_torch.tools.console", "deploy",
                      "--model", "build/probe_f.npz", "--ip", "127.0.0.1", "--port", "0"],
                     stdout=subprocess.PIPE, text=True, cwd=ROOT)
for line in p.stdout:
    if "serving" in line:
        print(f"deploy child to banner {time.perf_counter() - t0:.2f} s", flush=True)
        break
p.terminate()
p.wait()
