"""The PyTorch port stands alone: it and chip_smoke.py import neither jax
nor anything of the JAX package, and its entry points refuse to carry on
silently on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = list(p.relative_to(ROOT).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "(('jax.', 'jaxlib')) or m == 'predictionio_tpu' or m.startswith"
        "('predictionio_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "predictionio_tpu"), (path, name)


# the fleet evaluation, the fleet coordinator and the self-cleaning data
# source: control-plane modules (the eval shard's worker imports its
# device modules inside main)
FLEET_MODULES = ["predictionio_tpu_torch.evalfleet", "predictionio_tpu_torch.evalfleet.specs",
                 "predictionio_tpu_torch.evalfleet.records",
                 "predictionio_tpu_torch.evalfleet.driver",
                 "predictionio_tpu_torch.evalfleet.tuning",
                 "predictionio_tpu_torch.evalfleet.worker", "predictionio_tpu_torch.fleet",
                 "predictionio_tpu_torch.fleet.coordinator",
                 "predictionio_tpu_torch.core.self_cleaning"]


def test_the_walk_covers_the_fleet_modules():
    """The source walk above and the import test cover every file of
    evalfleet/, fleet/ and core/self_cleaning.py."""
    walked = {str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")}
    for f in ("__init__", "specs", "records", "driver", "worker", "tuning"):
        assert f"predictionio_tpu_torch/evalfleet/{f}.py" in walked
    for f in ("predictionio_tpu_torch/fleet/__init__.py",
              "predictionio_tpu_torch/fleet/coordinator.py",
              "predictionio_tpu_torch/core/self_cleaning.py"):
        assert f in walked
    assert set(FLEET_MODULES) <= set(_port_modules())


@pytest.mark.parametrize("module", FLEET_MODULES)
def test_fleet_modules_load_neither_jax_nor_torch(module):
    """Importing a fleet-evaluation or coordinator module (as the
    console, the admin server and a driver host do) loads no jax,
    nothing of the JAX package and no torch."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'torch', 'predictionio_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# the storage outage path's data plane: the retry, the breaker, the
# write-ahead log, the wire codec, the remote client and the storage
# daemon, which the Event Server and the daemon's process import; the
# segmentfs and docfs stores, which they open; the replicated store and
# its election, which a follower or a primary daemon runs; the sharded
# store over storage daemons, which the Event Server opens
STORAGE_MODULES = ["predictionio_tpu_torch.resilience",
                   "predictionio_tpu_torch.resilience.retry",
                   "predictionio_tpu_torch.resilience.breaker",
                   "predictionio_tpu_torch.resilience.wal",
                   "predictionio_tpu_torch.data.storage.wire",
                   "predictionio_tpu_torch.data.storage.remote",
                   "predictionio_tpu_torch.data.api.storage_server",
                   "predictionio_tpu_torch.data.storage.segmentfs",
                   "predictionio_tpu_torch.data.storage.docfs",
                   "predictionio_tpu_torch.data.storage.replication",
                   "predictionio_tpu_torch.fleet.election",
                   "predictionio_tpu_torch.data.storage.sharded",
                   "predictionio_tpu_torch.data.storage.postgres",
                   "predictionio_tpu_torch.data.storage.parquetfs"]


def test_the_walk_covers_the_storage_modules():
    """The source walk and the import test cover every file of the
    storage outage path."""
    walked = {str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")}
    for f in ("resilience/retry.py", "resilience/breaker.py", "resilience/wal.py",
              "data/storage/wire.py", "data/storage/remote.py",
              "data/api/storage_server.py", "data/storage/segmentfs.py",
              "data/storage/docfs.py", "parallel/loader.py",
              "data/storage/replication.py", "fleet/election.py",
              "data/storage/sharded.py", "data/storage/postgres.py",
              "data/storage/parquetfs.py"):
        assert f"predictionio_tpu_torch/{f}" in walked
    assert set(STORAGE_MODULES) <= set(_port_modules())


@pytest.mark.parametrize("module", STORAGE_MODULES)
def test_storage_modules_load_neither_jax_nor_torch(module):
    """Importing a module of the storage outage path loads no jax,
    nothing of the JAX package and no torch: the daemon and the Event
    Server run without torch, as the JAX package's run without jax."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'torch', 'predictionio_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


OBS_MODULES = ["predictionio_tpu_torch.obs", "predictionio_tpu_torch.obs.tracing",
               "predictionio_tpu_torch.obs.spans", "predictionio_tpu_torch.obs.devprof",
               "predictionio_tpu_torch.obs.cudamon", "predictionio_tpu_torch.obs.costs",
               "predictionio_tpu_torch.obs.registry", "predictionio_tpu_torch.utils.http",
               "predictionio_tpu_torch.resilience.deadline",
               "predictionio_tpu_torch.resilience.faults",
               "predictionio_tpu_torch.obs.monitor", "predictionio_tpu_torch.obs.monitor.expr",
               "predictionio_tpu_torch.obs.monitor.durable",
               "predictionio_tpu_torch.obs.monitor.compact",
               "predictionio_tpu_torch.obs.monitor.push",
               "predictionio_tpu_torch.tools.admin", "predictionio_tpu_torch.tools.dashboard",
               "predictionio_tpu_torch.utils.logship"]


def test_the_walk_covers_the_telemetry_modules():
    """The source walk and the import test cover the durable tier, its
    compactor and push telemetry."""
    walked = {str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")}
    for f in ("durable", "compact", "push"):
        assert f"predictionio_tpu_torch/obs/monitor/{f}.py" in walked
        assert f"predictionio_tpu_torch.obs.monitor.{f}" in OBS_MODULES
    assert set(OBS_MODULES) <= set(_port_modules())


@pytest.mark.parametrize("module", OBS_MODULES)
def test_observability_modules_load_neither_jax_nor_torch(module):
    """The observability, resilience and monitoring modules and the
    operator servers, their registries' text and the device profiler's
    report load no jax, nothing of the JAX package and no torch: the
    Event Server mounts them without torch."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "from predictionio_tpu_torch import obs\n"
        "from predictionio_tpu_torch.obs import devprof\n"
        "text = obs.server_registry().render()\n"
        "rep = devprof.report()\n"
        "assert 'cuda_memory_allocated_bytes 0' in text, text\n"
        "assert rep['platform']['platform'] is None and rep['executables'] == []\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'torch', 'predictionio_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_resolve_device_defaults_to_the_card():
    from predictionio_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda:0")


def test_model_without_device_needs_the_card():
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.engines.recommendation.engine import ALSModel

    f = convert.als_factors_from_numpy(
        torch.zeros((2, 3)).numpy(), torch.zeros((4, 3)).numpy(),
        ["a", "b"], ["w", "x", "y", "z"], {},
    )
    if torch.cuda.is_available():
        assert ALSModel(f).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ALSModel(f)


def _classify_and_regress_trains():
    import numpy as np

    from predictionio_tpu_torch.models import classify, forest, linreg

    x = np.abs(np.random.default_rng(0).standard_normal((40, 3))).astype(np.float32)
    y = np.arange(40) % 2
    return {
        "naive_bayes": lambda **kw: classify.train_naive_bayes(x, y, 2, **kw),
        "naive_bayes_grid": lambda **kw: classify.train_naive_bayes_grid(x, y, 2, [1.0], **kw),
        "logistic_regression": lambda **kw: classify.train_logistic_regression(
            x, y, 2, iterations=2, **kw),
        "random_forest": lambda **kw: forest.train_random_forest(
            x, y, 2, n_trees=2, max_depth=2, **kw),
        "linear_regression": lambda **kw: linreg.train_linear_regression(x, y * 1.0, **kw),
        "nb_model": lambda **kw: classify.NaiveBayesModel(np.zeros(2), np.zeros((2, 3)), **kw),
    }


@pytest.mark.parametrize("name", ["naive_bayes", "naive_bayes_grid", "logistic_regression",
                                  "random_forest", "linear_regression", "nb_model"])
def test_classify_and_regress_entry_points_need_the_card(name):
    """The classification and regression trains, and a model built
    without a device, run on the card unless the caller names the CPU."""
    entry = _classify_and_regress_trains()[name]
    entry(device="cpu")
    if torch.cuda.is_available():
        entry()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_build_needs_no_nvcc_to_import():
    from predictionio_tpu_torch.ops import _build

    assert _build.sources() == ["dense_pass", "recommend_topk", "windowed_pass"]
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"


def test_event_server_starts_without_torch_or_the_models(tmp_path):
    """`console eventserver` makes no device call: the process that runs
    it loads neither torch nor the model, kernel, engine or workflow
    modules, so it starts in seconds and never touches CUDA."""
    code = (
        "import json, sys, types\n"
        "from predictionio_tpu_torch.tools import console\n"
        "class Stop:\n"
        "    def wait(self):\n"
        "        raise KeyboardInterrupt\n"
        "console.threading = types.SimpleNamespace(Event=Stop)\n"
        "rc = console.main(['eventserver', '--ip', '127.0.0.1', '--port', '0'])\n"
        "heavy = ('predictionio_tpu_torch.models', 'predictionio_tpu_torch.ops',\n"
        "         'predictionio_tpu_torch.engines', 'predictionio_tpu_torch.workflow')\n"
        "print(json.dumps([rc, sorted(m for m in sys.modules\n"
        "                  if m.split('.')[0] == 'torch' or m.startswith(heavy))]))\n"
    )
    env = {**os.environ, "PIO_FS_BASEDIR": str(tmp_path), "PIO_WAL_DIR": str(tmp_path / "wal")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "Event Server is listening" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, []]


def test_storage_server_starts_without_torch(tmp_path):
    """`console storageserver` serves the daemon over sqlite and model
    files without loading torch or the model, kernel, engine or workflow
    modules."""
    code = (
        "import json, sys, types\n"
        "from predictionio_tpu_torch.tools import console\n"
        "class Stop:\n"
        "    def wait(self):\n"
        "        raise KeyboardInterrupt\n"
        "console.threading = types.SimpleNamespace(Event=Stop)\n"
        "rc = console.main(['storageserver', '--ip', '127.0.0.1', '--port', '0'])\n"
        "heavy = ('predictionio_tpu_torch.models', 'predictionio_tpu_torch.ops',\n"
        "         'predictionio_tpu_torch.engines', 'predictionio_tpu_torch.workflow')\n"
        "print(json.dumps([rc, sorted(m for m in sys.modules\n"
        "                  if m.split('.')[0] == 'torch' or m.startswith(heavy))]))\n"
    )
    env = {**os.environ, "PIO_FS_BASEDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "Storage server is listening at http://127.0.0.1:" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, []]
