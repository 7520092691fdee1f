"""Test harness: force an 8-device virtual CPU mesh so multi-chip sharding
paths are exercised without TPU hardware (reference analogue: Spark
`local[4]` SharedSparkContext, core/src/test/.../BaseTest.scala:15-55)."""

from predictionio_tpu.utils.cpuonly import force_cpu_platform

# override=False: an explicitly pre-set device count (e.g. a 16-device
# repro via XLA_FLAGS) is honored; otherwise the standard 8-device mesh
force_cpu_platform(n_devices=8, override=False)

import pytest  # noqa: E402

# thread-sanitizer integration (ISSUE 12): with PIO_TSAN=1 the lock
# constructors are patched before any test runs, and session teardown
# runs the thread-leak tripwire + writes the JSON findings report.
# Delegated so plain `python -m pytest tests/` needs no -p flag.
from predictionio_tpu.analysis import pytest_plugin as _tsan_plugin  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the PyTorch port's hand-written "
        "kernels); skips where none is present",
    )
    _tsan_plugin.pytest_configure(config)


def pytest_sessionfinish(session, exitstatus):
    _tsan_plugin.pytest_sessionfinish(session, exitstatus)


@pytest.fixture(scope="session")
def mesh8():
    """An 8-device 'dp×mp' mesh on the virtual CPU devices."""
    import jax
    from jax.sharding import Mesh
    import numpy as np

    devices = np.array(jax.devices()[:8]).reshape(4, 2)
    with Mesh(devices, ("dp", "mp")) as m:
        yield m


@pytest.fixture()
def fresh_storage(tmp_path):
    """A Storage wired to throwaway sqlite+localfs under tmp_path."""
    from predictionio_tpu.data.storage.registry import (
        SourceConfig,
        Storage,
        StorageConfig,
    )

    cfg = StorageConfig(
        sources={
            "TESTSQL": SourceConfig(
                "TESTSQL", "sqlite", {"PATH": str(tmp_path / "pio.db")}
            ),
            "TESTFS": SourceConfig("TESTFS", "localfs", {"PATH": str(tmp_path)}),
        },
        repositories={
            "METADATA": "TESTSQL",
            "EVENTDATA": "TESTSQL",
            "MODELDATA": "TESTFS",
        },
    )
    return Storage(cfg)
