"""Builds the port's CUDA sources (``ops/csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface under ``build/kernels/`` at the repository root, named by the
source's stem and a hash of every source and flag, so an edit rebuilds
and an unchanged tree reuses the library. Callers load it with
``ctypes`` and declare each function's ``argtypes`` themselves.

Importing this module needs no ``nvcc``; only ``build``/``load`` do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: nvcc's stderr per built source (ptxas register/shared-memory report)
BUILD_LOGS: dict[str, str] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: put the CUDA toolkit's bin directory on PATH or "
        "set CUDA_HOME"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all), one ``nvcc`` per source,
    all started together; reuse a library already built from the same
    sources. Returns name → library path. Raises RuntimeError carrying
    nvcc's stderr when a build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    out = {n: BUILD_DIR / f"{n}-{digest}.so" for n in names}
    procs = {}
    for n in names:
        if out[n].exists():
            continue
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        stdout, stderr = proc.communicate()
        BUILD_LOGS[n] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if
    needed; loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
