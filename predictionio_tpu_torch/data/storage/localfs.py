"""Model blobs as files under PIO_FS_BASEDIR.

Counterpart of the JAX package's ``data/storage/localfs.py`` (reference
localfs/LocalFSModels.scala:29), with the same file names, so a blob
directory written by either package reads in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model
from predictionio_tpu_torch.utils.env import env_path


def default_basedir() -> str:
    return env_path("PIO_FS_BASEDIR", "~/.pio_store")


class LocalFSModels(base.Models):
    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self._dir = Path(config.get("PATH") or default_basedir()) / "models"
        self._dir.mkdir(parents=True, exist_ok=True)

    def _path(self, mid: str) -> Path:
        # ids are generated hex tokens; keep a path in the directory anyway
        safe = "".join(c for c in mid if c.isalnum() or c in "-_.")
        return self._dir / f"pio_model_{safe}"

    def insert(self, m: Model) -> None:
        tmp = self._path(m.id).with_suffix(".tmp")
        tmp.write_bytes(m.models)
        tmp.replace(self._path(m.id))

    def get(self, mid: str) -> Optional[Model]:
        p = self._path(mid)
        return Model(mid, p.read_bytes()) if p.exists() else None

    def delete(self, mid: str) -> None:
        self._path(mid).unlink(missing_ok=True)
