"""Model persistence: the MODELDATA blob and user-managed models.

Counterpart of the JAX package's ``controller/persistent.py``
(reference BaseAlgorithm.scala:96-112, PersistentModel.scala:51,94,
Engine.scala:208-226): a trained model is pickled into the MODELDATA
blob; a `PersistentModel` saves itself and leaves a manifest; a model of
None is stored as `RetrainOnDeploy`, and deploy trains it again.

Two departures from the JAX package, both so that deploy never does
something other than what was asked:

- a model that fails to pickle raises, naming its class; the JAX package
  turns it into `RetrainOnDeploy` without a word, and deploy then
  retrains in place of loading;
- `deserialize_models` refuses any class of the JAX package (and of
  jax), naming it, before importing anything: a blob the JAX package
  wrote cannot be served by the port. The local-filesystem
  ``LocalFileSystemPersistentModel`` base is not ported.
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass
from typing import Any, Optional

from predictionio_tpu_torch.controller.params import is_reference_module, load_symbol
from predictionio_tpu_torch.core.base import PersistentModelManifest


@dataclass(frozen=True)
class RetrainOnDeploy:
    """Stored for a model of None: deploy re-runs read → prepare → train
    (reference Engine.scala:208-226)."""

    algo_index: int


class PersistentModel:
    """User-managed persistence (reference PersistentModel.scala:51,94).

    Subclasses set PERSISTENT = True, implement `save` returning True when
    stored, and a `load(model_id, params)` classmethod."""

    PERSISTENT = True

    def save(self, model_id: str, params: Any) -> bool:
        raise NotImplementedError

    @classmethod
    def load(cls, model_id: str, params: Any) -> "PersistentModel":
        raise NotImplementedError


class ModelSerializationError(TypeError):
    pass


def serialize_models(models: list[Any]) -> bytes:
    """Pickle the per-algorithm model list for MODELDATA. None becomes
    `RetrainOnDeploy`; a model that does not pickle raises."""
    out: list[Any] = []
    for i, m in enumerate(models):
        if m is None:
            out.append(RetrainOnDeploy(algo_index=i))
            continue
        try:
            pickle.dumps(m)
        except Exception as e:
            cls = type(m)
            raise ModelSerializationError(
                f"the model of algorithm #{i} ({cls.__module__}."
                f"{cls.__qualname__}) does not pickle: {e}. Give it "
                f"__getstate__/__setstate__ or make it a PersistentModel; "
                f"the port does not store it as retrain-on-deploy"
            ) from e
        out.append(m)
    return pickle.dumps(out)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if is_reference_module(module) or module.split(".")[0] in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"the model blob holds {module}.{name}, a class of the JAX "
                f"package: the PyTorch port cannot serve it; train the "
                f"engine again with the port"
            )
        return super().find_class(module, name)


def deserialize_models(blob: bytes) -> list[Any]:
    return _PortUnpickler(io.BytesIO(blob)).load()


def load_persistent_model(
    manifest: PersistentModelManifest, model_id: str, params: Any
) -> Any:
    """Re-load a user-persisted model by its class's `load`."""
    cls = load_symbol(manifest.class_name)
    loader: Optional[Any] = getattr(cls, "load", None)
    if loader is None:
        raise TypeError(f"{manifest.class_name} has no load() classmethod")
    return loader(model_id, params)
