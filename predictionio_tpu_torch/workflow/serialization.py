"""Model (de)serialization for the model store.

The reference Kryo-serializes the trained model list into MODELDATA
(reference: core/src/main/scala/io/prediction/workflow/CoreWorkflow.scala:
69-74 and CreateServer.scala:61-75 KryoInstantiator). Here models are
pickled Python objects; every ``torch.Tensor`` in them, on any device, is
pulled to a host numpy array while pickling, so a blob is
device-independent and never holds a CUDA tensor. Algorithms whose
``persist_model`` is False are stored as a ``PersistentModelManifest``
(className marker) or a retrain marker — the reference's three
persistence paths (Engine.makeSerializableModels, Engine.scala:260-278;
PersistentModelManifest.scala).

The port of ``predictionio_tpu/workflow/serialization.py``. Its unpickler
refuses classes of the JAX package (``predictionio_tpu.*``): the port
never imports that package, so a blob the reference trained fails to
load here like a corrupt one, and a deploy's fallback walk skips it."""

from __future__ import annotations

import dataclasses
import io
import pickle
import re
from typing import Any, Sequence

import torch

__all__ = [
    "PersistentModelManifest", "RetrainMarker", "serialize_models",
    "deserialize_models",
]


@dataclasses.dataclass(frozen=True)
class PersistentModelManifest:
    """Marker stored in place of a custom-persisted model
    (reference: workflow/PersistentModelManifest.scala)."""

    class_name: str
    module: str


@dataclasses.dataclass(frozen=True)
class RetrainMarker:
    """Marker for non-persistable models: retrain at deploy
    (reference: Engine.prepareDeploy, Engine.scala:186-208)."""

    algorithm_class: str


class _HostPickler(pickle.Pickler):
    """Pickles every ``torch.Tensor``, wherever it sits in the object
    graph and on whatever device, as the host numpy array of its values
    (bfloat16 widened to float32, which numpy has)."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().to("cpu")
            if t.dtype == torch.bfloat16:  # numpy has no bfloat16
                t = t.float()
            return t.numpy().copy().__reduce__()
        return NotImplemented


#: dir-scoped engine modules (workflow/core_workflow.py:
#: _import_engine_scoped) carry a `_pio_engine_<dirhash>_` name prefix;
#: blobs must never depend on it — the hash changes whenever the engine
#: dir's absolute path does (another host, a moved project)
_SCOPED_RE = re.compile(r"^_pio_engine_[0-9a-f]{10}_")


def plain_module_name(name: str) -> str:
    """Strip the dir-scoped prefix: stable across hosts/paths."""
    return _SCOPED_RE.sub("", name)


class _EngineScopedUnpickler(pickle.Unpickler):
    """Unpickler that re-resolves engine-module classes against a given
    engine dir. A blob may reference a module as the plain name (a pre-
    scoping blob, or another host's process) or as a scoped name whose dir
    hash no longer matches — both re-import from ``engine_dir``."""

    def __init__(self, file, engine_dir=None):
        super().__init__(file)
        self._engine_dir = engine_dir

    def find_class(self, module, name):
        if module == "predictionio_tpu" or module.startswith(
                "predictionio_tpu."):
            raise pickle.UnpicklingError(
                f"blob references {module}.{name} of the JAX package, "
                "which the PyTorch port does not import")
        # engine-dir FIRST: a plain sibling-module name (e.g.
        # 'data_source') would otherwise resolve by sys.path order and
        # could bind another engine's same-named file when several
        # engine dirs are loaded in one process
        if self._engine_dir is not None:
            try:
                from .core_workflow import _import_engine_scoped

                mod = _import_engine_scoped(
                    self._engine_dir, plain_module_name(module))
                if mod is not None:
                    obj = mod
                    for part in name.split("."):
                        obj = getattr(obj, part)
                    return obj
            except Exception:
                pass  # fall through to the normal resolution
        return super().find_class(module, name)


def serialize_models(models: Sequence[Any]) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(list(models))
    return buf.getvalue()


def deserialize_models(blob: bytes, *, engine_dir=None) -> list[Any]:
    return _EngineScopedUnpickler(io.BytesIO(blob), engine_dir).load()
