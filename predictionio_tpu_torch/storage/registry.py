"""Environment-driven storage registry.

The analog of the reference ``Storage`` object (reference: data/src/main/
scala/io/prediction/data/storage/Storage.scala:40-312): sources are declared
via ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ per-type config vars) and the
three repositories (METADATA, EVENTDATA, MODELDATA) are bound to sources
via ``PIO_STORAGE_REPOSITORIES_<REPO>_{NAME,SOURCE}``.

Built-in source types:

- ``memory``  — in-process (tests, quickstart)
- ``sqlite``  — durable single file; config var ``PIO_STORAGE_SOURCES_<N>_PATH``
- ``localfs`` — model blobs on the filesystem; config var ``..._PATH``

Defaults (no env vars set): everything under ``$PIO_HOME`` (or
``~/.predictionio_tpu_torch``) in sqlite/localfs — durable out of the box.
Set ``PIO_STORAGE_SOURCES_*`` to swap backends without touching code,
exactly like the reference's pio-env.sh (conf/pio-env.sh.template).

Copied from ``predictionio_tpu/storage/registry.py``; the port imports
nothing of the JAX package. The default home is the port's own, so the two
packages share metadata and model blobs only where ``PIO_HOME`` says so.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any

from .events_base import EventBackend, StorageError
from .memory import MemoryEvents
from .metadata import MetadataStore, Model
from .sqlite import SQLiteEvents

__all__ = ["Storage", "StorageError"]

_REPOS = ("METADATA", "EVENTDATA", "MODELDATA")


class LocalFSModels:
    """Model blobs as files in a directory (reference: data/.../storage/
    localfs/LocalFSModels.scala)."""

    def __init__(self, path: str):
        self._dir = Path(path)
        self._dir.mkdir(parents=True, exist_ok=True)

    def insert(self, m: Model) -> None:
        (self._dir / m.id).write_bytes(m.models)
        # integrity sidecar — the file-backed analog of the sqlite
        # checksum column; absent for pre-integrity blobs
        sidecar = self._dir / f"{m.id}.sha256"
        if m.checksum:
            sidecar.write_text(m.checksum)
        elif sidecar.exists():
            sidecar.unlink()

    def get(self, id: str) -> Model | None:
        p = self._dir / id
        if not p.exists():
            return None
        sidecar = self._dir / f"{id}.sha256"
        checksum = sidecar.read_text().strip() if sidecar.exists() else ""
        return Model(id=id, models=p.read_bytes(), checksum=checksum)

    def delete(self, id: str) -> bool:
        p = self._dir / id
        sidecar = self._dir / f"{id}.sha256"
        if sidecar.exists():
            sidecar.unlink()
        if p.exists():
            p.unlink()
            return True
        return False


class _SQLiteModels:
    def __init__(self, meta: MetadataStore):
        self._meta = meta

    def insert(self, m: Model) -> None:
        self._meta.model_insert(m)

    def get(self, id: str) -> Model | None:
        return self._meta.model_get(id)

    def delete(self, id: str) -> bool:
        return self._meta.model_delete(id)


class Storage:
    """Process-wide registry. ``Storage.get_*()`` lazily builds clients from
    the environment; ``Storage.configure()`` overrides programmatically
    (used by tests and by in-process servers)."""

    _lock = threading.RLock()
    _instances: dict[str, Any] = {}
    _overrides: dict[str, dict[str, Any]] = {}

    # -- configuration ----------------------------------------------------
    @classmethod
    def home(cls) -> Path:
        return Path(os.environ.get(
            "PIO_HOME", str(Path.home() / ".predictionio_tpu_torch")))

    @classmethod
    def configure(cls, repo: str, type: str, **config: Any) -> None:
        """Programmatic override: Storage.configure("EVENTDATA", "memory")."""
        with cls._lock:
            cls._overrides[repo.upper()] = {"type": type, **config}
            cls._instances.pop(repo.upper(), None)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            for inst in cls._instances.values():
                close = getattr(inst, "close", None)
                if close:
                    try:
                        close()
                    except Exception:
                        pass
            cls._instances.clear()
            cls._overrides.clear()

    @classmethod
    def _repo_config(cls, repo: str) -> dict[str, Any]:
        if repo in cls._overrides:
            return dict(cls._overrides[repo])
        source = os.environ.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
        if source:
            typ = os.environ.get(f"PIO_STORAGE_SOURCES_{source}_TYPE")
            if not typ:
                raise StorageError(
                    f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE={source} but "
                    f"PIO_STORAGE_SOURCES_{source}_TYPE is not set"
                )
            cfg: dict[str, Any] = {"type": typ.lower()}
            prefix = f"PIO_STORAGE_SOURCES_{source}_"
            for k, v in os.environ.items():
                if k.startswith(prefix) and k != prefix + "TYPE":
                    cfg[k[len(prefix):].lower()] = v
            return cfg
        # defaults: durable sqlite/localfs under PIO_HOME
        home = cls.home()
        if repo == "METADATA":
            return {"type": "sqlite", "path": str(home / "metadata.db")}
        if repo == "EVENTDATA":
            return {"type": "sqlite", "path": str(home / "events.db")}
        return {"type": "localfs", "path": str(home / "models")}

    # -- accessors --------------------------------------------------------
    @classmethod
    def _get(cls, repo: str) -> Any:
        with cls._lock:
            if repo in cls._instances:
                return cls._instances[repo]
            cfg = cls._repo_config(repo)
            typ = cfg.pop("type")
            inst = cls._build(repo, typ, cfg)
            cls._instances[repo] = inst
            return inst

    @classmethod
    def _build(cls, repo: str, typ: str, cfg: dict[str, Any]) -> Any:
        if repo == "EVENTDATA":
            if typ == "memory":
                return MemoryEvents(cfg)
            if typ == "sqlite":
                _mkparent(cfg.get("path"))
                return SQLiteEvents(cfg)
            raise StorageError(f"unknown EVENTDATA source type: {typ}")
        if repo == "METADATA":
            if typ == "memory":
                return MetadataStore(":memory:")
            if typ == "sqlite":
                path = cfg.get("path", ":memory:")
                _mkparent(path)
                return MetadataStore(path)
            raise StorageError(f"unknown METADATA source type: {typ}")
        if repo == "MODELDATA":
            if typ == "localfs":
                return LocalFSModels(cfg.get("path", str(cls.home() / "models")))
            if typ == "memory":
                return _SQLiteModels(cls.get_metadata())
            if typ == "sqlite":
                path = cfg.get("path")
                if path:
                    _mkparent(path)
                    return _SQLiteModels(MetadataStore(path))
                return _SQLiteModels(cls.get_metadata())
            raise StorageError(f"unknown MODELDATA source type: {typ}")
        raise StorageError(f"unknown repository {repo}")

    @classmethod
    def get_metadata(cls) -> MetadataStore:
        return cls._get("METADATA")

    @classmethod
    def get_events(cls) -> EventBackend:
        return cls._get("EVENTDATA")

    @classmethod
    def get_models(cls):
        return cls._get("MODELDATA")

    # -- pio status (Storage.verifyAllDataObjects, Storage.scala:237-257) --
    @classmethod
    def verify_all_data_objects(cls) -> dict[str, str]:
        out: dict[str, str] = {}
        for repo in _REPOS:
            try:
                cls._get(repo)
                out[repo] = "ok"
            except Exception as e:  # noqa: BLE001 — status report, not control flow
                out[repo] = f"error: {e}"
        return out


def _mkparent(path: str | None) -> None:
    if path and path != ":memory:":
        Path(path).parent.mkdir(parents=True, exist_ok=True)
