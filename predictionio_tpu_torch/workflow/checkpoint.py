"""Mid-training checkpoint/resume: the single-process ``.npz`` backend.

Copied from ``predictionio_tpu/workflow/checkpoint.py``:
``TrainCheckpointer`` with its ``.npz`` backend (``_recover``, ``steps``,
``save``, ``restore``, ``restore_first_valid``, ``clear``) and the fsync
helpers. A training state is a flat dict of host arrays and scalars;
torch tensors are moved to the host before they are written. Step
directories are ``step_<n>``; a step counts only once its ``_COMPLETE``
marker lands, and retention keeps the newest ``keep`` steps. The orbax
backend and ``ShardedTrainCheckpointer`` (multi-process) come with the
port's multi-device slice.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np

from ..obs.metrics import METRICS

log = logging.getLogger("predictionio_tpu_torch.workflow")

_M_CKPT_SAVE = METRICS.histogram(
    "pio_checkpoint_save_seconds",
    "full durable checkpoint save (backend write + fsync tree + swap)")

__all__ = ["TrainCheckpointer"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    """Durably record directory entries (new files / renames). Some
    filesystems refuse O_RDONLY fsync on directories — a durability
    best-effort there, same as most databases handle it."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_tree(root: Path) -> None:
    """fsync every regular file under ``root``, then its directories
    bottom-up, so the whole step's contents are on stable storage before
    the ``_COMPLETE`` marker claims they are."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        d = Path(dirpath)
        for fn in filenames:
            _fsync_file(d / fn)
        _fsync_dir(d)


def _to_host(tree: Any) -> Any:
    """torch tensors -> numpy so checkpoints are device-independent."""
    import torch

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return {k: host(v) for k, v in tree.items()}


class _NpzBackend:
    """Flat-pytree .npz fallback (dict-of-arrays/scalars only)."""

    def save(self, path: Path, state: Any) -> None:
        path.mkdir(parents=True, exist_ok=True)
        arrays = {k: np.asarray(v) for k, v in _to_host(state).items()}
        np.savez(path / "state.npz", **arrays)

    def restore(self, path: Path) -> Any:
        with np.load(path / "state.npz", allow_pickle=False) as z:
            return {k: z[k] for k in z.files}


class TrainCheckpointer:
    """Save/restore a training-state pytree per step under ``directory``."""

    def __init__(self, directory: str | Path, *, keep: int = 2,
                 backend: str = "npz"):
        if backend not in ("npz", "auto"):
            raise ValueError(f"unsupported checkpoint backend {backend!r}; "
                             "the port writes .npz")
        self.directory = Path(directory)
        self.keep = max(1, keep)
        self._backend = _NpzBackend()

    # -- steps -------------------------------------------------------------
    def _recover(self) -> None:
        """Repair interrupted overwrites. save() swaps via ``step_N.tmp``
        and ``step_N.old`` siblings; a crash can leave any combination of
        them. Rules: a COMPLETE ``.tmp`` is a finished newer save — promote
        it over ``step_N``; an incomplete ``.tmp`` is garbage; ``.old`` is
        the displaced previous checkpoint — restore it only if ``step_N``
        vanished mid-swap, else delete."""
        if not self.directory.is_dir():
            return
        for tmp in self.directory.glob("step_*.tmp"):
            name = tmp.name[: -len(".tmp")]
            if not _STEP_RE.match(name):
                continue
            final = self.directory / name
            if (tmp / "_COMPLETE").exists():
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                log.warning("recovered interrupted checkpoint save: %s", name)
            else:
                shutil.rmtree(tmp, ignore_errors=True)
        for old in self.directory.glob("step_*.old"):
            name = old.name[: -len(".old")]
            if not _STEP_RE.match(name):
                continue
            final = self.directory / name
            if not final.exists() and (old / "_COMPLETE").exists():
                old.rename(final)
                log.warning("restored displaced checkpoint: %s", name)
            else:
                shutil.rmtree(old, ignore_errors=True)

    def steps(self) -> list[int]:
        self._recover()
        if not self.directory.is_dir():
            return []
        out = []
        for child in self.directory.iterdir():
            m = _STEP_RE.match(child.name)
            if m and (child / "_COMPLETE").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step}"

    # -- save / restore ----------------------------------------------------
    def save(self, step: int, state: Any) -> None:
        """Write atomically AND durably: the step counts only once
        _COMPLETE lands, and _COMPLETE lands only after the step's
        contents are fsynced (file data, then the marker, then the parent
        directory after the rename) — a power cut can surface a missing
        checkpoint, never a "complete" one with torn contents.

        Overwrites are atomic too — the new state is written to a ``.tmp``
        sibling and swapped in, so a crash mid-overwrite never loses the
        previously complete checkpoint of the same step.
        """
        t0 = time.perf_counter()
        try:
            self._save(step, state)
        finally:
            _M_CKPT_SAVE.record(time.perf_counter() - t0)

    def _save(self, step: int, state: Any) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        self._recover()  # settle any interrupted swap before starting ours
        path = self._step_dir(step)
        tmp = self.directory / f"step_{step}.tmp"
        if tmp.exists():  # leftover from a crashed save
            shutil.rmtree(tmp)
        self._backend.save(tmp, state)
        _fsync_tree(tmp)  # contents durable BEFORE the marker exists
        marker = tmp / "_COMPLETE"
        marker.write_text(json.dumps({"step": step}))
        _fsync_file(marker)
        _fsync_dir(tmp)
        if path.exists():
            old = self.directory / f"step_{step}.old"
            if old.exists():
                shutil.rmtree(old)
            path.rename(old)
            tmp.rename(path)
            _fsync_dir(self.directory)  # both renames durable together
            shutil.rmtree(old, ignore_errors=True)
        else:
            tmp.rename(path)
            _fsync_dir(self.directory)
        log.info("checkpoint saved: step %d -> %s", step, path)
        # Retention prunes only steps <= the one just saved: steps beyond it
        # can exist legitimately (same run previously trained to a higher
        # iteration target) and must not shadow-delete the fresh save.
        eligible = [s for s in self.steps() if s <= step]
        for old_step in eligible[: -self.keep]:
            shutil.rmtree(self._step_dir(old_step), ignore_errors=True)

    def restore(self, step: int | None = None) -> tuple[int, Any] | None:
        """(step, state) for ``step`` or the latest; None when empty."""
        self._recover()  # an explicit step may need an interrupted-swap repair
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return step, self._backend.restore(self._step_dir(step))

    def restore_first_valid(self, is_valid) -> tuple[int, Any] | None:
        """Walk steps newest-first and return the first whose state passes
        ``is_valid(state)`` — a stale higher-numbered step from an older
        run must not shadow resumable ones."""
        for step in reversed(self.steps()):
            try:
                state = self._backend.restore(self._step_dir(step))
                ok = bool(is_valid(state))
            except Exception as e:
                # unreadable step OR a foreign state shape the validator
                # chokes on — either way, skip it, don't abort the walk
                log.warning("checkpoint step %d unusable (%s); skipping", step, e)
                continue
            if ok:
                return step, state
            log.info("checkpoint step %d is from a different run; skipping", step)
        return None

    def clear(self) -> None:
        """Drop every step (a fresh run starting over must not leave stale
        steps that retention would preserve over its own)."""
        for step in self.steps():
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
