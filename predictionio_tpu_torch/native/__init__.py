"""ctypes bindings for the native host-runtime library (pio_native.cpp).

The shared library is compiled on demand with g++ into the package's
ignored ``_build/native/`` and cached by source mtime. Every entry point
has a pure-numpy fallback at its call site — ``available()`` is False when no compiler is
present or the build fails, and the framework keeps working.

Copied from ``predictionio_tpu/native/__init__.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "counting_argsort",
    "neighbor_blocks_native",
    "hash64_batch",
    "scan_jsonl",
    "splitmix64_np",
    "NFIELDS",
    "JSONL_FIELDS",
]

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 — the one Python home of this function; must
    match pio_native.cpp's splitmix64 bit-for-bit (the degree-cap subsample
    and shard hashing rely on native/fallback parity)."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
        return x ^ (x >> np.uint64(31))

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "pio_native.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build" / "native"
_LIB_PATH = _BUILD_DIR / "libpio_native.so"

NFIELDS = 11
JSONL_FIELDS = (
    "event", "entityType", "entityId", "targetEntityType", "targetEntityId",
    "eventTime", "prId", "eventId", "creationTime", "properties", "tags",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    # compile to a per-process temp path and rename into place: concurrent
    # importers (multi-host loaders, pytest-xdist) must never observe a
    # half-written .so, and os.replace is atomic on POSIX
    tmp = _LIB_PATH.with_suffix(f".so.tmp.{os.getpid()}")
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC", "-shared",
        "-pthread", str(_SRC), "-o", str(tmp),
    ]
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("pio_native build failed, using numpy fallbacks: %s", e)
        tmp.unlink(missing_ok=True)
        return False
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("PIO_NO_NATIVE"):
            return None
        try:
            src_exists = _SRC.exists()
            stale = src_exists and (
                not _LIB_PATH.exists()
                or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime
            )
        except OSError:
            src_exists, stale = False, False
        if stale and not _build():
            # never load a library older than its source — a stale binary
            # could silently diverge from the numpy fallbacks
            return None
        if not src_exists and not _LIB_PATH.exists():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            # the cached lib may be corrupt (e.g. a pre-atomic-rename
            # partial write); one rebuild attempt before giving up
            if not _build():
                return None
            try:
                lib = ctypes.CDLL(str(_LIB_PATH))
            except OSError as e:
                logger.warning("pio_native load failed: %s", e)
                return None

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

        lib.pio_neighbor_blocks.restype = ctypes.c_int64
        lib.pio_neighbor_blocks.argtypes = [
            i64p, i32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, i32p, f32p,
            ctypes.c_void_p,  # mask_out: optional (NULL = don't fill)
        ]
        lib.pio_hash64_batch.restype = None
        lib.pio_hash64_batch.argtypes = [
            u8p, i64p, ctypes.c_int64, ctypes.c_uint64, u64p,
        ]
        lib.pio_scan_jsonl.restype = ctypes.c_int64
        lib.pio_scan_jsonl.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        ]
        lib.pio_counting_argsort_i32.restype = ctypes.c_int32
        lib.pio_counting_argsort_i32.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, i64p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def neighbor_blocks_native(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    padded_rows: int,
    d: int,
    seed: int,
    *,
    want_mask: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None, int] | None:
    """COO -> padded [padded_rows, d] neighbor layout. None if unavailable.

    ``want_mask=False`` (default) skips the mask array entirely — validity
    is derivable as ``vals != 0`` when the caller epsilon-nudges genuine
    zero values (ops/neighbors.py does)."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    ids = np.zeros((padded_rows, d), np.int32)
    vv = np.zeros((padded_rows, d), np.float32)
    mask = np.zeros((padded_rows, d), np.float32) if want_mask else None
    dropped = lib.pio_neighbor_blocks(
        rows, cols, vals, len(rows), num_rows, d,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), ids, vv,
        mask.ctypes.data_as(ctypes.c_void_p) if mask is not None else None,
    )
    if dropped < 0:
        raise ValueError("pio_neighbor_blocks: invalid input")
    return ids, vv, mask, int(dropped)


def counting_argsort(keys: np.ndarray, key_max: int) -> np.ndarray | None:
    """Stable argsort of non-negative bounded int keys — bit-identical to
    ``np.argsort(keys, kind="stable")`` (pinned by tests/test_native.py),
    parallel counting sort in C++. None if the native lib is unavailable
    or a key falls outside [0, key_max] (callers fall back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    keys = np.asarray(keys)
    if keys.dtype != np.int32:
        # guard BEFORE the cast: wrapping an out-of-range int64 into
        # int32 would pass the native range check with a wrong key and
        # return a silently wrong permutation instead of None
        if len(keys) and (keys.min() < 0 or keys.max() > key_max):
            return None
        keys = keys.astype(np.int32)
    keys = np.ascontiguousarray(keys)
    out = np.empty(len(keys), np.int64)
    if lib.pio_counting_argsort_i32(keys, len(keys), int(key_max), out) != 0:
        return None
    return out


def hash64_batch(strings: list[bytes] | list[str], seed: int = 0) -> np.ndarray | None:
    """Batch 64-bit hash (FNV-1a + splitmix64 finalizer). None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    bs = [s.encode() if isinstance(s, str) else s for s in strings]
    offsets = np.zeros(len(bs) + 1, np.int64)
    np.cumsum([len(b) for b in bs], out=offsets[1:])
    buf = np.frombuffer(b"".join(bs), np.uint8) if bs else np.zeros(0, np.uint8)
    buf = np.ascontiguousarray(buf)
    if len(buf) == 0:
        buf = np.zeros(1, np.uint8)  # valid pointer for the empty case
    out = np.zeros(len(bs), np.uint64)
    lib.pio_hash64_batch(buf, offsets, len(bs),
                         ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), out)
    return out


def scan_jsonl(data: bytes) -> tuple[int, np.ndarray, np.ndarray] | None:
    """Scan newline-delimited JSON events.

    Returns (n_lines, starts[n, NFIELDS], ends[n, NFIELDS]) — byte ranges of
    each field's raw value in ``data`` (0,0 = absent; string values include
    their quotes). None if the native library is unavailable OR any line is
    not a flat JSON object (caller falls back to the full parser).
    """
    lib = _load()
    if lib is None:
        return None
    max_lines = data.count(b"\n") + 1
    starts = np.zeros((max_lines, NFIELDS), np.int64)
    ends = np.zeros((max_lines, NFIELDS), np.int64)
    n = lib.pio_scan_jsonl(data, len(data), max_lines,
                           starts.reshape(-1), ends.reshape(-1))
    if n < 0:
        return None
    return int(n), starts[:n], ends[:n]
