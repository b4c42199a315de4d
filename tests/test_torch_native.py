"""The port's native host library against its numpy paths and the JAX
package's.

``predictionio_tpu_torch/native`` is a copy of the reference's C++ host
runtime (the layout's counting sort and block fill, the shard hash, the
JSONL scanner), built with g++ into the port's ignored ``_build/``. Each
entry point must agree bit for bit with the numpy fallback at its call
site, so ``PIO_NO_NATIVE=1`` only changes speed, and with the reference's,
so the port trains on the reference's layout. The semantics of
``tests/test_native.py``, on the port.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu import native as ref_native
from predictionio_tpu.ops import neighbors as ref_nb
from predictionio_tpu_torch import native
from predictionio_tpu_torch.ops import neighbors as nb
from predictionio_tpu_torch.storage.event import Event
from predictionio_tpu_torch.storage.partition import (_fnv1a64, entity_key,
                                                      hash64,
                                                      partition_events,
                                                      shard_of)

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library failed to build")


def _coo(n, num_rows, num_cols, seed=0, heavy_row=None, heavy_n=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, num_rows, n).astype(np.int64)
    if heavy_row is not None:
        rows = np.concatenate([rows, np.full(heavy_n, heavy_row, np.int64)])
    cols = rng.integers(0, num_cols, len(rows)).astype(np.int32)
    vals = rng.random(len(rows)).astype(np.float32)
    return rows, cols, vals


def _both_paths(rows, cols, vals, num_rows, **kw):
    nat = nb.build_neighbor_blocks(rows, cols, vals, num_rows, **kw)
    orig = nb.native.available
    nb.native.available = lambda: False
    try:
        ref = nb.build_neighbor_blocks(rows, cols, vals, num_rows, **kw)
    finally:
        nb.native.available = orig
    return nat, ref


def _same_blocks(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert a.dropped == b.dropped and a.max_degree == b.max_degree


def test_library_builds_into_the_ports_build_dir():
    assert native._LIB_PATH.parent == REPO / "predictionio_tpu_torch" / \
        "_build" / "native"
    assert native._LIB_PATH.exists()
    assert native._SRC == REPO / "predictionio_tpu_torch" / "native" / \
        "pio_native.cpp"


def test_source_is_the_references():
    """The C++ is a copy: only its comment naming the bindings differs."""
    mine = [ln for ln in native._SRC.read_text().splitlines()
            if not ln.startswith("//")]
    ref = [ln for ln in ref_native._SRC.read_text().splitlines()
           if not ln.startswith("//")]
    assert mine == ref


@pytest.mark.parametrize("kw", [
    dict(n=5000, num_rows=300, num_cols=200, block_rows=64),
    dict(n=3000, num_rows=100, num_cols=500, block_rows=32, degree_cap=64,
         seed=3, heavy_row=7, heavy_n=400),
    dict(n=200, num_rows=10, num_cols=400, block_rows=8, degree_cap=32,
         seed=1, heavy_row=0, heavy_n=300),
    dict(n=2000, num_rows=50, num_cols=70, block_rows=16, pad_id=70),
], ids=["no_overflow", "overflow_subsample", "heavy_row", "pad_id"])
def test_neighbor_blocks_native_equals_numpy_and_reference(kw):
    kw = dict(kw)
    n, num_rows, num_cols = kw.pop("n"), kw.pop("num_rows"), kw.pop("num_cols")
    heavy = dict(heavy_row=kw.pop("heavy_row", None),
                 heavy_n=kw.pop("heavy_n", 0))
    rows, cols, vals = _coo(n, num_rows, num_cols, **heavy)
    nat, plain = _both_paths(rows, cols, vals, num_rows, **kw)
    _same_blocks(nat, plain)
    ref = ref_nb.build_neighbor_blocks(rows, cols, vals, num_rows, **kw)
    _same_blocks(nat, ref)


def test_neighbor_blocks_empty():
    nat, plain = _both_paths(np.zeros(0, np.int64), np.zeros(0, np.int32),
                             np.zeros(0, np.float32), 10, block_rows=8)
    _same_blocks(nat, plain)


def test_seed_changes_subsample():
    rows, cols, vals = _coo(200, 10, 400, heavy_row=0, heavy_n=300)
    a = nb.build_neighbor_blocks(rows, cols, vals, 10, block_rows=8,
                                 degree_cap=32, seed=0)
    b = nb.build_neighbor_blocks(rows, cols, vals, 10, block_rows=8,
                                 degree_cap=32, seed=1)
    assert not np.array_equal(a.ids, b.ids)


@pytest.mark.parametrize("n,kmax", [(0, 5), (1, 0), (1000, 3),
                                    (100_000, 17), (300_000, 100_000)])
def test_counting_argsort_matches_numpy_stable(n, kmax):
    keys = np.random.default_rng(0).integers(0, kmax + 1, n).astype(np.int32)
    got = native.counting_argsort(keys, kmax)
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


def test_counting_argsort_out_of_range_returns_none():
    assert native.counting_argsort(np.array([0, 5], np.int32), 3) is None
    assert native.counting_argsort(np.array([-1, 0], np.int32), 3) is None
    assert native.counting_argsort(np.array([2**32, 1], np.int64), 3) is None
    np.testing.assert_array_equal(
        native.counting_argsort(np.array([2, 0, 1], np.int64), 2), [1, 2, 0])


def _layouts_equal(a, b):
    for x, y in zip(a, b):
        assert len(x.buckets) == len(y.buckets)
        for bx, by in zip(x.buckets, y.buckets):
            np.testing.assert_array_equal(bx.ids, by.ids)
            np.testing.assert_array_equal(bx.vals, by.vals)
        np.testing.assert_array_equal(x.pos, y.pos)


def _layout_input(seed=3):
    rng = np.random.default_rng(seed)
    n, nu, ni = 20_000, 300, 150
    rows = rng.integers(0, nu, n).astype(np.int64)
    cols = rng.integers(0, ni, n).astype(np.int64)
    vals = rng.random(n).astype(np.float32)
    rows[: n // 4] = 7  # a heavy row: the chunked tier's sort runs too
    return rows, cols, vals, nu, ni


def test_layout_identical_with_and_without_native(monkeypatch):
    rows, cols, vals, nu, ni = _layout_input()
    a = nb.build_bilinear_layout(rows, cols, vals, nu, ni, chunk_cap=64)
    monkeypatch.setattr(nb, "_stable_argsort_bounded",
                        lambda k, m: np.argsort(k, kind="stable"))
    monkeypatch.setattr(nb.native, "available", lambda: False)
    b = nb.build_bilinear_layout(rows, cols, vals, nu, ni, chunk_cap=64)
    _layouts_equal(a, b)
    _layouts_equal(a, ref_nb.build_bilinear_layout(rows, cols, vals, nu, ni,
                                                   chunk_cap=64))


def test_pio_no_native_subprocess_gives_the_same_layout(tmp_path):
    """``PIO_NO_NATIVE=1`` (as ``chip_smoke.py`` phase 7a times it) turns
    the library off in a fresh process, and the layout is unchanged."""
    rows, cols, vals, nu, ni = _layout_input(5)
    np.savez(tmp_path / "coo.npz", rows=rows, cols=cols, vals=vals)
    code = f"""
import json, sys
import numpy as np
from predictionio_tpu_torch import native
from predictionio_tpu_torch.ops import neighbors as nb
d = np.load({str(tmp_path / "coo.npz")!r})
u, i = nb.build_bilinear_layout(d["rows"], d["cols"], d["vals"], {nu}, {ni})
np.savez({str(tmp_path / "out.npz")!r},
         **{{f"u{{k}}": b.ids for k, b in enumerate(u.buckets)}},
         **{{f"i{{k}}": b.ids for k, b in enumerate(i.buckets)}},
         upos=u.pos, ipos=i.pos)
print(json.dumps({{"native": native.available()}}))
"""
    env = {"PIO_NO_NATIVE": "1", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"native": False}
    got = np.load(tmp_path / "out.npz")
    u, i = nb.build_bilinear_layout(rows, cols, vals, nu, ni)
    for k, b in enumerate(u.buckets):
        np.testing.assert_array_equal(got[f"u{k}"], b.ids)
    for k, b in enumerate(i.buckets):
        np.testing.assert_array_equal(got[f"i{k}"], b.ids)
    np.testing.assert_array_equal(got["upos"], u.pos)
    np.testing.assert_array_equal(got["ipos"], i.pos)


def test_hash64_native_matches_pure_python_and_reference():
    keys = [entity_key("user", f"u{i}") for i in range(50)] + [b"", b"\x00ab"]
    got = hash64(keys, seed=7)
    np.testing.assert_array_equal(
        got, np.array([_fnv1a64(k, 7) for k in keys], dtype=np.uint64))
    np.testing.assert_array_equal(got, ref_native.hash64_batch(keys, 7))


def test_shard_stability_and_spread():
    shards = [shard_of("item", f"i{i}", 8) for i in range(1000)]
    assert all(0 <= s < 8 for s in shards)
    assert np.bincount(shards, minlength=8).min() > 60


def test_partition_keeps_entity_together():
    evs = [Event(event="$set", entity_type="user", entity_id=f"u{i % 5}")
           for i in range(40)]
    parts = partition_events(evs, 4)
    assert sum(len(p) for p in parts) == 40
    for k, p in enumerate(parts):
        for e in p:
            assert shard_of(e.entity_type, e.entity_id, 4) == k


def test_scan_jsonl_matches_reference():
    lines = [json.dumps({"event": "rate", "entityType": "user",
                         "entityId": f"u{i}", "targetEntityType": "item",
                         "targetEntityId": f"i{i % 3}",
                         "properties": {"rating": i / 2},
                         "eventTime": "2020-01-01T00:00:00Z"})
             for i in range(20)]
    data = ("\n".join(lines) + "\n").encode()
    got, want = native.scan_jsonl(data), ref_native.scan_jsonl(data)
    assert got[0] == want[0] == 20
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # a line that is no flat JSON object: both hand it to the full parser
    bad = b'["not", "an", "object"]\n'
    assert native.scan_jsonl(bad) is None
    assert ref_native.scan_jsonl(bad) is None
