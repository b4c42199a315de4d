"""The top-k kernel on one card: timed against earlier versions of its
source, and as the compiler built it.

    python3 scripts/topk_ab.py [--resources] [--old OLD.cu ...]
                               [--shapes topk_b1,topk_b8,topk_b128,rows_b8,
                                         rows_b128,topk_b64_k64,
                                         topk_b128_k64,topk_b128_k1000,
                                         rows_b8_k104,unpacked_b8]

``--old`` (repeatable) names an earlier ``topk.cu``, for example
``git show <rev>:predictionio_tpu_torch/csrc/topk.cu`` written under
``predictionio_tpu_torch/_build/``. Each is built beside the current
kernels with its entry points renamed, and at each of ``--shapes`` (the
ML-20M catalog, 27,136 x 128 padded f32, through ``topk`` or the fused row
gather ``topk_rows``; the unpacked two-buffer case on a catalog past 2^24
rows) all versions are timed in turns (olds, new, new, olds reversed) with
CUDA events, next to ``torch.topk(q @ items.T)`` as a yardstick, and each
version's device time is split by kernel under the profiler. At every
shape the new output must be bitwise equal to the first old version's
(each later ``--old`` is compared with it too, and reported).
``--resources`` compiles ``csrc/topk.cu`` (and each ``--old``) with
``nvcc -cubin -Xptxas -v`` for sm_90a and prints each kernel's registers,
spill bytes and shared memory, and its ``FFMA`` count from
``cuobjdump -sass``. One JSON object a line; exits non-zero without a
card, and on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.ops.pipeline import _capacity  # noqa: E402
from predictionio_tpu_torch.ops.retrieval import PACKED_IDX_LIMIT  # noqa: E402
from scripts.attn_bwd_ab import (  # noqa: E402
    build_renamed, emit, kernel_resources)

#: name -> (entry point, batch, k_pad, catalog): the plain entry at the
#: serving batches, the fused gather at the serving buckets b_pad 8 and
#: 128 (num 20 -> k_pad 24), the sort path (k_pad > 32: 64, 1000, and
#: num 100 -> k_pad 104 at the 8-row bucket) and the two-buffer output
SHAPES = {"topk_b1": ("topk", 1, 16, "ml20m"),
          "topk_b8": ("topk", 8, 16, "ml20m"),
          "topk_b128": ("topk", 128, 16, "ml20m"),
          "rows_b8": ("topk_rows", 8, 24, "ml20m"),
          "rows_b128": ("topk_rows", 128, 24, "ml20m"),
          "topk_b64_k64": ("topk", 64, 64, "ml20m"),
          "topk_b128_k64": ("topk", 128, 64, "ml20m"),
          "topk_b128_k1000": ("topk", 128, 1000, "ml20m"),
          "rows_b8_k104": ("topk_rows", 8, 104, "ml20m"),
          "unpacked_b8": ("topk", 8, 16, "big")}


def build_old(path: Path, n: int):
    """Build an earlier source as library ``n``: (entry, workspace size,
    whether the entry takes the trailing ``launched`` counts)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    prefix = f"pio_old{n}_topk"
    counts = "int* launched)" in path.read_text()
    lib = build_renamed(path, f"pio_topk_old{n}", "pio_topk", prefix,
                        {"": [p, p, ll, i, p, ll, i, ll, i, p, p, p, p, p]
                         + ([p] if counts else [])}, init="_init")
    ws = getattr(lib, prefix + "_workspace")
    ws.argtypes, ws.restype = [i, ll, i], ll
    return getattr(lib, prefix), ws, counts


def old_call(old, q, rows, items, n_total: int, k_pad: int):
    """``kernels._launch`` through an earlier library."""
    fn, ws_size, counts = old
    dev = items.device
    b_pad = q.shape[0] if rows is None else rows.shape[0]
    n_items, dim = items.shape
    ws = torch.empty(ws_size(b_pad, n_items, k_pad), dtype=torch.int64,
                     device=dev)
    if n_total < PACKED_IDX_LIMIT:
        out = torch.empty(b_pad, 2 * k_pad, device=dev)
        ptrs = (out.data_ptr(), None, None)
    else:
        vals = torch.empty(b_pad, k_pad, device=dev)
        ids = torch.empty(b_pad, k_pad, dtype=torch.int32, device=dev)
        out = (vals, ids)
        ptrs = (None, vals.data_ptr(), ids.data_ptr())
    launched = [(ctypes.c_int * 3)()] if counts else []
    err = fn(q.data_ptr(), None if rows is None else rows.data_ptr(),
             q.shape[0], b_pad, items.data_ptr(), n_items, dim, n_total,
             k_pad, ws.data_ptr(), *ptrs,
             torch.cuda.current_stream(dev).cuda_stream, *launched)
    if err:
        raise RuntimeError(f"old kernel launch failed: cudaError {err}")
    return out


def same_bits(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def catalogs(dev) -> dict:
    rng = np.random.default_rng(cs.SEED)
    scale = 1 / np.sqrt(cs.RANK)
    items = cs.padded_catalog(rng, cs.N_ITEMS, cs.RANK, dev, scale)
    qtab = torch.zeros(_capacity(cs.N_USERS), items.shape[1], device=dev)
    qtab[:cs.N_USERS, :cs.RANK] = torch.from_numpy(
        (rng.standard_normal((cs.N_USERS, cs.RANK)) * scale)
        .astype(np.float32))
    rows = rng.integers(0, cs.N_USERS, 128).astype(np.int32)
    rows[:4] = [-1, cs.N_USERS, cs.N_USERS + 7, qtab.shape[0] + 3]
    return {"rng": rng, "scale": scale, "ml20m": (items, cs.N_ITEMS),
            "qtab": qtab, "rows": torch.from_numpy(rows).to(dev)}


def big_catalog(dev):
    n_total = PACKED_IDX_LIMIT + 1000
    big = torch.empty(((n_total + 511) // 512 * 512, 128), device=dev)
    big.normal_(generator=torch.Generator(device=dev).manual_seed(cs.SEED))
    return big, n_total


def compare(olds: dict, name: str, card: str, cats: dict) -> bool:
    """Time the current kernel and each earlier version in ``olds`` (tag ->
    (entry, workspace size)) in turns: olds, new, new, olds reversed.
    Returns whether the new output is bitwise equal to the first old
    version's."""
    dev = cats["qtab"].device
    entry, b, k_pad, cat = SHAPES[name]
    items, n_total = cats[cat] if cat in cats else big_catalog(dev)
    if entry == "topk":
        q = cs.padded_queries(cats["rng"], b, cs.RANK, items.shape[1], dev,
                              cats["scale"])
        rows, qg = None, q
        new = lambda: kernels.topk(q, items, n_total, k_pad)  # noqa: E731
    else:
        q, rows = cats["qtab"], cats["rows"][:b].contiguous()
        ok = (rows >= 0) & (rows < q.shape[0])
        qg = q[torch.where(ok, rows, 0).long()].masked_fill(~ok[:, None], 0)
        new = lambda: kernels.topk_rows(rows, q, items, n_total,  # noqa: E731
                                        k_pad)
    runs = {tag: (lambda old=old: old_call(old, q, rows, items, n_total,
                                           k_pad))
            for tag, old in olds.items()}
    first = next(iter(olds))
    want = runs[first]()
    bitwise = same_bits(new(), want)
    rec = {"shape": name, "entry": entry, "b_pad": int(qg.shape[0]),
           "n_pad": int(items.shape[0]), "n_total": n_total, "k_pad": k_pad,
           "card": card, f"bitwise_vs_{first}": bitwise}
    for tag in list(olds)[1:]:  # reported, not held
        rec[f"{tag}_bitwise_vs_{first}"] = same_bits(runs[tag](), want)
    del want
    iters, reps = (3, 5) if cat == "big" else (20, 5)
    order = [*olds, "new", "new", *reversed(olds)]
    times = {tag: [] for tag in order}
    for tag in order:
        times[tag].append(cs.device_ms(new if tag == "new" else runs[tag],
                                       iters, reps))
    for tag, ts in times.items():
        rec[f"{tag}_ms"] = ts
    rec[f"speedup_vs_{first}"] = sum(times[first]) / sum(times["new"])
    rec["library_ms"] = cs.device_ms(lambda: torch.topk(qg @ items.T, k_pad),
                                     iters, reps)
    rec["bound_ms"], rec["bound_by"] = cs.bound_ms(
        rec["b_pad"], rec["n_pad"], int(items.shape[1]), k_pad,
        rows is not None)
    rec["new_share_of_bound"] = rec["bound_ms"] / min(times["new"])
    for tag, fn in (("new", new), (first, runs[first])):
        busy, _ = cs.device_profile(lambda fn=fn: [fn() for _ in range(iters)])
        rec[f"{tag}_stage_ms"] = {k: v / iters for k, v in busy.items()}
    emit(rec)
    return bitwise


#: kernel names: topk_select<QT>, topk_sort<QT>, topk_merge_round<in smem>
#: (and earlier sources' topk_partial<QT>, topk_merge<in smem>,
#: topk_merge_ticket)
KERNEL = re.compile(r"(topk_partial|topk_select|topk_sort|topk_merge_round|"
                    r"topk_merge_ticket|topk_merge)(?:I(?:Li(\d+)E|"
                    r"Lb([01])E))?")


def dyn_smem(kind: str, qt: int | None) -> int | None:
    """Stage 1's dynamic shared memory, as csrc/topk.cu's ring_smem_bytes
    (and an earlier source's partial_smem_bytes) compute it (the merge's
    depends on the call)."""
    if kind == "topk_partial":
        return 4 * qt * 32 + max(256 * 33 * 4, qt * 256 * 8)
    if kind in ("topk_select", "topk_sort"):
        return 2 * (256 + qt) * 36 * 4
    return None


def resources(src: Path, tag: str) -> None:
    for fn, rec in sorted(kernel_resources(src, f"topk_{tag}").items()):
        m = KERNEL.search(fn)
        kind = m.group(1) if m else fn
        qt = int(m.group(2)) if m and m.group(2) else None
        emit({"source": tag, "kernel": kind, "query_tile": qt, **rec,
              "dynamic_smem_bytes": dyn_smem(kind, qt)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--resources", action="store_true")
    ap.add_argument("--old", type=Path, action="append", default=[])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("topk_ab: no CUDA device is visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    kernels.build()
    if args.resources:
        resources(kernels.SOURCES[0], "new")
        for path in args.old:
            resources(path, path.stem)
    held = True
    if args.old:
        olds = {path.stem: build_old(path, n)
                for n, path in enumerate(args.old)}
        cats = catalogs(torch.device("cuda"))
        for name in args.shapes.split(","):
            held = compare(olds, name, smi, cats) and held
            torch.cuda.empty_cache()
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
