"""The attention forward kernels on one card: timed against earlier
versions of their source, and as the compiler built them.

    python3 scripts/attn_fwd_ab.py [--resources] [--old OLD.cu ...]
                                   [--shapes train,f32,bf16,long,serve128,
                                             tmpl_f32,tmpl_bf16,wide_f32,
                                             wide_bf16,huge_f32,huge_bf16]

``--old`` (repeatable) names an earlier forward source, for example
``git show <rev>:predictionio_tpu_torch/csrc/flash_attn.cu`` (the narrow
forward, head dims up to 256), an earlier ``csrc/flash_attn_wide.cu``,
whose forward the wide shapes (head dims 384 to 1,024) take, or an earlier
``csrc/flash_attn_huge.cu``, whose forward the huge shapes (head dims
above 1,024) take (its entry point takes a workspace, sized by that
source's own ``pio_flash_attn_huge_workspace``), written under
``predictionio_tpu_torch/_build/``. Each is built beside the current
kernels with its entry points renamed, and at each of ``--shapes`` (causal
attention) the current kernel and every old version of its kind are timed
in turns (olds, new, new, olds reversed) with CUDA events, next to
``scaled_dot_product_attention`` as a yardstick (and, at the huge shapes,
the plain ``blockwise_attention``). At each shape the new output is held
against the first old version's (the plain ``blockwise_attention``'s where
no old version of its kind was given) within ``chip_smoke.ATTN_TOL``, and
the new forward that writes the logsumexp must give the same output bits
as the serving forward (no logsumexp). ``--resources`` compiles
``csrc/flash_attn.cu``, ``csrc/flash_attn_wide_fwd.cu`` and
``csrc/flash_attn_huge.cu`` (and each ``--old``) with ``nvcc -cubin
-Xptxas -v`` for sm_90a and prints each kernel's registers, spill bytes
and dynamic shared memory, and its ``HMMA`` and ``FFMA`` counts from
``cuobjdump -sass``; for the wide forward also its launch at every wide
head dim and type with the clusters the card holds at once
(``kernels.wide_fwd_plan_on_card``), and for the huge forward its three
passes' launches at the huge shape with the CTAs an SM holds
(``kernels.huge_fwd_plan_on_card``). One JSON object a line; exits
non-zero without a card, and on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from scripts.attn_bwd_ab import (  # noqa: E402
    HUGE_WS_DTYPE, build_renamed, emit, kernel_resources)

#: (B, L, H, D, dtype), all causal: the training / serving shape (b_pad 8),
#: the seqrec attention shape in both types, a long sequence, a full
#: serving batch (b_pad 128), the shipped template's (embed 48, 2 heads),
#: the wide forward's timed shape (a seqrec model at embed 2,048 and 4
#: heads, or embed 512 and one head) and the huge one's (chip_smoke.py's
#: B1 L1024 H2 D4096) in both types
SHAPES = {"train": (8, 4096, 8, 64, "float32"),
          "f32": (4, 4096, 8, 64, "float32"),
          "bf16": (4, 4096, 8, 64, "bfloat16"),
          "long": (1, 16384, 8, 64, "bfloat16"),
          "serve128": (128, 4096, 8, 64, "float32"),
          "tmpl_f32": (8, 64, 2, 24, "float32"),
          "tmpl_bf16": (8, 64, 2, 24, "bfloat16"),
          "wide_f32": (2, 2048, 4, 512, "float32"),
          "wide_bf16": (2, 2048, 4, 512, "bfloat16"),
          "huge_f32": (1, 1024, 2, 4096, "float32"),
          "huge_bf16": (1, 1024, 2, 4096, "bfloat16")}


def build_old(path: Path, n: int):
    """Build an earlier source as library ``n``: (its kind, ``narrow``,
    ``wide`` or ``huge``, its forward entry point, and for a huge source
    its workspace query, else None). A huge source's forward takes a
    workspace pointer after the logsumexp; its ``workspace`` entry sizes it
    (with the dtype as a sixth argument where the source takes one)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = path.read_text()
    kind = ("huge" if "pio_flash_attn_huge_fwd" in text else "wide"
            if "pio_flash_attn_wide_fwd" in text else "narrow")
    stem = "pio_flash_attn_" + {"narrow": "", "wide": "wide_",
                                "huge": "huge_"}[kind]
    prefix = f"pio_old{n}_" + stem[4:]
    huge = kind == "huge"
    lib = build_renamed(path, f"pio_fwd_old{n}", stem, prefix,
                        {"fwd": [p] * (5 + huge) + [i] * 6 + [f, p]},
                        init=None if huge else "init")
    ws = None
    if huge:
        ws = getattr(lib, prefix + "workspace")
        ws.argtypes = [i] * (6 if HUGE_WS_DTYPE.search(text) else 5)
        ws.restype = ctypes.c_longlong
    return kind, getattr(lib, prefix + "fwd"), ws


def old_call(fwd, ws, q, k, v, causal: bool):
    B, L, H, D = q.shape
    code = kernels._ATTN_DTYPES[q.dtype]
    out = torch.empty_like(q)
    extra = []
    if ws is not None:
        nbytes = ws(B, L, H, D, 0, *([code] if len(ws.argtypes) == 6
                                     else []))
        buf = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        extra = [buf.data_ptr()]
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
              *extra, B, L, H, D, code, int(causal), 1.0 / D**0.5,
              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old kernel launch failed: cudaError {err}")
    return out


def compare(olds: dict, name: str, card: str, B, L, H, D, dtype: str) -> bool:
    """Time the current kernel and each earlier version of its kind in
    ``olds`` (tag -> (kind, entry point, workspace query)) in turns: olds,
    new, new, olds reversed. Returns whether the outputs held."""
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + B * L + D)
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device=dev)
               .mul_(0.5).to(dt) for _ in range(3))
    new = lambda: kernels.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
    route = kernels._route(D)
    runs = {tag: (lambda fwd=fwd, ws=ws: old_call(fwd, ws, q, k, v, True))
            for tag, (kind, fwd, ws) in olds.items() if kind == route}
    first = next(iter(runs), "plain")
    got = new()
    want = (runs[first]() if runs
            else cs.chunked_blockwise(q, k, v, causal=True))
    lse = torch.empty(B, H, L, device=dev)
    bitwise = torch.equal(got, kernels.flash_attention_fwd(q, k, v,
                                                           causal=True,
                                                           lse=lse))
    err = float((got.float() - want.float()).abs().max())
    tol = cs.ATTN_TOL[dt]
    held = bitwise and bool(torch.allclose(got.float(), want.float(),
                                           rtol=tol, atol=tol))
    del got, want, lse
    rec = {"shape": name, "B": B, "L": L, "H": H, "D": D, "dtype": dtype,
           "card": card, f"max_abs_err_vs_{first}": err, "tol": tol,
           "lse_forward_bitwise": bitwise, "held": held}
    if route == "wide":
        rec["plan"] = kernels.wide_fwd_plan_on_card(B, L, H, D, dt, True)
    iters, reps = (2, 3) if B * L * L * H >= 1 << 34 else (10, 5)
    if route == "huge":
        rec["plan"] = kernels.huge_fwd_plan_on_card(B, L, H, D, dt, True)
        rec["plain_ms"] = cs.device_ms(
            lambda: cs.chunked_blockwise(q, k, v, causal=True), iters, reps)
    order = [*runs, "new", "new", *reversed(runs)]
    times = {tag: [] for tag in order}
    for tag in order:
        times[tag].append(cs.device_ms(new if tag == "new" else runs[tag],
                                       iters, reps))
    for tag, ts in times.items():
        rec[f"{tag}_ms"] = ts
    if runs:
        rec[f"speedup_vs_{first}"] = sum(times[first]) / sum(times["new"])
    if route == "huge":  # each version's device time by pass (profiler)
        for tag in ("new", *runs):
            stages = cs.stage_ms(new if tag == "new" else runs[tag], iters)
            rec[f"{tag}_pass_ms"] = {
                name: cs.kernel_ms(stages, f"huge_{name}") for name in (
                    "score", "softmax", "product", "fwd")}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rec["sdpa_ms"] = cs.device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters, reps)
    rec["bound_ms"], rec["bound_by"] = cs.attn_bound_ms(B, L, H, D, dt, True)
    rec["new_share_of_bound"] = rec["bound_ms"] / min(times["new"])
    emit(rec)
    return held


#: kernel names: the current source's fwd_f32<DP, BM, causal> (BM query
#: rows a CTA) and fwd_bf16<DP, MT, causal> (64 * MT rows a CTA), and the
#: first version's flash_fwd<T, DP, causal>
KERNEL = re.compile(r"(fwd_f32|fwd_bf16|flash_fwd)I(f|13__nv_bfloat16)?"
                    r"Li(\d+)E(?:Li(\d+)E)?Lb([01])E")
#: the wide forward's wide_fwd_f32<causal> and wide_fwd_bf16<causal> (a
#: 128-feature slice and 64 query rows a CTA), and the first version's
#: wide_fwd<T, D / 32> (one warp a row, 8 rows a CTA; its backward kernels
#: are wide_bwd_dq and wide_bwd_dkv)
WIDE_KERNEL = re.compile(r"wide_fwd_(f32|bf16)ILb([01])E")
OLD_WIDE_KERNEL = re.compile(r"(wide_fwd|wide_bwd_dq|wide_bwd_dkv)"
                             r"I(f|13__nv_bfloat16)Li(\d+)E")
#: the huge forward's passes: huge_score<T, 0, causal>, huge_softmax<T,
#: causal> and dQ's huge_product<T, 1, causal>; the first version's
#: huge_fwd<T> (four query rows a CTA)
HUGE_FWD_KERNEL = re.compile(r"huge_(?:(score)I(f|13__nv_bfloat16)Li0E"
                             r"|(softmax)I(f|13__nv_bfloat16)"
                             r"|(product)I(f|13__nv_bfloat16)Li1E"
                             r"|(fwd)I(f|13__nv_bfloat16)E)(?:Lb([01])E)?")


def dyn_smem(kind: str, dp: int, rows: int | None) -> int | None:
    """Dynamic shared memory of the current kernels at ``rows`` query rows
    a CTA, as csrc/flash_attn.cu's F32Fwd::kFloats and bf16_fwd_bytes
    compute it (keys per tile: 64, 32 at head dim 256)."""
    bn = 64 if dp <= 128 else 32
    if kind == "fwd_f32":
        sx, sy = rows + 4, dp + 4
        return 4 * (dp * sx + 4 * bn * sy + bn * sx)
    if kind == "fwd_bf16":
        return 2 * (rows + 4 * bn) * (dp + 8)
    return None


def resources(src: Path, tag: str) -> None:
    huge = "pio_flash_attn_huge_fwd" in src.read_text()
    for fn, rec in sorted(kernel_resources(src, f"fwd_{tag}").items()):
        if huge:  # the forward's kernels of a huge source
            hg = HUGE_FWD_KERNEL.search(fn)
            if hg:
                name, dtype = next((hg.group(g), hg.group(g + 1))
                                   for g in (1, 3, 5, 7) if hg.group(g))
                emit({"source": tag, "kernel": f"huge_{name}",
                      "dtype": "f32" if dtype == "f" else "bf16",
                      "causal": hg.group(9) == "1" if hg.group(9) else None,
                      **rec})
            continue
        m, w, o = (KERNEL.search(fn), WIDE_KERNEL.search(fn),
                   OLD_WIDE_KERNEL.search(fn))
        if w:
            dtype = w.group(1)
            plan = kernels.wide_fwd_plan(
                1, 64, 1, 512, getattr(torch, {"f32": "float32"}.get(
                    dtype, "bfloat16")))
            emit({"source": tag, "kernel": f"wide_fwd_{dtype}",
                  "dtype": dtype, "slice": 128, "rows": 64,
                  "causal": w.group(2) == "1", **rec,
                  "dynamic_smem_bytes": plan["smem_bytes"]})
            continue
        if o:
            emit({"source": tag, "kernel": o.group(1),
                  "dtype": "bf16" if o.group(2).endswith("bfloat16")
                  else "f32", "head_dim": 32 * int(o.group(3)), "rows": 8,
                  **rec})
            continue
        if m:
            kind, dp = m.group(1), int(m.group(3))
            bm = int(m.group(4)) if m.group(4) else None
            if kind == "fwd_bf16":
                bm *= 64  # MT m16 tiles a warp, 4 warps
            dtype = "bf16" if (m.group(2) or "").endswith("bfloat16") or \
                kind == "fwd_bf16" else "f32"
            causal = m.group(5) == "1"
        else:
            kind, dtype, dp, bm, causal = fn, None, None, None, None
        emit({"source": tag, "kernel": kind, "dtype": dtype,
              "head_dim_pad": dp, "rows": bm, "causal": causal, **rec,
              "dynamic_smem_bytes": dyn_smem(kind, dp, bm) if dp else None})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--resources", action="store_true")
    ap.add_argument("--old", type=Path, action="append", default=[])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_fwd_ab: no CUDA device is visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    kernels.build()
    if args.resources:
        resources(kernels.SOURCES[1], "new")
        resources(kernels.SOURCES[3], "wide")
        resources(kernels.SOURCES[5], "huge")
        for path in args.old:
            resources(path, path.stem)
        for D in range(384, kernels.WIDE_MAX_HEAD_DIM + 1, 128):
            for dtype in (torch.float32, torch.bfloat16):
                emit({"source": "wide", "plan_D": D, "dtype": str(dtype),
                      **kernels.wide_fwd_plan_on_card(*SHAPES["wide_f32"][:3],
                                                      D, dtype, True)})
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                emit({"source": "huge", "dtype": str(dtype),
                      "causal": causal, **kernels.huge_fwd_plan_on_card(
                          *SHAPES["huge_f32"][:4], dtype, causal)})
    held = True
    if args.old:
        olds = {path.stem: build_old(path, n)
                for n, path in enumerate(args.old)}
        for name in args.shapes.split(","):
            held = compare(olds, name, smi, *SHAPES[name]) and held
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
