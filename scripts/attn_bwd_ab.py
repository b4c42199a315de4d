"""The attention backward kernels on one card: timed against earlier
versions of their source, and as the compiler built them.

    python3 scripts/attn_bwd_ab.py [--resources] [--old OLD.cu ...]
                                   [--shapes train,f32,bf16,long,wide_f32,
                                             wide_bf16,huge_f32,huge_bf16]

``--old`` (repeatable) names an earlier backward source, for example
``git show <rev>:predictionio_tpu_torch/csrc/flash_attn_bwd.cu`` (the
narrow kernels, head dims up to 256) or an earlier ``csrc/
flash_attn_wide.cu`` (its ``pio_flash_attn_wide_bwd_`` entry points; the
wide shapes, head dims 384 to 1,024, take it) or ``csrc/
flash_attn_huge.cu`` (its ``pio_flash_attn_huge_`` entry points, which take
a workspace; the huge shapes, head dims above 1,024, take it), written
under ``predictionio_tpu_torch/_build/``. Each is built beside the current
kernels with its entry points renamed, and at each of ``--shapes`` (causal
attention: H8 D64, the wide kernels' B2 L2048 H4 D512, or the huge ones'
B1 L1024 H2 D4096) the current kernels and every old version of their
kind are timed in turns (olds, new, new, olds reversed) with CUDA events,
next to the backward of ``scaled_dot_product_attention`` as a yardstick
(and, at the huge shapes, the plain ``blockwise_attention_bwd``), with each
kernel's bound and share of it. At each shape the new gradients are held
against the first old version's of their kind (the plain
``blockwise_attention_bwd``'s where none was given) within
``chip_smoke.BWD_TOL`` of each one's largest magnitude. ``--resources``
compiles ``csrc/flash_attn_bwd.cu``, ``csrc/flash_attn_wide.cu`` and
``csrc/flash_attn_huge.cu`` (and each ``--old``) with ``nvcc -cubin
-Xptxas -v`` for sm_90a and prints each kernel's registers, spill bytes
and dynamic shared memory, and its ``HMMA`` and ``FFMA`` counts from
``cuobjdump -sass``; for the wide backward also its launch at every wide
head dim, type and kind with the clusters the card holds at once
(``kernels.wide_bwd_plan_on_card``), and for the huge backward its two
passes' launches at the huge shape with the CTAs an SM holds
(``kernels.huge_bwd_plan_on_card``). One JSON object a line; exits
non-zero without a card, and on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.parallel.ring_attention import (  # noqa: E402
    attention_di)

#: (B, L, H, D, dtype), all causal: the training shape, the seqrec shape in
#: both types, a long sequence, the wide kernels' timed shape (a seqrec
#: model at embed 2,048 and 4 heads) and the huge kernels' (chip_smoke.py's
#: B1 L1024 H2 D4096) in both types
SHAPES = {"train": (8, 4096, 8, 64, "float32"),
          "f32": (4, 4096, 8, 64, "float32"),
          "bf16": (4, 4096, 8, 64, "bfloat16"),
          "long": (1, 16384, 8, 64, "bfloat16"),
          "wide_f32": (2, 2048, 4, 512, "float32"),
          "wide_bf16": (2, 2048, 4, 512, "bfloat16"),
          "huge_f32": (1, 1024, 2, 4096, "float32"),
          "huge_bf16": (1, 1024, 2, 4096, "bfloat16")}
FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]
#: the kernel sources and the header they share
CSRC = kernels.SOURCES[0].parent


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build_renamed(path: Path, name: str, prefix: str, new_prefix: str,
                  argtypes: dict, init: str | None = "init") -> ctypes.CDLL:
    """Build an earlier source as library ``name`` under the build
    directory, its entry points' ``prefix`` renamed ``new_prefix``; give
    each entry in ``argtypes`` (suffix -> ctypes types) an int result and
    call the entry point ``new_prefix + init`` (where the source has
    one). Its ``#include "attn_tiles.cuh"`` finds the current header."""
    from torch.utils.cpp_extension import load

    out = kernels.BUILD_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    src = out / path.name
    src.write_text(path.read_text().replace(prefix, new_prefix))
    lib = ctypes.CDLL(load(name=name, sources=[str(src)],
                           build_directory=str(out), extra_cuda_cflags=FLAGS,
                           extra_include_paths=[str(CSRC)],
                           is_python_module=False, verbose=False))
    for suffix, types in (({init: []} if init else {}) | argtypes).items():
        getattr(lib, new_prefix + suffix).argtypes = types
        getattr(lib, new_prefix + suffix).restype = ctypes.c_int
    err = getattr(lib, new_prefix + init)() if init else 0
    if err:
        raise RuntimeError(f"{path} init failed: cudaError {err}")
    return lib


#: a huge source whose workspace query takes the dtype (the banded backward)
HUGE_WS_DTYPE = re.compile(r"pio_flash_attn_huge_workspace\(int B, int L, "
                           r"int H, int D, int kind,\s*int dtype\)")


def build_old(path: Path, n: int):
    """Build an earlier source as library ``n``: (its kind, ``narrow``,
    ``wide`` or ``huge``, the library, and its entry points' prefix). A
    huge source's entry points take a workspace pointer after the outputs;
    its ``workspace`` entry sizes it (with the dtype as a sixth argument
    where the source takes one)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = path.read_text()
    kind = ("huge" if "pio_flash_attn_huge_bwd_dkv" in text else "wide"
            if "pio_flash_attn_wide_bwd_dkv" in text else "narrow")
    ws = kind == "huge"
    stem = "pio_flash_attn_" + {"narrow": "bwd_", "wide": "wide_bwd_",
                                "huge": "huge_"}[kind]
    prefix = f"pio_old{n}_" + stem[4:]
    entries = {"dkv": [p] * (8 + ws) + [i] * 6 + [f, p],
               "dq": [p] * (7 + ws) + [i] * 6 + [f, p]}
    if ws:
        entries = {f"bwd_{key}": types for key, types in entries.items()}
    lib = build_renamed(path, f"pio_bwd_old{n}", stem, prefix, entries,
                        init=None if ws else "init")
    if ws:
        wsfn = getattr(lib, prefix + "workspace")
        wsfn.argtypes = [i] * (6 if HUGE_WS_DTYPE.search(text) else 5)
        wsfn.restype = ctypes.c_longlong
    return kind, lib, prefix


def old_call(old, dkv: bool, q, k, v, do, lse, di, causal: bool):
    kind, lib, prefix = old
    B, L, H, D = q.shape
    code = kernels._ATTN_DTYPES[q.dtype]
    outs = [torch.empty_like(q) for _ in range(2 if dkv else 1)]
    extra, entry = [], ("dkv" if dkv else "dq")
    if kind == "huge":
        wsfn = getattr(lib, prefix + "workspace")
        nbytes = wsfn(B, L, H, D, 2 if dkv else 1,
                      *([code] if len(wsfn.argtypes) == 6 else []))
        ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        extra, entry = [ws.data_ptr()], "bwd_" + entry
    err = getattr(lib, prefix + entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), *(t.data_ptr() for t in outs),
        *extra, B, L, H, D, code, int(causal), 1.0 / D**0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old kernel launch failed: cudaError {err}")
    return outs


def compare(olds: dict, name: str, card: str, B, L, H, D,
            dtype: str) -> bool:
    """Time the current kernels and each earlier version of their kind in
    ``olds`` (tag -> (kind, lib, prefix)) in turns: olds, new, new, olds
    reversed. Returns whether the gradients held."""
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7 * B * L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=gen, device=dev)
                   .mul_(0.5).to(dt) for _ in range(4))
    lse = torch.empty(B, H, L, device=dev)
    o = kernels.flash_attention_fwd(q, k, v, causal=True, lse=lse)
    di = attention_di(o, do)
    args = (q, k, v, do, lse, di)
    new = {"dkv": lambda: kernels.flash_attention_bwd_dkv(*args, causal=True),
           "dq": lambda: kernels.flash_attention_bwd_dq(*args, causal=True)}
    route = kernels._route(D)
    runs = {tag: {key: (lambda key=key, old=old: old_call(
        old, key == "dkv", *args, causal=True)) for key in new}
        for tag, old in olds.items() if old[0] == route}
    first = next(iter(runs), "plain")
    rec = {"shape": name, "B": B, "L": L, "H": H, "D": D, "dtype": dtype,
           "card": card}
    if route == "wide":
        rec["plans"] = {key: kernels.wide_bwd_plan_on_card(
            B, L, H, D, dt, True, kind) for key, kind in (("dkv", 2),
                                                         ("dq", 1))}
    if route == "huge":
        rec["plans"] = {key: kernels.huge_bwd_plan_on_card(
            B, L, H, D, dt, True, kind) for key, kind in (("dkv", 2),
                                                         ("dq", 1))}
    plain = None if runs else cs.chunked_bwd(q, k, v, o, lse, do,
                                             causal=True)
    big = B * L * L * H >= 1 << 34
    iters, reps = (2, 3) if big else (10, 5)
    if route == "huge":
        rec["plain_ms"] = cs.device_ms(lambda: cs.chunked_bwd(
            q, k, v, o, lse, do, causal=True), iters, reps)
    held = True
    for key in new:
        got = new[key]()
        got = got if isinstance(got, tuple) else (got,)
        want = (runs[first][key]() if runs
                else (plain[1], plain[2]) if key == "dkv" else (plain[0],))
        rec[f"{key}_rel_to_{first}"] = max(cs.rel_err(g, w)
                                           for g, w in zip(got, want))
        again = new[key]()
        again = again if isinstance(again, tuple) else (again,)
        rec[f"{key}_repeat_bitwise"] = all(
            torch.equal(g, a) for g, a in zip(got, again))
        held = (held and rec[f"{key}_repeat_bitwise"]
                and rec[f"{key}_rel_to_{first}"] <= cs.BWD_TOL[dt])
        del got, want, again
        order = [*runs, "new", "new", *reversed(runs)]
        times = {tag: [] for tag in order}
        for tag in order:
            fn = new[key] if tag == "new" else runs[tag][key]
            times[tag].append(cs.device_ms(fn, iters, reps))
        for tag, ts in times.items():
            rec[f"{key}_{tag}_ms"] = ts
        if runs:
            rec[f"{key}_speedup_vs_{first}"] = (sum(times[first])
                                                / sum(times["new"]))
        rec[f"{key}_bound_ms"] = cs.bwd_bound_ms(B, L, H, D, dt, True,
                                                 dkv=key == "dkv")[0]
        rec[f"{key}_share_of_bound"] = (rec[f"{key}_bound_ms"]
                                        / min(times["new"]))
    del plain
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    rec["sdpa_bwd_ms"] = cs.device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters,
        reps)
    rec["held"] = held
    emit(rec)
    return held


#: kernel names: bwd_dkv_*<DP, causal, outputs> and bwd_dq_*<DP, causal>,
#: and the first version's flash_bwd_*<T, DP, causal>
KERNEL = re.compile(r"(bwd_(?:dkv|dq)_(?:f32|bf16)|flash_bwd_(?:dkv|dq))"
                    r"I(?:f|13__nv_bfloat16)?Li(\d+)ELb([01])E(?:Li(\d)E)?")
#: the wide backward's wide_dkv_*<causal> and wide_dq_*<causal> (a
#: 128-feature slice and 64 own rows a CTA)
WIDE_KERNEL = re.compile(r"wide_(dkv|dq)_(f32|bf16)ILb([01])E")
#: the huge kernels' huge_score<T, kind, causal> and huge_product<T, kind,
#: causal> (kind 0 the forward, 1 dQ, 2 dK/dV)
HUGE_KERNEL = re.compile(r"huge_(score|product)I(f|13__nv_bfloat16)"
                         r"Li([012])ELb([01])E")
#: the huge forward's own kernels (attn_fwd_ab.py reports them): its score
#: pass and its softmax pass
HUGE_FWD_KERNEL = re.compile(r"huge_(scoreI(f|13__nv_bfloat16)Li0E|softmax)")


def dyn_smem(kind: str, dp: int) -> int | None:
    """Dynamic shared memory of the current kernels, as csrc/
    flash_attn_bwd.cu's f32_*_floats / bf16_*_bytes compute it."""
    if kind.endswith("_f32"):
        bo, bs = (128 if dp <= 64 else 64), (64 if dp <= 128 else 16)
        sx, sy, bufs = bo + 4, dp + 4, (2 if dp <= 64 else 1)
        floats = 2 * dp * sx + 4 * bs * sy + (
            bufs * bs * sx + 4 * bs if "dkv" in kind else bs * sx)
        return 4 * floats
    if kind.endswith("_bf16"):
        bs, sb = (64 if dp <= 64 else 32 if dp <= 128 else 16), dp + 8
        return (2 * 64 + 4 * bs) * sb * 2 + (4 * bs * 4 if "dkv" in kind
                                             else 0)
    return None


def kernel_resources(src: Path, cubin_name: str) -> dict:
    """Compile ``src`` for sm_90a with ``nvcc -cubin -Xptxas -v``: each
    kernel's mangled name -> its registers, spill and static shared-memory
    bytes, and its ``HMMA`` and ``FFMA`` counts from ``cuobjdump -sass``."""
    cuda = Path("/usr/local/cuda/bin")
    nvcc = shutil.which("nvcc") or str(cuda / "nvcc")
    cuobjdump = shutil.which("cuobjdump") or str(cuda / "cuobjdump")
    out = kernels.BUILD_DIR / "resources"
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / f"{cubin_name}.cubin"
    run = subprocess.run([nvcc, "-cubin", "-O3", "-std=c++17",
                          "-arch=sm_90a", "-Xptxas", "-v", "-I", str(CSRC),
                          "-o", str(cubin), str(src)], capture_output=True,
                         text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc -cubin {src} failed:\n{run.stderr[-4000:]}")
    ptxas = run.stderr
    info, current = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            info[current] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            info[current]["spill_store_bytes"] = int(m.group(1))
            info[current]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            info[current]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and current:
            info[current]["static_smem_bytes"] = int(m.group(1))
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = {"HMMA": 0, "FFMA": 0}
        elif current:
            for op in ("HMMA", "FFMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[current][op] += 1
    return {fn: {**rec, **counts.get(fn, {})} for fn, rec in info.items()}


def resources(src: Path, tag: str) -> None:
    for fn, rec in sorted(kernel_resources(src, tag).items()):
        if HUGE_FWD_KERNEL.search(fn):
            continue
        hg = HUGE_KERNEL.search(fn)
        if hg:
            dtype = torch.float32 if hg.group(2) == "f" else torch.bfloat16
            kind = int(hg.group(3))
            plan = kernels.huge_bwd_plan(*SHAPES["huge_f32"][:4], dtype,
                                         kind)
            emit({"source": tag, "kernel": f"huge_{hg.group(1)}",
                  "dtype": str(dtype), "kind": ("dq", "dkv")[kind - 1],
                  "causal": hg.group(4) == "1", **rec,
                  "dynamic_smem_bytes": plan[hg.group(1)]["smem_bytes"]
                  if src == kernels.SOURCES[5] else None})
            continue
        w = WIDE_KERNEL.search(fn)
        if w:
            dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[w.group(2)]
            plan = kernels.wide_bwd_plan(1, 64, 1, 512, dtype,
                                         2 if w.group(1) == "dkv" else 1)
            emit({"source": tag, "kernel": f"wide_{w.group(1)}_{w.group(2)}",
                  "slice": 128, "own_rows": 64,
                  "stream_rows": plan["stream_rows"],
                  "causal": w.group(3) == "1", **rec,
                  "dynamic_smem_bytes": plan["smem_bytes"]
                  if src == kernels.SOURCES[4] else None})
            continue
        m = KERNEL.search(fn)
        kind, dp, causal = (m.group(1), int(m.group(2)), m.group(3) == "1") \
            if m else (fn, None, None)
        outputs = {"1": "dv", "2": "dk", "3": "dk,dv"}.get(
            m.group(4) if m else None)
        emit({"source": tag, "kernel": kind, "head_dim_pad": dp,
              "causal": causal, **({"outputs": outputs} if outputs else {}),
              **rec,
              "dynamic_smem_bytes": dyn_smem(kind, dp) if dp else None})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--resources", action="store_true")
    ap.add_argument("--old", type=Path, action="append", default=[])
    ap.add_argument("--shapes", default="train,f32,bf16,long")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_bwd_ab: no CUDA device is visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    kernels.build()
    if args.resources:
        resources(kernels.SOURCES[2], "new")
        resources(kernels.SOURCES[4], "wide")
        resources(kernels.SOURCES[5], "huge")
        for path in args.old:
            resources(path, path.stem)
        for D in range(384, kernels.WIDE_MAX_HEAD_DIM + 1, 128):
            for dtype in (torch.float32, torch.bfloat16):
                for kind in (2, 1):
                    emit({"source": "wide", "plan_D": D,
                          "dtype": str(dtype), "kind": kind,
                          **kernels.wide_bwd_plan_on_card(
                              *SHAPES["wide_f32"][:3], D, dtype, True,
                              kind)})
        for dtype in (torch.float32, torch.bfloat16):
            for kind in (2, 1):
                emit({"source": "huge", "dtype": str(dtype), "kind": kind,
                      **kernels.huge_bwd_plan_on_card(
                          *SHAPES["huge_f32"][:4], dtype, True, kind)})
    olds = {path.stem: build_old(path, n) for n, path in enumerate(args.old)}
    held = True
    if args.old or not args.resources:
        for name in args.shapes.split(","):
            held = compare(olds, name, smi, *SHAPES[name]) and held
    return 0 if held else 1

if __name__ == "__main__":
    sys.exit(main())
