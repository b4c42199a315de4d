"""The attention backward kernels on one card: timed against earlier
versions of their source, and as the compiler built them.

    python3 scripts/attn_bwd_ab.py [--resources] [--old OLD.cu ...]
                                   [--shapes train,f32,bf16,long]

``--old`` (repeatable) names an earlier ``flash_attn_bwd.cu``, for example
``git show <rev>:predictionio_tpu_torch/csrc/flash_attn_bwd.cu`` written
under ``predictionio_tpu_torch/_build/``. Each is built beside the current
kernels with its entry points renamed, and at each of ``--shapes`` (causal
attention, H8 D64) all versions are timed in turns (olds, new, new, olds
reversed) with CUDA events, the new gradients held against the first old
version's, next to the backward of ``scaled_dot_product_attention`` as a
yardstick. ``--resources`` compiles ``csrc/flash_attn_bwd.cu`` (and each
``--old``) with ``nvcc -cubin -Xptxas -v`` for sm_90a and prints each
kernel's registers, spill bytes and dynamic shared memory, and its
``HMMA`` and ``FFMA`` counts from ``cuobjdump -sass``. One JSON object a
line; exits non-zero without a card.
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

SHAPES = {"train": (8, 4096, 8, 64, "float32"),
          "f32": (4, 4096, 8, 64, "float32"),
          "bf16": (4, 4096, 8, 64, "bfloat16"),
          "long": (1, 16384, 8, 64, "bfloat16")}
FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build_old(path: Path, n: int):
    """Build an earlier source as library ``n``: (lib, entry prefix)."""
    from torch.utils.cpp_extension import load

    out = kernels.BUILD_DIR / f"ab_old{n}"
    out.mkdir(parents=True, exist_ok=True)
    prefix = f"pio_old{n}_flash_attn_bwd_"
    src = out / "flash_attn_bwd_old.cu"
    src.write_text(path.read_text().replace("pio_flash_attn_bwd_", prefix))
    lib = ctypes.CDLL(load(name=f"pio_bwd_old{n}", sources=[str(src)],
                           build_directory=str(out), extra_cuda_cflags=FLAGS,
                           is_python_module=False, verbose=False))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    getattr(lib, prefix + "init").restype = i
    getattr(lib, prefix + "dkv").argtypes = [p] * 8 + [i] * 6 + [f, p]
    getattr(lib, prefix + "dkv").restype = i
    getattr(lib, prefix + "dq").argtypes = [p] * 7 + [i] * 6 + [f, p]
    getattr(lib, prefix + "dq").restype = i
    err = getattr(lib, prefix + "init")()
    if err:
        raise RuntimeError(f"{path} init failed: cudaError {err}")
    return lib, prefix


def old_call(old, dkv: bool, q, k, v, do, lse, di, causal: bool):
    lib, prefix = old
    B, L, H, D = q.shape
    outs = [torch.empty_like(q) for _ in range(2 if dkv else 1)]
    err = getattr(lib, prefix + ("dkv" if dkv else "dq"))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), *(t.data_ptr() for t in outs), B, L,
        H, D, kernels._ATTN_DTYPES[q.dtype], int(causal), 1.0 / D**0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old kernel launch failed: cudaError {err}")
    return outs


def compare(olds: dict, name: str, card: str, B, L, H, D,
            dtype: str) -> None:
    """Time the current kernels and each earlier version in ``olds`` (tag
    -> (lib, prefix)) in turns: olds, new, new, olds reversed."""
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
    runs = {tag: {key: (lambda key=key, old=old: old_call(
        old, key == "dkv", *args, causal=True)) for key in new}
        for tag, old in olds.items()}
    first = next(iter(olds))
    rec = {"shape": name, "B": B, "L": L, "H": H, "D": D, "dtype": dtype,
           "card": card}
    big = B * L * L * H >= 1 << 34
    iters, reps = (2, 3) if big else (10, 5)
    for key in new:
        got, want = new[key](), runs[first][key]()
        got = got if isinstance(got, tuple) else (got,)
        rec[f"{key}_rel_to_{first}"] = max(cs.rel_err(g, w)
                                           for g, w in zip(got, want))
        order = [*olds, "new", "new", *reversed(olds)]
        times = {tag: [] for tag in order}
        for tag in order:
            fn = new[key] if tag == "new" else runs[tag][key]
            times[tag].append(cs.device_ms(fn, iters, reps))
        for tag, ts in times.items():
            rec[f"{key}_{tag}_ms"] = ts
        rec[f"{key}_speedup_vs_{first}"] = (sum(times[first])
                                            / sum(times["new"]))
        rec[f"{key}_bound_ms"] = cs.bwd_bound_ms(B, L, H, D, dt, True,
                                                 dkv=key == "dkv")[0]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    rec["sdpa_bwd_ms"] = cs.device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters,
        reps)
    emit(rec)


KERNEL = re.compile(r"(bwd_(?:dkv|dq)_(?:f32|bf16)|flash_bwd_(?:dkv|dq))"
                    r"I(?:f|13__nv_bfloat16)?Li(\d+)ELb([01])E")


def dyn_smem(kind: str, dp: int) -> int | None:
    """Dynamic shared memory of the current kernels, as csrc/
    flash_attn_bwd.cu's f32_*_floats / bf16_*_bytes compute it."""
    if kind.endswith("_f32"):
        bo = 128 if dp <= 64 else 64
        sx, sy, bufs = bo + 4, dp + 4, (2 if dp <= 64 else 1)
        floats = 2 * dp * sx + 4 * 64 * sy + (
            bufs * 64 * sx + 4 * 64 if "dkv" in kind else 64 * sx)
        return 4 * floats
    if kind.endswith("_bf16"):
        bs, sb = (64 if dp <= 64 else 32), dp + 8
        return (2 * 64 + 4 * bs) * sb * 2 + (4 * bs * 4 if "dkv" in kind
                                             else 0)
    return None


def resources(src: Path, tag: str) -> None:
    cuda = Path("/usr/local/cuda/bin")
    nvcc = shutil.which("nvcc") or str(cuda / "nvcc")
    cuobjdump = shutil.which("cuobjdump") or str(cuda / "cuobjdump")
    out = kernels.BUILD_DIR / "resources"
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / f"{tag}.cubin"
    run = subprocess.run([nvcc, "-cubin", "-O3", "-std=c++17",
                          "-arch=sm_90a", "-Xptxas", "-v", "-o", str(cubin),
                          str(src)], capture_output=True, text=True)
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
    for fn, rec in sorted(info.items()):
        m = KERNEL.search(fn)
        kind, dp, causal = (m.group(1), int(m.group(2)), m.group(3) == "1") \
            if m else (fn, None, None)
        emit({"source": tag, "kernel": kind, "head_dim_pad": dp,
              "causal": causal, **rec,
              "dynamic_smem_bytes": dyn_smem(kind, dp) if dp else None,
              **counts.get(fn, {})})


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
        for path in args.old:
            resources(path, path.stem)
    if args.old:
        olds = {path.stem: build_old(path, n)
                for n, path in enumerate(args.old)}
        for name in args.shapes.split(","):
            compare(olds, name, smi, *SHAPES[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
