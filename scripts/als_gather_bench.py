"""The ALS half-step's gather and gramian on one card, each torch form timed.

    python3 scripts/als_gather_bench.py

At block shapes of the ML-20M layout (rank 64: a user-side block of
8,192 rows x 136 neighbours gathering from the 26,800-slot item factor
table, and two item-side shapes gathering from the 138,576-slot user
table, one of them a chunk 2,048 wide), it times every
PyTorch way to gather factor rows into a ``[B, D, R]`` f32 block —
``index_select`` with int32 and int64 ids, advanced indexing,
``embedding``, ``gather`` on an expanded index, and ``index_select`` on
complex128 and int64 views of the same rows — beside a fill of the same
bytes (the write rate the card can reach) and the block's gramian
``torch.bmm(f.T, f)``. Ids are uniform over the table, drawn from a fixed
seed. Every gather must equal ``index_select``'s bitwise. CUDA-event
medians; one JSON object a line; exits non-zero without a card or on a
mismatch.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

#: (table slots, block rows, neighbours): a user-side block, then a
#: chunk-wide and a typical item-side block of the ML-20M layout
SHAPES = ((26_800, 8192, 136), (138_576, 1000, 2048), (138_576, 8192, 200))
RANK = 64


def device_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` calls,
    the host queued ahead behind a device-side sleep."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("als_gather_bench: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for slots, b, d in SHAPES:
        table = torch.randn(slots, RANK, device=dev, generator=gen)
        ids32 = torch.randint(0, slots, (b * d,), device=dev, generator=gen,
                              dtype=torch.int32)
        ids64 = ids32.long()
        gathers = {
            "index_select_int32": lambda: table.index_select(0, ids32),
            "index_select_int64": lambda: table.index_select(0, ids64),
            "advanced_index": lambda: table[ids64],
            "embedding": lambda: torch.nn.functional.embedding(ids64, table),
            "gather_expand": lambda: torch.gather(
                table, 0, ids64[:, None].expand(-1, RANK)),
            "index_select_complex128_view": lambda: table.view(
                torch.complex128).index_select(0, ids32),
            "index_select_int64_view": lambda: table.view(
                torch.int64).index_select(0, ids32),
        }
        want = table.index_select(0, ids32)
        for name, fn in gathers.items():
            got = fn()
            if got.dtype != torch.float32:
                got = got.view(torch.float32)
            if not torch.equal(got.reshape(want.shape), want):
                print(f"als_gather_bench: {name} differs", file=sys.stderr)
                return 1
        f = want.view(b, d, RANK)
        timed = dict(gathers)
        timed["fill_same_bytes"] = lambda: torch.empty_like(want).fill_(1.0)
        timed["gramian_bmm"] = lambda: torch.bmm(f.transpose(1, 2), f)
        nbytes = b * d * RANK * 4
        for name, fn in timed.items():
            ms = device_ms(fn)
            print(json.dumps({"slots": slots, "B": b, "D": d, "case": name,
                              "ms": ms, "gbytes_written_per_s":
                                  nbytes / ms / 1e6,
                              "rows_per_s": b * d / ms * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
