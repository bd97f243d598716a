"""Cache rows per block of ``flash_decode``'s tensor-core route, measured.

Times the "mma" route with ``ops.MMA_CHUNK_ROWS`` set to each of 512,
1024, 2048 and 4096 at the decode_32k path of Qwen2.5-14B (4 rows of
32,761 live positions of a 32,768-position bf16 cache, 8 KV heads, G=5,
dh=128) and at seeded live lengths on the same cache, each call checked
against the plain version at rtol 2e-4, atol 2e-5.  One JSON line per
shape; needs the card::

    PYTHONPATH=src python -m repro_torch.kernels.flash_decode.probe_chunks [--seed 0]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import ops
from .ref import flash_decode_ref

CHUNKS = (512, 1024, 2048, 4096)


def replay_ms(fn, reps: int = 50, calls: int = 5) -> float:
    """Mean device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph, the replay timed ``calls`` times with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_chunks needs a CUDA device")
    b, s, kv, g, dh = 4, 32768, 8, 5, 128
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q = torch.randn((b, kv, g, dh), generator=gen, device="cuda")
    k = torch.randn((b, s, kv, dh), generator=gen, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((b, s, kv, dh), generator=gen, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(args.seed)
    lengths = {"path": torch.full((b,), s - 7, dtype=torch.int32, device="cuda"),
               "seeded": torch.from_numpy(rng.integers(1, s + 1, b).astype(np.int32)).cuda()}
    default = ops.MMA_CHUNK_ROWS
    try:
        for name, kv_len in lengths.items():
            want = flash_decode_ref(q, k, v, kv_len)
            ms = {}
            for rows in CHUNKS:
                ops.MMA_CHUNK_ROWS = rows
                torch.testing.assert_close(ops.flash_decode(q, k, v, kv_len), want,
                                           rtol=2e-4, atol=2e-5)
                ms[rows] = replay_ms(lambda: ops.flash_decode(q, k, v, kv_len))
            print(json.dumps({"probe": "flash_decode_chunk_rows", "shape": name,
                              "kv_len": kv_len.tolist(), "default": default, "ms": ms}))
    finally:
        ops.MMA_CHUNK_ROWS = default


if __name__ == "__main__":
    main()
