"""The "simt" route's ring depth, ring budget and chunk size, measured.

Builds a copy of ``csrc/flash_decode.cu`` for each ``--variants`` entry
(``stages:ring_bytes``: the copy's ``simt::kStages`` and ``kRingBytes``
set to them; every build started together), and optionally a
``--baseline`` source of the same C interface as it stands, then times
``flash_decode_launch`` at the CUDA-core shapes of ``chip_smoke.py``'s
phase 7 and phase 13 (Qwen3-32B's f32 heads, Qwen2.5-14B's, Gemma-2-27B's
with and without softcap 50, granite's serve cache, Qwen3-32B's long
cache at batch 1) for each variant and each of ``--chunks`` cache rows per
block.  Every call is checked against the plain version at rtol 2e-4,
atol 2e-5; times are CUDA-graph replays (``probe_chunks.replay_ms``).  One
JSON line per (shape, build, chunk) with the bound (K/V bytes over 3.35
TB/s) and its share; the registers each build's kernels use last.  Needs
the card::

    PYTHONPATH=src python -m repro_torch.kernels.flash_decode.probe_simt \\
        [--variants 3:135168,2:90112] [--chunks 256,512,1024] [--baseline old.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from ..runtime import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from .probe_chunks import replay_ms
from .ref import flash_decode_ref

HBM_BYTES_PER_S = 3.35e12

# name: (B, S, KV, G, dh, kv_len, softcap), all f32 K/V
SHAPES = {
    "f32_dh80": (2, 32768, 8, 8, 80, (8169, 17125), None),
    "f32_seeded": (4, 32768, 8, 5, 128, (29238, 9178, 8574, 15111), None),
    "f32_dh144": (2, 32768, 16, 2, 144, (29328, 3989), None),
    "f32_dh144_softcap": (2, 32768, 16, 2, 144, (29328, 3989), 50.0),
    "granite_serve": (4, 128, 8, 3, 64, (64, 64, 64, 64), None),
    "qwen3_long_b1": (1, 32768, 8, 8, 80, (32760,), None),
}


RING = re.compile(r"constexpr int kStages = \d+;(\s*//[^\n]*\n)constexpr int kRingBytes = \d+;")


def variant(stages: int, ring_bytes: int, out: Path) -> Path:
    """A copy of csrc/flash_decode.cu at ``out`` whose CUDA-core kernel has
    ``stages`` ring stages in ``ring_bytes`` bytes."""
    text, n = RING.subn(lambda m: f"constexpr int kStages = {stages};{m.group(1)}"
                                  f"constexpr int kRingBytes = {ring_bytes};",
                        (CSRC / "flash_decode.cu").read_text())
    if n != 1:
        raise RuntimeError(f"flash_decode.cu: {n} simt ring definitions, want 1")
    out.write_text(text)
    return out


def build(source: Path, out: Path) -> subprocess.Popen:
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def registers(log: str) -> dict:
    """The registers of each CUDA-core split kernel instantiation in a
    ptxas log, by the template part of its mangled name."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"(?:simt|split)_kernelI\w*?EEv", m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name.group(0)] = int(m.group(1))
    return regs


def launcher(lib: ctypes.CDLL):
    fn = lib.flash_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, kv_len, chunk, softcap):
        b, kv, g, dh = q.shape
        n_chunks = -(-k.shape[1] // chunk)
        f32 = dict(dtype=torch.float32, device=q.device)
        pacc = torch.empty((b, kv, n_chunks, g, dh), **f32)
        pm = torch.empty((b, kv, n_chunks, g), **f32)
        pl = torch.empty((b, kv, n_chunks, g), **f32)
        out = torch.empty((b, kv, g, dh), **f32)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), pacc.data_ptr(),
                 pm.data_ptr(), pl.data_ptr(), out.data_ptr(), None, None, b, k.shape[1], kv, g,
                 dh, chunk, 0, softcap or 0.0, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_decode_launch returned {err}")
        return out

    return call


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default="3:135168")
    ap.add_argument("--chunks", default="512")
    ap.add_argument("--baseline", default=None, help="a flash_decode.cu to time at chunk 512")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_simt needs a CUDA device")
    out_dir = BUILD_DIR.parent / "probe_simt"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for v in args.variants.split(","):
        stages, ring = (int(x) for x in v.split(":"))
        name = f"stages{stages}_ring{ring}"
        builds[name] = variant(stages, ring, out_dir / f"{name}.cu")
    if args.baseline:
        builds["baseline"] = Path(args.baseline).resolve()
    procs = {name: build(src, out_dir / f"lib{name}.so") for name, src in builds.items()}
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = launcher(ctypes.CDLL(str(out_dir / f"lib{name}.so")))
        regs[name] = registers(log)
    chunks = [int(c) for c in args.chunks.split(",")]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for shape, (b, s, kv, g, dh, lens, cap) in SHAPES.items():
        q = torch.randn((b, kv, g, dh), generator=gen, device="cuda")
        k = torch.randn((b, s, kv, dh), generator=gen, device="cuda")
        v = torch.randn((b, s, kv, dh), generator=gen, device="cuda")
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = flash_decode_ref(q, k, v, kv_len, softcap=cap)
        live = sum(min(n, s) for n in lens)
        bound_ms = (2 * live * kv * dh * 4 + 8 * q.numel() + 4 * b) / HBM_BYTES_PER_S * 1e3
        for name, call in libs.items():
            for chunk in [512] if name == "baseline" else chunks:
                got = call(q, k, v, kv_len, chunk, cap)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
                ms = replay_ms(lambda: call(q, k, v, kv_len, chunk, cap))
                print(json.dumps({"probe": "flash_decode_simt", "shape": shape, "build": name,
                                  "chunk": chunk, "ms": ms, "bound_ms": bound_ms,
                                  "bound_share": bound_ms / ms,
                                  "max_abs_err": float((got - want).abs().max())}))
        del q, k, v, want
        torch.cuda.empty_cache()
    print(json.dumps({"probe": "flash_decode_simt_registers", "registers": regs}))


if __name__ == "__main__":
    main()
