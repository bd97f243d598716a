"""Device policy and the CUDA kernel build for the port.

- :func:`has_cuda` / :func:`is_hopper` / :func:`default_device` /
  :func:`require_accelerator` — where tensors live.  The port runs on the
  CUDA card unless a caller asks for the CPU; without a card and without an
  explicit device the store refuses to start instead of quietly running on
  the host.
- :func:`kernel_lib` — the hand-written kernels in ``csrc/*.cu`` are built
  with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository
  root on first use (one ``nvcc`` per source, all started together), keyed
  by a hash of the sources and flags, and loaded with ``ctypes``.  Each
  source exports plain C launch functions that return the ``cudaError_t``
  of the launch; :func:`check` raises on a non-zero one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def has_cuda() -> bool:
    return torch.cuda.is_available()


def is_hopper() -> bool:
    """True when device 0 is a Hopper card (compute capability 9.0)."""
    return has_cuda() and torch.cuda.get_device_capability(0) == (9, 0)


def default_device() -> torch.device:
    """The card; raises when there is none (callers may pass ``"cpu"``)."""
    if not has_cuda():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the port on "
            "the host"
        )
    return torch.device("cuda")


def require_accelerator(context: str) -> None:
    """Fail loudly when a device measurement would run on the host."""
    if not has_cuda():
        raise RuntimeError(f"{context}: torch sees no CUDA device")


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put it on PATH)")


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


_LIBS: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet (in
    parallel, one ``nvcc`` each) and load them all; idempotent."""
    with _build_lock:
        if _LIBS:
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {}
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            out = BUILD_DIR / f"lib{src.stem}_{_digest(src)}.so"
            targets[src.stem] = out
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        errors = []
        for src, tmp, out, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        _LIBS.update({name: ctypes.CDLL(str(p)) for name, p in targets.items()})
        return _LIBS


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds on first use)."""
    libs = build_all()
    if name not in libs:
        raise RuntimeError(f"no kernel source csrc/{name}.cu")
    return libs[name]


@functools.lru_cache(maxsize=None)
def kernel_fn(name: str, symbol: str, argtypes: str):
    """The C launch function ``symbol`` of ``csrc/<name>.cu`` with its
    ctypes signature; ``argtypes`` spells it as ``p`` (pointer or stream),
    ``i`` (int), ``l`` (long long) and ``f`` (float) — every pointer as a
    64-bit ``c_void_p``, never the 32-bit default.  Returns the ``cudaError_t``.
    Cached: the libraries stay loaded for the life of the process."""
    fn = getattr(kernel_lib(name), symbol)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
             "f": ctypes.c_float}
    fn.argtypes = [kinds[c] for c in argtypes]
    fn.restype = ctypes.c_int
    return fn


def on_cpu(t: torch.Tensor, what: str) -> bool:
    """Kernel dispatch: True for a CPU tensor (plain version), False for a
    CUDA tensor (hand-written kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (under a lock: readers on several
    threads launch through the same wrapper)."""
    with _count_lock:
        wrapper.launches += 1


def launch_counters() -> Dict[str, object]:
    """Every hand-written kernel's wrapper by name; each counts its own
    launches in ``.launches``."""
    from .embedding_bag import embedding_bag
    from .flash_decode import flash_decode
    from .intersect import intersect_count
    from .leaf_search import leaf_search
    from .spmm import leaf_scan_reduce, leaf_spmm

    return {"leaf_search": leaf_search, "leaf_scan_reduce": leaf_scan_reduce,
            "leaf_spmm": leaf_spmm, "intersect_count": intersect_count,
            "embedding_bag": embedding_bag, "flash_decode": flash_decode}


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def cuda_input(t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str) -> torch.Tensor:
    """Validate a kernel operand: CUDA, ``dtype``, ``ndim``; made contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    return t.contiguous()


__all__ = [
    "build_all",
    "check",
    "count_launch",
    "cuda_input",
    "default_device",
    "has_cuda",
    "is_hopper",
    "kernel_fn",
    "kernel_lib",
    "launch_counters",
    "on_cpu",
    "require_accelerator",
    "stream_ptr",
]
