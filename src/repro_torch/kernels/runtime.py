"""Device policy and the CUDA kernel build for the port.

- :func:`has_cuda` / :func:`is_hopper` / :func:`default_device` /
  :func:`require_accelerator` — where tensors live.  The port runs on the
  CUDA card unless a caller asks for the CPU; without a card and without an
  explicit device the store refuses to start instead of quietly running on
  the host.
- :func:`kernel_lib` — the hand-written kernels in ``csrc/*.cu`` are built
  with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository
  root on first use, keyed by a hash of the source and flags, and loaded
  with ``ctypes``: :func:`kernel_lib` builds the one source it is asked
  for, :func:`build_all` every source (one ``nvcc`` each, all started
  together).  Each source exports plain C launch functions that return
  the ``cudaError_t`` of the launch; :func:`check` raises on a non-zero
  one.
- :func:`check_operands` / :func:`launch_on` — a wrapper checks that its
  operands share one card, then launches under that card (entered, so
  the launch goes there and not to the current card); :func:`count_launch`
  counts each launch per wrapper and per card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # a source's kernels optimized on every core: flash_decode.cu took 41 s, not
    # 79 s, on the 8-core host of an H100
    "-split-compile=0",
)


def has_cuda() -> bool:
    return torch.cuda.is_available()


def is_hopper() -> bool:
    """True when device 0 is a Hopper card (compute capability 9.0)."""
    return has_cuda() and torch.cuda.get_device_capability(0) == (9, 0)


def default_device() -> torch.device:
    """The current card, indexed (``cuda:k``); raises when there is none
    (callers may pass ``"cpu"``)."""
    if not has_cuda():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the port on "
            "the host"
        )
    return torch.device("cuda", torch.cuda.current_device())


def indexed(device) -> torch.device:
    """``device`` as a ``torch.device`` with its card's index: a bare
    ``"cuda"`` becomes the current card (inside ``torch.cuda.device(k)``,
    card k), so stores, shards and meshes name the card they hold.  Where
    torch sees no card the device stays as given, for the caller to
    refuse."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and has_cuda():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def drain(devices: Optional[Iterable] = None) -> None:
    """Wait for every CUDA card of ``devices`` (default: every visible
    card) to finish its queued work; CPU devices need nothing."""
    if devices is None:
        cards = range(torch.cuda.device_count()) if has_cuda() else ()
    else:
        cards = sorted({indexed(d).index for d in devices if torch.device(d).type == "cuda"})
    for k in cards:
        torch.cuda.synchronize(k)


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


def _build(sources) -> None:
    """Compile each of ``sources`` that has no up-to-date library yet (in
    parallel, one ``nvcc`` each) and load them all into ``_LIBS``; the
    caller holds ``_build_lock``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {}
    procs = []
    for src in sources:
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


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet and
    load them all; idempotent."""
    with _build_lock:
        _build([src for src in sorted(CSRC.glob("*.cu")) if src.stem not in _LIBS])
        return _LIBS


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``; on first use it
    builds that one source alone, so a caller of one kernel does not wait
    for every kernel's ``nvcc``."""
    with _build_lock:
        if name not in _LIBS:
            src = CSRC / f"{name}.cu"
            if not src.exists():
                raise RuntimeError(f"no kernel source csrc/{name}.cu")
            _build([src])
        return _LIBS[name]


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
_card_launches: Counter = Counter()  # card index -> launches of every wrapper


def count_launch(wrapper, device: torch.device) -> None:
    """Add one to ``wrapper.launches`` and to the launches on ``device``'s
    card (under a lock: readers on several threads launch through the same
    wrapper)."""
    with _count_lock:
        wrapper.launches += 1
        _card_launches[device.index] += 1


def card_launches() -> Dict[int, int]:
    """Launches of every hand-written kernel per card index since the last
    :func:`reset_launches`."""
    with _count_lock:
        return dict(_card_launches)


def reset_launches(wrappers: Optional[Dict[str, int]] = None,
                   cards: Optional[Dict[int, int]] = None) -> None:
    """Every wrapper's count and every card's count to 0, or to the counts
    of ``wrappers`` (by name) and ``cards`` (by index) where given."""
    with _count_lock:
        for name, w in launch_counters().items():
            w.launches = (wrappers or {}).get(name, 0)
        _card_launches.clear()
        _card_launches.update(cards or {})


def launch_counters() -> Dict[str, object]:
    """Every hand-written kernel's wrapper by name; each counts its own
    launches in ``.launches``."""
    from .embedding_bag import embedding_bag
    from .flash_decode import flash_decode
    from .intersect import intersect_count
    from .leaf_search import leaf_search
    from .relax import edge_relax
    from .spmm import leaf_scan_reduce, leaf_spmm

    return {"leaf_search": leaf_search, "leaf_scan_reduce": leaf_scan_reduce,
            "leaf_spmm": leaf_spmm, "intersect_count": intersect_count,
            "embedding_bag": embedding_bag, "flash_decode": flash_decode,
            "edge_relax": edge_relax}


def check_operands(what: str, primary: torch.Tensor, *operands) -> None:
    """Raise ValueError, naming the devices, unless every tensor operand
    lies on ``primary``'s device.  Host data (numpy arrays, CPU tensors)
    beside a card's ``primary`` is the wrapper's to upload; ``None`` and
    non-tensor operands are skipped.  Called before anything is moved, so
    a card's tensor never crosses to another card or the host unseen."""
    dev = primary.device
    others = {t.device for t in operands if isinstance(t, torch.Tensor)
              and t.device != dev and not (dev.type == "cuda" and t.device.type == "cpu")}
    if others:
        raise ValueError(f"{what}: operands on {sorted(map(str, others | {dev}))}; a "
                         f"kernel launches on one device, here {dev}")


def launch_on(device: torch.device):
    """The context a hand-written kernel for ``device`` launches under:
    that card entered, so the launch (on its current stream) goes to the
    tensor's card and not to the current one."""
    return torch.cuda.device(device)


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
    "card_launches",
    "check",
    "check_operands",
    "count_launch",
    "cuda_input",
    "default_device",
    "drain",
    "has_cuda",
    "indexed",
    "is_hopper",
    "kernel_fn",
    "kernel_lib",
    "launch_counters",
    "launch_on",
    "on_cpu",
    "require_accelerator",
    "reset_launches",
    "stream_ptr",
]
