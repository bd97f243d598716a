"""Checkpointing with async host writes + restart recovery.

Layout (one directory per step):
    ckpt_dir/step_000123/
        meta.json            — step, the leaf keys in save order, ``extra``
        arrays/<leaf>.npy    — one file per leaf
        _COMPLETE            — commit marker written last (atomic rename)

The file format is the reference's (:mod:`repro.checkpoint.manager`) byte
for byte: the same keys (``"a/b"`` for dict entries, ``"0"`` for list and
tuple positions, ``".mu"`` for a ``NamedTuple``'s field ``mu``, dict
keys sorted), the same key order in ``meta.json``,
and bf16/fp8 leaves widened to f32 — so either package restores what the
other saved.  Leaves are torch tensors or numpy arrays (or Python scalars);
tensors are written from a detached host copy.

Fault-tolerance contract: a crash mid-write leaves no _COMPLETE marker, so
``latest_step`` skips it; ``restore`` always loads the newest committed
checkpoint.  ``AsyncCheckpointer`` snapshots tensors to host memory
synchronously (cheap) and writes files on a background thread, overlapping
the save with subsequent training steps.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# dtypes np.save cannot store natively (ml_dtypes / torch narrow floats):
# widened to f32 in the file, cast back by restore()
_NARROW_NAMES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")
_NARROW_TORCH = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _child_keys(tree) -> List[str]:
    """The path key of each entry of a list or tuple, in order: ``".f"`` for
    a ``NamedTuple``'s field ``f`` (the ``str`` of JAX's ``GetAttrKey``),
    else the index."""
    if _is_namedtuple(tree):
        return ["." + f for f in type(tree)._fields]
    return [str(i) for i in range(len(tree))]


def _walk(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf)]`` in JAX's flatten order: dict keys sorted, list and
    tuple entries (``NamedTuple`` fields too) in order, ``None`` an empty
    subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_walk(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for key, sub in zip(_child_keys(tree), tree):
            out.extend(_walk(sub, path + (key,)))
        return out
    return [(path, tree)]


def _rebuild(template, fn: Callable[[Tuple[str, ...], Any], Any],
             path: Tuple[str, ...] = ()):
    """``template``'s structure with every leaf replaced by ``fn(path, leaf)``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, fn, path + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [_rebuild(v, fn, path + (key,))
                 for key, v in zip(_child_keys(template), template)]
        if _is_namedtuple(template):
            return type(template)(*items)
        return type(template)(items) if isinstance(template, tuple) else items
    return fn(path, template)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _NARROW_TORCH:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name in _NARROW_NAMES:
        # np.save stores ml_dtypes as raw void — widen for the file format
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): _to_host(leaf) for path, leaf in _walk(tree)}


def save(ckpt_dir: str | Path, step: int, tree: Any, extra: Optional[Dict] = None) -> Path:
    """Synchronous committed save. Returns the checkpoint path."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"_tmp_step_{step:09d}"
    final = ckpt_dir / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    leaves = _flatten(tree)
    for key, arr in leaves.items():
        fn = key.replace("/", "__") + ".npy"
        np.save(tmp / "arrays" / fn, arr)
    meta = {
        "step": step,
        "keys": list(leaves.keys()),
        "extra": extra or {},
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / "_COMPLETE").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.glob("step_*"):
        if (p / "_COMPLETE").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _step_path(ckpt_dir: Path, step: Optional[int]) -> Path:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    return ckpt_dir / f"step_{step:09d}"


def restore(ckpt_dir: str | Path, template: Any, step: Optional[int] = None):
    """Restore into the structure of ``template`` (shapes must match).

    A tensor leaf comes back as a tensor of the template's dtype on the
    template's device (narrow floats cast back through torch); any other
    leaf comes back as a numpy array of the template's dtype.
    """
    path = _step_path(Path(ckpt_dir), step)
    meta = json.loads((path / "meta.json").read_text())

    def _load(keypath, leaf):
        key = "/".join(keypath)
        arr = np.load(path / "arrays" / (key.replace("/", "__") + ".npy"))
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(
                f"shape mismatch for {key}: {arr.shape} vs {tuple(np.shape(leaf))}"
            )
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        want = np.asarray(leaf).dtype
        return arr if arr.dtype == want else arr.astype(want)

    return _rebuild(template, _load), meta


def restore_raw(ckpt_dir: str | Path, step: Optional[int] = None):
    """Template-free restore: ``({key: array}, meta)`` straight off disk.

    Loads every leaf recorded in ``meta.json``'s key list at their saved
    shapes and dtypes — for consumers that don't know the structure up
    front (``RapidStore.recover`` reads its edge arrays this way; the saved
    ``extra`` dict carries the store config).
    """
    path = _step_path(Path(ckpt_dir), step)
    meta = json.loads((path / "meta.json").read_text())
    arrays = {
        key: np.load(path / "arrays" / (key.replace("/", "__") + ".npy"))
        for key in meta["keys"]
    }
    return arrays, meta


def prune(ckpt_dir: str | Path, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(
        int(p.name.split("_")[1])
        for p in ckpt_dir.glob("step_*")
        if (p / "_COMPLETE").exists()
    )
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)


def _host_snapshot(_path, leaf):
    # a copy even for host tensors/arrays: training mutates them in place
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training: snapshot now, write later."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()  # one in flight at a time
        host_tree = _rebuild(tree, _host_snapshot)  # device->host snapshot

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                prune(self.ckpt_dir, self.keep)
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
