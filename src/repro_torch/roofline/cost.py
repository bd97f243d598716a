"""FLOPs and bytes of one step, counted as it runs: the port's
``cost_analysis()``.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions and attention by their formulas; elementwise ops count
  none, as in XLA's count).
- Bytes: every aten op's tensor operands plus its tensor results, summed
  by a ``TorchDispatchMode``: the same per-op sum as XLA's "bytes
  accessed".  A view moves nothing and is not counted; an ``out=`` tensor
  counts as a result only.  Operands that an op reads from cache count
  all the same: this is the traffic the ops ask for, not what HBM served.

The hand-written kernels launch through ``ctypes``, below the dispatcher,
so neither count sees them.  :class:`StepCost` names the kernels that
launched during the counted step (``kernels.runtime``'s launch counters),
so a reader knows what the counts leave out; their work is not guessed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .model import RooflineReport


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums operand and result bytes of every aten op run under it."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            operands = {k: v for k, v in kwargs.items() if k != "out"}
            self.bytes += _nbytes((args, operands)) + _nbytes(out)
            self.ops += 1
        return out


@dataclass
class StepCost:
    """One counted step: ``flops`` and ``bytes`` of its aten ops, the
    number of ops, and the hand-written kernels that launched in it (name
    -> launches), whose work neither count includes."""

    flops: float
    bytes: float
    ops: int
    kernel_launches: Dict[str, int] = field(default_factory=dict)

    def report(self, arch: str, shape: str, dtype: str, *,
               model_flops_total: Optional[float] = None) -> RooflineReport:
        """The roofline of this step on one card, its compute path the
        dtype's.  A step over several devices builds its
        :class:`RooflineReport` directly."""
        return RooflineReport(
            arch=arch, shape=shape, mesh="single", n_devices=1,
            hlo_flops_per_dev=self.flops, hlo_bytes_per_dev=self.bytes,
            coll_bytes_per_dev=0.0, model_flops_total=model_flops_total,
            dtype=dtype)

def count_step(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), StepCost)``: the call run once with its
    FLOPs, bytes and kernel launches counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels.runtime import launch_counters

    wrappers = launch_counters()
    before = {name: w.launches for name, w in wrappers.items()}
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        out = fn(*args, **kwargs)
    launched = {name: w.launches - before[name] for name, w in wrappers.items()}
    return out, StepCost(flops=float(flops.get_total_flops()), bytes=float(nbytes.bytes),
                         ops=nbytes.ops,
                         kernel_launches={k: v for k, v in launched.items() if v})


__all__ = ["ByteCounter", "StepCost", "count_step"]
