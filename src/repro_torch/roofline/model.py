"""Three-term roofline model for one NVIDIA H100 SXM.

    compute term    = step FLOPs        / peak FLOP/s of the step's compute path
    memory term     = step bytes        / 3.35e12 B/s HBM3
    collective term = collective bytes  / link rate (default NVLink 4)

The peaks are the NVIDIA H100 SXM data sheet's (dense rates, at the full
700 W power limit; a card set below it runs slower under load):

- HBM3: 3.35 TB/s;
- f32 on the CUDA cores: 67 TFLOP/s (what torch's f32 matmuls run at,
  TF32 being off by default);
- dense bf16 (and f16) on the tensor cores: 989 TFLOP/s;
- NVLink 4: 900 GB/s bidirectional, 450 GB/s each way: the default link
  rate, since no run has seen a second card.

The terms take per-device FLOPs and bytes (:mod:`.cost` counts one step
of one process; :mod:`.comm` counts per-device collective bytes), so they
divide by one card's peaks.  MODEL_FLOPS = 6 N D (dense) or 6 N_active D
(MoE) measures how much of the counted compute is useful.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

HBM_BW = 3.35e12  # bytes/s, HBM3, H100 SXM data sheet
CUDA_CORE_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
TENSOR_CORE_BF16_FLOPS = 989e12  # dense bf16/f16 on the tensor cores, H100 SXM data sheet
NVLINK_BW = 450e9  # bytes/s each way, NVLink 4 (900 GB/s bidirectional), H100 SXM data sheet

# FLOP/s of each compute path
PEAK_FLOPS = {"cuda_core": CUDA_CORE_F32_FLOPS, "tensor_core": TENSOR_CORE_BF16_FLOPS}
# the path a step of each dtype takes: bf16/f16 products on the tensor
# cores, f32 (and float64, below its own peak) on the CUDA cores
DTYPE_PATH = {"bfloat16": "tensor_core", "float16": "tensor_core",
              "float32": "cuda_core", "float64": "cuda_core"}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops_per_dev: float  # the step's counted FLOPs per device
    hlo_bytes_per_dev: float  # the step's counted bytes per device
    coll_bytes_per_dev: float  # ring-model collective bytes per device
    model_flops_total: Optional[float] = None  # 6ND-style useful flops (global)
    dtype: str = "bfloat16"  # the step's compute dtype
    compute_path: Optional[str] = None  # "cuda_core" / "tensor_core"; None: the dtype's
    link_bw: float = NVLINK_BW

    @property
    def path(self) -> str:
        return self.compute_path or DTYPE_PATH[self.dtype]

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.path]

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_dev / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / self.link_bw

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound; with perfect overlap it's the max term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if not self.model_flops_total:
            return None
        per_dev_useful = self.model_flops_total / self.n_devices
        if self.hlo_flops_per_dev <= 0:
            return None
        return per_dev_useful / self.hlo_flops_per_dev

    @property
    def mfu_bound(self) -> Optional[float]:
        """Model-FLOPs utilization at the roofline step time."""
        if not self.model_flops_total:
            return None
        t = self.step_time_s
        if t <= 0:
            return None
        return self.model_flops_total / (self.n_devices * self.peak_flops * t)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "n_devices": self.n_devices,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "hlo_bytes_per_dev": self.hlo_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "dtype": self.dtype,
            "compute_path": self.path,
            "peak_flops": self.peak_flops,
            "hbm_bw": HBM_BW,
            "link_bw": self.link_bw,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def bound_s(nbytes: float, ops: float) -> tuple:
    """(seconds, "bytes" or "operations"): the least time one card takes
    to move ``nbytes`` through HBM and do ``ops`` f32 operations on the
    CUDA cores, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / CUDA_CORE_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_model_flops(cfg, batch: int, seq: int, train: bool = True) -> float:
    """6ND (train) / 2ND (inference) with active params for MoE."""
    n = cfg.n_active_params
    tokens = batch * seq
    return (6.0 if train else 2.0) * n * tokens


def lm_decode_model_flops(cfg, batch: int, kv_len: int) -> float:
    """One-token decode: 2 N_active + attention reads 2*2*kv*H*dh per layer."""
    n = cfg.n_active_params
    attn = 4.0 * kv_len * cfg.n_heads * cfg.d_head * cfg.n_layers
    return batch * (2.0 * n + attn)


def gnn_model_flops(cfg, n_nodes: int, n_edges: int, d_feat: int, train: bool = True) -> float:
    """Per-layer: E*d message FLOPs + N*d^2 transform FLOPs (x3 for bwd)."""
    d = cfg.d_hidden
    per_layer = 2.0 * n_edges * d + 2.0 * n_nodes * d * d
    first = 2.0 * n_nodes * d_feat * d
    total = first + cfg.n_layers * per_layer
    return (3.0 if train else 1.0) * total


def bst_model_flops(cfg, batch: int, train: bool = True) -> float:
    s = cfg.seq_len + 1
    d = cfg.embed_dim
    attn = 4.0 * s * s * d + 8.0 * s * d * d  # scores+pv + qkvo proj
    ffn = 2.0 * s * (d * 4 * d) * 2
    mlp_dims = (s * d + cfg.n_other_feats,) + cfg.mlp_dims + (1,)
    mlp = sum(2.0 * a * b for a, b in zip(mlp_dims[:-1], mlp_dims[1:]))
    per_ex = cfg.n_blocks * (attn + ffn) + mlp
    return batch * per_ex * (3.0 if train else 1.0)
