"""Roofline terms of one step, the port of ``src/repro/launch/hlo_analysis.py``.

compute    = FLOPs / peak FLOP/s
memory     = bytes / HBM bandwidth
collective = collective bytes / link bandwidth

Each term is in seconds for the per-device counts a caller passes. The
rates are keyword parameters; their defaults are the datasheet rates of
one NVIDIA H100 SXM (989 TFLOP/s dense bfloat16, 3.35 TB/s HBM3, 450 GB/s
NVLink each way), the card the port runs on.

The reference's other four functions (``_shape_bytes``,
``parse_computations``, ``while_multipliers``, ``collective_bytes``) read
the optimized XLA HLO text of a program compiled for a device mesh: they
count the operand bytes of its collectives and multiply those inside
while-loop bodies by the loops' trip counts. The port compiles no HLO.
Their counterpart, a count of the bytes of the ``torch.distributed``
collectives (all-reduce, all-gather, reduce-scatter, all-to-all) of a
sharded step, comes with the work across more than one card: the port's
steps run on one card today and have no collective to count.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM datasheet rates (per card)
H100_PEAK_FLOPS = 989e12     # dense bfloat16 tensor-core FLOP/s
H100_HBM_BW = 3.35e12        # HBM3 bytes/s
H100_NVLINK_BW = 450e9       # NVLink bytes/s, each direction


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int, *, peak_flops: float = H100_PEAK_FLOPS,
                   hbm_bw: float = H100_HBM_BW,
                   link_bw: float = H100_NVLINK_BW) -> Dict[str, float]:
    """Terms in seconds. ``flops``/``bytes_accessed``/``coll_bytes`` are
    per device; ``chips`` is kept for the reference's signature (the
    counts are already per device)."""
    return {
        "compute_s": flops / peak_flops,
        "memory_s": bytes_accessed / hbm_bw,
        "collective_s": coll_bytes / link_bw,
    }


def dominant(terms: Dict[str, float]) -> str:
    """The largest of the three terms (the first on a tie)."""
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


def model_flops(n_params_active: float, tokens: float, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


__all__ = ["H100_HBM_BW", "H100_NVLINK_BW", "H100_PEAK_FLOPS", "dominant",
           "model_flops", "roofline_terms"]
