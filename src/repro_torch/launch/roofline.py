"""Roofline terms on one NVIDIA H100: the port's counterpart of
``src/repro/launch/roofline.py``.

Three terms a (arch x shape x cards) cell, in seconds:

    compute    = counted operations / (cards * the peak of their type)
    memory     = counted bytes      / (cards * HBM bytes/s)
    collective = collective bytes   / (cards * NVLink bytes/s each way)

The operations and bytes are counted from shapes while the port's own
step runs (``launch/op_cost.py``), not read from a compiled program.
The peaks are NVIDIA's data-sheet figures for the H100 SXM at 700 W,
dense, without sparsity; a card set below 700 W runs slower.  The
reference's HLO helpers (``collective_bytes``, ``loop_trip_counts``)
have no counterpart: an eager step has no HLO text, and it runs every
layer, so there are no trip counts to recover.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

PEAK_BYTES = 3.35e12     # HBM3, bytes/s
PEAK_BF16 = 989e12       # tensor cores, bf16 and f16
PEAK_TF32 = 495e12       # tensor cores, TF32 (a 3xTF32 product counts 3)
PEAK_F32 = 67e12         # f32 outside the tensor cores
PEAK_F64 = 34e12         # f64 outside the tensor cores
HBM_BYTES = 80e9         # device memory of one card
NVLINK_BW = 450e9        # NVLink bytes/s each way, one card
SM_COUNT = 132           # SMs of one card (launch geometry from shapes)

_PEAKS = {torch.bfloat16: PEAK_BF16, torch.float16: PEAK_BF16,
          torch.float64: PEAK_F64}


def peak_for(dtype: torch.dtype) -> float:
    """The compute peak of a cell or an op in ``dtype``: bf16 and f16 on
    the tensor cores, f64 and everything else outside them (f32
    products run with ``allow_tf32 = False``)."""
    return _PEAKS.get(dtype, PEAK_F32)


def bound(flops: float, n_bytes: float,
          peak: float = PEAK_F32) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card takes
    to do ``flops`` operations at ``peak`` and move ``n_bytes``, and the
    term that sets it."""
    t_b, t_o = n_bytes / PEAK_BYTES, flops / peak
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


class Cost(NamedTuple):
    """One kernel call's work from its shapes: ``flops`` operations at
    ``peak`` (a tensor-core form's 3xTF32 products count 3), ``bytes``
    (each input read once, each output written once) and ``f32_ops``
    run on the f32 pipe beside a tensor-core form's products (read
    noise)."""

    flops: float
    peak: float
    bytes: float
    f32_ops: float = 0.0

    def bound(self) -> tuple[float, str]:
        """(seconds, term) of :func:`bound`, the f32 ops beside."""
        t, by = bound(self.flops, self.bytes, self.peak)
        return (t, by) if self.f32_ops / PEAK_F32 <= t \
            else (self.f32_ops / PEAK_F32, "operations")


@dataclass
class Roofline:
    """The reference's fields and terms; ``peak_flops`` is the cell's
    compute peak (:func:`peak_for` its dtype), and ``compute_s``, where
    given, the operations' time each at its own peak (a hand kernel's
    tensor-core products at theirs)."""

    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int
    model_flops: float = 0.0
    coll_breakdown: dict = field(default_factory=dict)
    peak_flops: float = PEAK_F32
    compute_s: float | None = None

    @property
    def t_compute(self) -> float:
        if self.compute_s is not None:
            return self.compute_s / self.chips
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * PEAK_BYTES)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful model compute at the cell's peak over the bound."""
        if not self.model_flops or not self.bound_time:
            return 0.0
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / self.bound_time

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops, "peak_flops": self.peak_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_breakdown": self.coll_breakdown,
        }


def model_flops(cfg, shape_cfg, n_params_active, n_params_embed) -> float:
    """6 N D train FLOPs (2 N D forward only), N the active
    non-embedding parameters (MoE experts at top-k / E)."""
    tokens = shape_cfg.global_batch * (
        shape_cfg.seq_len if shape_cfg.kind != "decode" else 1)
    n = n_params_active - n_params_embed
    per_tok = 6 * n if shape_cfg.kind == "train" else 2 * n
    return float(per_tok) * tokens
