"""Wrapper of the flash-attention kernel (``kernel.cu``)."""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


# Launch geometry of kernel.cu: the decode form for Sq <= DECODE_MAX_SQ
# (one block a query and head, DECODE_WARPS * 4 partial states over the
# keys), else the prefill form (PREFILL_QB queries a block, key tiles of
# PREFILL_KT).
DECODE_MAX_SQ = 16
DECODE_WARPS = 8
PREFILL_QB, PREFILL_KT = 64, 32


class FlashGeometry(NamedTuple):
    form: int        # 0 decode, 1 prefill
    grid_x: int      # grid (grid_x, H, B)


@functools.lru_cache(maxsize=None)
def flash_geometry(Sq: int) -> FlashGeometry:
    """The form and grid of one flash launch for Sq queries."""
    if Sq <= DECODE_MAX_SQ:
        return FlashGeometry(0, Sq)
    return FlashGeometry(1, math.ceil(Sq / PREFILL_QB))


def _pos_rows(p: torch.Tensor, B: int, S: int, name: str):
    """Positions as a contiguous int32 (b, S) tensor, b in {1, B}, and
    the kernel's row stride (0 = one row shared over the batch)."""
    p2 = p if p.ndim == 2 else p[None]
    if p2.shape[-1] != S or p2.shape[0] not in (1, B):
        raise ValueError(f"{name} has shape {tuple(p.shape)}; expected "
                         f"({S},) or (1|{B}, {S})")
    p2 = p2.to(torch.int32).contiguous()
    return p2, (0 if p2.shape[0] == 1 else S)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    window: int = 0, chunk: int = 512,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """Causal attention over absolute positions.

    q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh) in q's
    dtype.  The kernel runs on CUDA (q, k, v all f32 or all bf16, f32
    arithmetic, Dh <= 128); on the CPU the plain version runs with KV
    chunks of ``chunk``, which the kernel does not need.
    """
    dev = resolve_device(device)
    check_on(dev, q=q, k=k, v=v, q_positions=q_positions,
             k_positions=k_positions)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, Dh) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, q_positions, k_positions,
                                     window=window, chunk=chunk)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes q, k, v all f32 or all bf16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= Dh <= 128:
        raise ValueError(f"flash kernel takes head_dim <= 128, got {Dh}")
    qp, q_stride = _pos_rows(q_positions, B, Sq, "q_positions")
    kp, k_stride = _pos_rows(k_positions, B, Skv, "k_positions")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    geom = flash_geometry(Sq)
    rc = runtime.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, Dh, q_stride,
        k_stride, int(window), float(Dh ** -0.5), geom.form, geom.grid_x,
        int(q.dtype == torch.bfloat16), runtime.stream_arg(out.device))
    runtime.count_launch("flash_attention")
    runtime.check_status("flash_attention", rc)
    return out
