"""Wrapper of the flash-attention kernel (``kernel.cu``)."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.launch.roofline import (
    PEAK_BF16,
    PEAK_F32,
    PEAK_TF32,
    Cost,
)


# Launch geometry of kernel.cu.  f32: the decode form for Sq <=
# DECODE_MAX_SQ (one block a query and head, DECODE_WARPS * 4 partial
# states over the keys), else the prefill form (PREFILL_QB queries a
# block, key tiles of PREFILL_KT).  bf16: the prefill form takes 16
# queries a warp, BF16_PREFILL_WARPS warps a block, key tiles of BF16_KT
# in a ring of BF16_STAGES; the decode form serves one query
# of one KV head and up to BF16_DECODE_HEADS of its query heads a block
# (BF16_DECODE_GROUPS lane groups split over them; group u of a head
# takes keys u + gph t), keeps BF16_ROUNDS rounds of BF16_ROUND keys a
# group in flight, and splits C over a cluster of up to BF16_MAX_SPLIT
# blocks where a cache holds more than BF16_DECODE_KEYS keys.
DECODE_MAX_SQ = 16
DECODE_WARPS = 8
PREFILL_QB, PREFILL_KT = 64, 32
FORM_DECODE, FORM_PREFILL, FORM_PREFILL_BF16, FORM_DECODE_BF16 = 0, 1, 2, 3
BF16_KT, BF16_STAGES = 32, 3
BF16_PREFILL_WARPS = 4
BF16_DECODE_WARPS = 8
BF16_DECODE_GROUPS = BF16_DECODE_WARPS * 4
BF16_DECODE_HEADS = 8
BF16_MAX_SPLIT = 8
BF16_ROUND, BF16_ROUNDS = 2, 3
BF16_DECODE_KEYS = BF16_DECODE_GROUPS * BF16_ROUND * BF16_ROUNDS
_GEOM_FIELDS = ("form", "gx", "gy", "gz", "threads", "smem", "kpr", "heads")


def _padded(Dh: int) -> tuple[int, int]:
    """DP (Dh padded to 32) and the bf16 forms' row pitch DP + 8."""
    dp = 32 * math.ceil(Dh / 32)
    return dp, dp + 8


def decode_bf16_smem(dp: int) -> int:
    """Shared memory of the bf16 decode form (kernel.cu's
    ``decode_bf16_smem``): the warps' partials, the block's and the
    cluster's merge, and the staging of BF16_ROUNDS rounds of K and V
    rows at a pitch of DP (DP + 32 where DP * 2 bytes is a multiple of
    128)."""
    w, hd = BF16_DECODE_WARPS, BF16_DECODE_HEADS
    floats = w * dp + 2 * w + 2 * hd + hd * dp + BF16_MAX_SPLIT * hd + hd
    pitch = dp + (32 if dp % 64 == 0 else 0)
    return 4 * floats + (BF16_ROUNDS * BF16_ROUND * BF16_DECODE_GROUPS
                         * pitch * 4)


def groups_per_head(heads: int) -> int:
    """Lane groups of the bf16 decode form a query head, for ``heads``
    heads a block: a multiple of 4, so that a warp's 4 groups share one
    head (kernel.cu's ``gph``)."""
    return 4 * (BF16_DECODE_GROUPS // (4 * heads))


def decode_split(C: int) -> int:
    """Blocks of the bf16 decode form's cluster for a cache of C slots:
    1 where a block keeps every key in flight (BF16_DECODE_KEYS), else
    enough for that, at most BF16_MAX_SPLIT."""
    return min(BF16_MAX_SPLIT, max(1, math.ceil(C / BF16_DECODE_KEYS)))


@functools.lru_cache(maxsize=None)
def flash_geometry(Sq: int, bf16: bool = False, B: int = 1, H: int = 1,
                   Hkv: int = 1, C: int = 1, Dh: int = 32,
                   split: int | None = None) -> runtime.Geometry:
    """The form and launch of one flash call: Sq queries of B x H heads
    over C cache slots of Hkv heads.

    bf16 decode: a cluster of :func:`decode_split` blocks along C;
    ``split`` overrides it (for measurements)."""
    g = dict(gy=H, gz=B, smem=0, kpr=0, heads=0)
    dp, ld = _padded(Dh)
    if not bf16:
        if Sq <= DECODE_MAX_SQ:
            g.update(form=FORM_DECODE, gx=Sq, threads=DECODE_WARPS * 32)
        else:
            g.update(form=FORM_PREFILL, gx=math.ceil(Sq / PREFILL_QB),
                     threads=128)
    elif Sq > DECODE_MAX_SQ:
        qb = 16 * BF16_PREFILL_WARPS
        g.update(form=FORM_PREFILL_BF16, gx=math.ceil(Sq / qb),
                 threads=32 * BF16_PREFILL_WARPS,
                 smem=(qb * ld + 2 * BF16_STAGES * BF16_KT * ld) * 2
                 + BF16_STAGES * BF16_KT * 4)
    else:
        split = split or decode_split(C)
        if not 1 <= split <= BF16_MAX_SPLIT:
            raise ValueError(f"bf16 decode splits C over 1..{BF16_MAX_SPLIT}"
                             f" blocks, not {split}")
        G = H // Hkv
        heads = min(G, BF16_DECODE_HEADS)
        kpr = math.ceil(C / split)
        g.update(form=FORM_DECODE_BF16, gx=split,
                 gy=Sq * Hkv * math.ceil(G / heads), threads=32 *
                 BF16_DECODE_WARPS, kpr=kpr, heads=heads,
                 smem=decode_bf16_smem(dp))
    return runtime.Geometry.of(_GEOM_FIELDS, g)


def occupancy(geom: runtime.Geometry, Dh: int) -> dict:
    """Occupancy of the kernel a launch with ``geom`` runs at head size
    ``Dh``, from the CUDA runtime's occupancy calculator:
    ``blocks_per_sm`` and, for a cluster launch, ``clusters`` the card
    holds at once (else None)."""
    out = (ctypes.c_int * 2)()
    rc = runtime.library().flash_occupancy(geom.array, Dh, out)
    runtime.check_status("flash_attention occupancy", rc)
    return dict(blocks_per_sm=out[0], clusters=out[1] or None)


@functools.lru_cache(maxsize=None)
def visible(pos0: int, S: int, C: int, window: int = 0) -> tuple[int, int]:
    """(pairs, seen) of one lane: the (query, key) pairs that S queries
    at positions pos0 .. pos0 + S - 1 attend over a ring of C slots
    filled from position 0 (the serving engines' cache; a stateless
    forward is the ring C = S), under ``window``, and the key slots
    some query reads.  A query older than the ring's oldest key attends
    to none (a prefill longer than the ring)."""
    lo = max(0, pos0 + S - C)            # the oldest key the ring holds
    pairs = sum(max(0, i - (max(lo, i - window + 1) if window else lo) + 1)
                for i in range(pos0, pos0 + S))
    first = max(lo, pos0 - window + 1) if window else lo
    return pairs, max(0, pos0 + S - first)


def cost(B: int, Sq: int, H: int, Hkv: int, Dh: int, bf16: bool,
         pairs: int, seen: int, pos_elems: int = 0) -> Cost:
    """The work of one :func:`flash_attention` from shapes and the
    positions' counts: ``pairs`` (query, key) pairs a head and ``seen``
    key slots read, each summed over the lanes (:func:`visible`); q read
    and o written once, K and V at the seen slots, and ``pos_elems``
    int32 positions.  Q.K^T and P.V take 2 Dh operations a pair each:
    the decode forms on the f32 pipe, the prefill forms on the tensor
    cores (3xTF32 in f32; in bf16 1 product for Q.K^T and 3 for P.V)."""
    esize = 2 if bf16 else 4
    n_bytes = (2 * B * Sq * H * Dh + 2 * seen * Hkv * Dh) * esize \
        + pos_elems * 4
    ops = 4.0 * Dh * pairs * H
    if Sq <= DECODE_MAX_SQ:
        return Cost(ops, PEAK_F32, n_bytes)
    return Cost(2 * ops, PEAK_BF16, n_bytes) if bf16 \
        else Cost(3 * ops, PEAK_TF32, n_bytes)


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
    arithmetic, Dh <= 128) with :func:`flash_geometry`'s launch; on the
    CPU the plain version runs with KV chunks of ``chunk``, which the
    kernel does not need.
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
    geom = flash_geometry(Sq, q.dtype == torch.bfloat16, B, H, Hkv, Skv, Dh)
    return launch(q, k, v, q_positions, k_positions, window, geom)


def launch(q, k, v, q_positions, k_positions, window: int,
           geom: runtime.Geometry) -> torch.Tensor:
    """One launch of the kernel with ``geom`` (:func:`flash_geometry` of
    these shapes and dtype, or one of its overrides) on CUDA tensors that
    :func:`flash_attention` has checked."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qp, q_stride = _pos_rows(q_positions, B, Sq, "q_positions")
    kp, k_stride = _pos_rows(k_positions, B, Skv, "k_positions")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = runtime.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, Dh, q_stride,
        k_stride, int(window), float(Dh ** -0.5), geom.array,
        runtime.stream_arg(out.device))
    runtime.count_launch("flash_attention")
    runtime.check_status("flash_attention", rc)
    return out
