"""Wrapper of the sLSTM scan kernel (``kernel.cu``)."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.kernels.slstm_scan.ref import slstm_scan_plain

# Launch geometry of kernel.cu: a cluster of CLUSTER blocks of THREADS
# threads per (head, group of up to MAX_LANES batch lanes); a block owns
# up to MAX_PER hidden dims, cuts the k range into KS slices and holds
# up to REG_ROWS rows of each slice in registers, the next rows in
# shared memory as far as SMEM_MAX allows, and reads the rest from L2.
CLUSTER = 16
THREADS = 512
MAX_PER = 32
KS = 16
LANES = 4
MAX_LANES = 8
REG_ROWS = 10
SMEM_MAX = 232448
MBAR_BYTES = 24             # an mbarrier per h buffer, one for staging R
MAX_HEAD_DIM = CLUSTER * MAX_PER          # 512
# The fields of kernel.cu's ``Geom``, in order.
_GEOM_FIELDS = ("per", "kper", "reg_rows", "sm_rows", "lanes", "lanes_p",
                "groups", "smem")


# Launcher flags: which operands are bf16 (the state's type is also the
# outputs').
GX_BF16, R_BF16, STATE_BF16 = 1, 2, 4


def _smem(other: int, sm_rows: int, per: int, r_bytes: int = 4) -> int:
    """Bytes of shared memory: KS x 4 TMA boxes of sm_rows x per values
    of R (``r_bytes`` each), each padded to 128 bytes, then ``other``
    floats and the mbarriers."""
    unit = 128 // r_bytes
    box = -(-sm_rows * per // unit) * unit
    return r_bytes * KS * 4 * box + 4 * other + MBAR_BYTES


@functools.lru_cache(maxsize=None)
def slstm_geometry(B: int, Dh: int, r_bf16: bool = False) -> runtime.Geometry:
    """The launch of ``slstm_scan`` for B lanes and head dim Dh, with R in
    f32 or (``r_bf16``) bf16.

    Block ``rank`` of a cluster owns the dims [rank * per, (rank + 1) *
    per); k slice s (warp s) the rows [s * kper, (s + 1) * kper), of
    which the first ``reg_rows`` sit in registers, the next ``sm_rows``
    in shared memory (loaded as one TMA box a gate) and the rest are
    read from L2 each step.  Shared memory holds those rows, two h
    buffers of ``lanes_p`` lanes, the slices' partial sums, the c state
    and three 8-byte mbarriers; ``smem`` bytes in all.  A TMA box row
    is a multiple of 16 bytes, so a bf16 R takes ``per`` a multiple of
    8."""
    if Dh < 4 or Dh % 4 or Dh > MAX_HEAD_DIM or B < 1:
        raise ValueError(f"slstm_scan kernel takes B >= 1 and a head dim "
                         f"that is a multiple of 4 up to {MAX_HEAD_DIM}, "
                         f"got B={B}, Dh={Dh}")
    per = math.ceil(Dh / CLUSTER)
    per = -(-per // 8) * 8 if r_bf16 else runtime.round4(per)
    kper = math.ceil(Dh / KS)
    reg_rows = min(REG_ROWS, kper)
    lanes = min(B, MAX_LANES)
    lanes_p = runtime.round4(lanes)
    ncols = 4 * per
    other = 2 * Dh * lanes_p + KS * LANES * ncols + per * lanes_p
    sm_rows = kper - reg_rows
    r_bytes = 2 if r_bf16 else 4
    while sm_rows and _smem(other, sm_rows, per, r_bytes) > SMEM_MAX:
        sm_rows -= 1
    g = dict(per=per, kper=kper, reg_rows=reg_rows, sm_rows=sm_rows,
             lanes=lanes, lanes_p=lanes_p, groups=math.ceil(B / lanes),
             smem=_smem(other, sm_rows, per, r_bytes))
    return runtime.Geometry.of(_GEOM_FIELDS, g)


def max_active_clusters(B: int, Dh: int) -> int:
    """Clusters of the scan's launch for (B, Dh) that the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    rc = runtime.library().slstm_scan_max_clusters(
        slstm_geometry(B, Dh).smem, ctypes.byref(n))
    runtime.check_status("slstm_scan occupancy", rc)
    return n.value


def slstm_scan(gx: torch.Tensor, r_gates: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, *, device: str | torch.device = "cuda"):
    """The sLSTM recurrence over all T steps of ``gx`` in one launch.

    gx (B, T, H, 4Dh), r_gates (H, Dh, 4Dh), h0 / c0 (B, H, Dh) ->
    (hs (B, T, H, Dh), hT, cT) in h0's dtype.  gx, r_gates and the state
    (h0 and c0, one dtype) are each f32 or bf16; the arithmetic and the
    carried state are f32.  The kernel takes Dh a multiple of 4 up to
    512 (:func:`slstm_geometry`); the CPU runs the plain version.
    """
    dev = resolve_device(device)
    check_on(dev, gx=gx, r_gates=r_gates, h0=h0, c0=c0)
    B, T, H, Dh4 = gx.shape
    Dh = Dh4 // 4
    if (Dh4 % 4 or r_gates.shape != (H, Dh, Dh4)
            or h0.shape != (B, H, Dh) or c0.shape != h0.shape):
        raise ValueError(f"gx {tuple(gx.shape)}, r_gates "
                         f"{tuple(r_gates.shape)}, h0 {tuple(h0.shape)}, "
                         f"c0 {tuple(c0.shape)} do not fit")
    if dev.type == "cpu":
        return slstm_scan_plain(gx, r_gates, h0, c0)
    ok = (torch.float32, torch.bfloat16)
    if gx.dtype not in ok or r_gates.dtype not in ok \
            or h0.dtype not in ok or c0.dtype != h0.dtype:
        raise TypeError(f"slstm_scan kernel takes f32 or bf16 gx and "
                        f"r_gates and an f32 or bf16 state, got {gx.dtype}, "
                        f"{r_gates.dtype}, {h0.dtype}, {c0.dtype}")
    bf = lambda t: t.dtype == torch.bfloat16
    flags = (GX_BF16 * bf(gx) | R_BF16 * bf(r_gates)
             | STATE_BF16 * bf(h0))
    geom = slstm_geometry(max(B, 1), Dh, bf(r_gates))
    gx, h0, c0 = gx.contiguous(), h0.contiguous(), c0.contiguous()
    r_gates = r_gates.contiguous()
    if r_gates.data_ptr() % 16:            # the kernel's TMA needs 16 bytes
        r_gates = r_gates.clone()
    hs = torch.empty((B, T, H, Dh), dtype=h0.dtype, device=dev)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    if T == 0 or B == 0:
        return hs, hT.copy_(h0), cT.copy_(c0)
    lib = runtime.library()
    rc = lib.slstm_scan_launch(
        gx.data_ptr(), r_gates.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H, Dh,
        geom.array, flags, runtime.stream_arg(hs.device))
    runtime.count_launch("slstm_scan")
    runtime.check_status("slstm_scan", rc)
    return hs, hT, cT

