"""Wrapper of the sLSTM scan kernels (``kernel.cu``).

Three forms, chosen by :func:`slstm_form` from the shape and R's dtype:
the general form (``slstm_kernel``: f32 R, and a bf16 R of a shape the
others refuse), the scan form (``slstm_tc_kernel``: bf16 R at Dh =
TC_DH, R in registers as tensor-core fragments) and the decode form
(``slstm_decode_kernel``: bf16 R at T = 1, R streamed once).  Each has
its launch geometry here, its launches counted under its own name
(``COUNTERS``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.launch.roofline import PEAK_BF16, PEAK_F32, Cost
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

# The scan form (kernel.cu's TC_*, bf16 R): Dh = TC_DH only, a cluster of
# CLUSTER blocks of TC_THREADS threads a (head, group of TC_LANES lanes),
# R's slice staged once at a row pitch of TC_PITCH bf16 into TC_KT
# mma.sync A fragments a thread, gx staged through a ring of TC_RING
# steps.
TC_DH = 512
TC_PER = TC_DH // CLUSTER                 # 32 dims a block
TC_COLS = 4 * TC_PER                      # 128 gate columns a block
TC_MT = TC_COLS // 16                     # m-tiles of 16 columns
TC_KH = 2                                 # k halves
TC_THREADS = 32 * TC_MT * TC_KH           # 512: a warp a (m-tile, half)
TC_KT = TC_DH // 16 // TC_KH              # 16 k-tiles (fragments) a warp
TC_LANES = 4
TC_PITCH = TC_COLS + 8
TC_RING = 8
TC_ROW = 32                               # bytes of a dim's h pieces
_TC_FIELDS = ("groups", "smem")

# The decode form (kernel.cu's DC_*, bf16 R, T = 1): a cluster of
# ``split`` blocks of 8 ks threads a (head, DC_DIMS dims), k cut into
# ``split`` rank ranges of ``kr`` rows and each into ``ks`` (a power of 2
# from 16 to DC_MAX_KS) sub-slices of ``rpt`` <= DC_MAX_RPT rows a
# thread; lanes in passes of LANES, at most DC_LANES.
DC_DIMS = 16
DC_COLS = 4 * DC_DIMS
DC_MAX_KS = 64
DC_MAX_THREADS = 4 * 2 * DC_MAX_KS        # 512
DC_MAX_RPT = 8
DC_MAX_SPLIT = 4
DC_LANES = 8
DC_RED = LANES * DC_COLS + 4              # floats a sub-slice's sums
DC_MAX_DH = MAX_HEAD_DIM                  # 512
_DC_FIELDS = ("split", "ks", "kr", "rpt", "passes", "smem")

# The forms, by name: kernel.cu's form ids and the launch counters.
FORM_GENERAL, FORM_SCAN, FORM_DECODE = "general", "scan", "decode"
FORMS = {FORM_GENERAL: 0, FORM_SCAN: 1, FORM_DECODE: 2}
COUNTERS = {FORM_GENERAL: "slstm_scan", FORM_SCAN: "slstm_scan_tc",
            FORM_DECODE: "slstm_scan_decode"}
# The decode form takes T up to this (there is no recurrence to carry
# only at T = 1), split over a cluster of DC_SPLIT blocks at most (at
# xlstm-1.3b's shape a split of 2 beat 1 and 4 on the H100:
# slstm_stages.py).
DECODE_MAX_T = 1
DC_SPLIT = 2


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


def tc_smem(gx_bf16: bool) -> int:
    """Bytes of shared memory of the scan form (kernel.cu's tc_smem): R's
    staged rows, two h buffers, two steps' partial sums, the gx ring and
    2 x CLUSTER mbarriers."""
    gx_bytes = 2 if gx_bf16 else 4
    return (2 * TC_DH * TC_PITCH + 2 * TC_DH * TC_ROW
            + 2 * 4 * TC_KH * TC_COLS * TC_LANES
            + TC_RING * TC_LANES * 4 * TC_PER * gx_bytes + 2 * CLUSTER * 8)


@functools.lru_cache(maxsize=None)
def scan_geometry(B: int, Dh: int, gx_bf16: bool = True) -> runtime.Geometry:
    """The scan form's launch for B lanes (bf16 R): ``groups`` clusters a
    head of TC_LANES lanes each; ``smem`` bytes a block.  It takes Dh =
    TC_DH only."""
    if Dh != TC_DH or B < 1:
        raise ValueError(f"slstm_scan's scan form takes B >= 1 and Dh = "
                         f"{TC_DH}, got B={B}, Dh={Dh}")
    return runtime.Geometry.of(_TC_FIELDS, dict(
        groups=math.ceil(B / TC_LANES), smem=tc_smem(gx_bf16)))


def dc_smem(ks: int, kr: int, passes: int) -> int:
    """Bytes of shared memory of the decode form (kernel.cu's dc_smem):
    the h0 rows of a rank, the sub-slices' sums, and (read in rank 0)
    DC_MAX_SPLIT ranks' sums."""
    return 4 * (kr * LANES * passes + ks * DC_RED
                + DC_MAX_SPLIT * passes * LANES * DC_COLS)


@functools.lru_cache(maxsize=None)
def decode_geometry(B: int, Dh: int, split: int | None = None
                    ) -> runtime.Geometry:
    """The decode form's launch (bf16 R, T = 1) for B lanes and head dim
    Dh, over a cluster of ``split`` blocks (default DC_SPLIT, fewer where
    Dh is short): each rank's k range in ``ks`` sub-slices, the fewest
    (a power of 2 from 16) that hold it at DC_MAX_RPT rows a thread;
    lanes in ``passes`` of LANES."""
    if Dh < DC_DIMS or Dh % DC_DIMS or Dh > DC_MAX_DH \
            or not 1 <= B <= DC_LANES:
        raise ValueError(f"slstm_scan's decode form takes 1 <= B <= "
                         f"{DC_LANES} and Dh a multiple of {DC_DIMS} up to "
                         f"{DC_MAX_DH}, got B={B}, Dh={Dh}")
    if split is None:
        split = min(DC_SPLIT, math.ceil(Dh / (16 * DC_MAX_RPT)))
    if not 1 <= split <= DC_MAX_SPLIT:
        raise ValueError(f"slstm_scan's decode form splits k over 1 to "
                         f"{DC_MAX_SPLIT} blocks, got {split}")
    rows = math.ceil(Dh / split)
    ks = 16
    while ks * DC_MAX_RPT < rows:
        ks *= 2
    rpt = math.ceil(rows / ks)
    passes = math.ceil(B / LANES)
    return runtime.Geometry.of(_DC_FIELDS, dict(
        split=split, ks=ks, kr=ks * rpt, rpt=rpt, passes=passes,
        smem=dc_smem(ks, ks * rpt, passes)))


def slstm_form(B: int, T: int, Dh: int, r_bf16: bool) -> str:
    """The form a call of this shape takes: an f32 R the general form;
    a bf16 R the decode form at T <= DECODE_MAX_T where it takes the
    shape, the scan form at Dh = TC_DH, else the general form."""
    if not r_bf16:
        return FORM_GENERAL
    if T <= DECODE_MAX_T and Dh % DC_DIMS == 0 \
            and DC_DIMS <= Dh <= DC_MAX_DH and 1 <= B <= DC_LANES:
        return FORM_DECODE
    return FORM_SCAN if Dh == TC_DH else FORM_GENERAL


def cost(B: int, T: int, H: int, Dh: int, gx_bytes: int = 4,
         r_bytes: int = 4, state_bytes: int = 4,
         form: str = FORM_GENERAL) -> Cost:
    """The work of one :func:`slstm_scan` from shapes (element sizes in
    bytes): gx and R read, h0 and c0 read and hT, cT and hs written,
    once; h @ R (2 Dh operations a gate column a step) and ~20 a dim a
    step for the gates.  The scan form does h @ R on the bf16 tensor
    cores as 3 products (h in three bf16 pieces), the gates beside it
    on the f32 pipe; the general and decode forms all on the f32
    pipe."""
    n_bytes = (gx_bytes * B * T * H * 4 * Dh + r_bytes * H * Dh * 4 * Dh
               + state_bytes * (4 * B * H * Dh + B * T * H * Dh))
    prod = 2.0 * B * T * H * Dh * 4 * Dh
    gates = 20.0 * B * T * H * Dh
    if form == FORM_SCAN:
        return Cost(3 * prod, PEAK_BF16, n_bytes, gates)
    return Cost(prod + gates, PEAK_F32, n_bytes)


def geometry(form: str, B: int, Dh: int, r_bf16: bool,
             gx_bf16: bool = True) -> runtime.Geometry:
    """The launch of ``form`` for B lanes and head dim Dh; raises where the
    form does not take the shape (the scan and decode forms take a bf16
    R only)."""
    if form not in FORMS:
        raise ValueError(f"unknown slstm_scan form {form!r}")
    if form != FORM_GENERAL and not r_bf16:
        raise ValueError(f"slstm_scan's {form} form takes a bf16 R")
    if form == FORM_SCAN:
        return scan_geometry(B, Dh, gx_bf16)
    if form == FORM_DECODE:
        return decode_geometry(B, Dh)
    return slstm_geometry(B, Dh, r_bf16)


def max_active_clusters(B: int, Dh: int, r_bf16: bool = False,
                        form: str = FORM_GENERAL,
                        gx_bf16: bool = True) -> int:
    """Clusters of ``form``'s launch for (B, Dh), with R in f32 or bf16,
    that the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    geom = geometry(form, B, Dh, r_bf16, gx_bf16)
    n = ctypes.c_int(0)
    rc = runtime.library().slstm_scan_max_clusters(
        FORMS[form], geom.array, R_BF16 * r_bf16 | GX_BF16 * gx_bf16,
        ctypes.byref(n))
    runtime.check_status("slstm_scan occupancy", rc)
    return n.value


def slstm_scan(gx: torch.Tensor, r_gates: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, *, device: str | torch.device = "cuda",
               form: str | None = None):
    """The sLSTM recurrence over all T steps of ``gx`` in one launch.

    gx (B, T, H, 4Dh), r_gates (H, Dh, 4Dh), h0 / c0 (B, H, Dh) ->
    (hs (B, T, H, Dh), hT, cT) in h0's dtype.  gx, r_gates and the state
    (h0 and c0, one dtype) are each f32 or bf16; the arithmetic and the
    carried state are f32.  The kernel takes Dh a multiple of 4 up to
    512, in the form :func:`slstm_form` picks from the shape and R's
    dtype (``form`` forces one; it raises where that form does not take
    the shape); the CPU runs the plain version.
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
    form = form or slstm_form(max(B, 1), max(T, 1), Dh, bf(r_gates))
    geom = geometry(form, max(B, 1), Dh, bf(r_gates), bf(gx))
    gx, h0, c0 = gx.contiguous(), h0.contiguous(), c0.contiguous()
    r_gates = r_gates.contiguous()
    # The general form's TMA and the other forms' 16-byte copies of R,
    # and the scan form's of gx, need 16-byte aligned bases.
    if r_gates.data_ptr() % 16:
        r_gates = r_gates.clone()
    if gx.data_ptr() % 16:
        gx = gx.clone()
    hs = torch.empty((B, T, H, Dh), dtype=h0.dtype, device=dev)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    if T == 0 or B == 0:
        return hs, hT.copy_(h0), cT.copy_(c0)
    if form == FORM_DECODE and T > DECODE_MAX_T:
        raise ValueError(f"slstm_scan's decode form takes T <= "
                         f"{DECODE_MAX_T}, got T={T}")
    lib = runtime.library()
    rc = lib.slstm_scan_launch(
        gx.data_ptr(), r_gates.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H, Dh,
        FORMS[form], geom.array, flags, runtime.stream_arg(hs.device))
    runtime.count_launch(COUNTERS[form])
    runtime.check_status(f"slstm_scan ({form} form)", rc)
    return hs, hT, cT

