"""Wrapper of the fused CIM matmul kernel, and deployment packaging.

``deploy()`` turns a dense weight matrix into a :class:`CimDeployment`
(signed int16 codes + MDM physical row-position table) once, at
deployment time; ``cim_mvm()`` then computes the PR-distorted matmul
for any activation batch: the hand-written kernel (``kernel.cu``) on
CUDA tensors, the plain PyTorch version (``ref.py``) on CPU tensors.
A deployment onto imperfect devices (``repro_torch.deploy``) also
carries a per-weight ``gain``, a per-tile bitline permutation
``col_pos`` and per-read noise (``sigma_read``, ``noise_tag``, and a
``read_seed`` a call).  Such a deployment is folded once, when it is
packaged (:func:`fold`): ``folded`` holds W'(col_pos) * gain in f32,
computed by the fold kernel on the card (its plain version on the
CPU), and the kernel's folded forms read it and add the read's noise;
an MoE expert bank's folds, stacked over its experts, are read by the
grouped folded form (:func:`cim_mvm_grouped`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core.bitslice import codes_to_bits, quantize_magnitude
from repro_torch.core.mdm import MdmPlan, plan_from_bits
from repro_torch.core.noise import PAPER_ETA
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.kernels.cim_mvm.ref import (
    cim_mvm_batched_plain,
    cim_mvm_grouped_plain,
    cim_mvm_plain,
    folded_weights,
)
from repro_torch.mapping import resolve_pipeline


@dataclasses.dataclass
class CimDeployment:
    """A weight matrix deployed onto bit-sliced crossbars.

    codes: (I_tiles*rows, N_tiles*wpt) int16 signed codes (sign*magnitude).
    pos:   (I_tiles*rows, N_tiles)     int32 physical row positions.
    scale: ()                          f32 quantisation scale.
    gain:  (I_tiles*rows, N_tiles*wpt) f32 per-weight conductance gain
           (programming variation and drift), or None.
    col_pos: (I_tiles, N_tiles, cols) int32 physical bitline of each
           dataflow-layout column a tile, or None (fixed layout).
    degraded: () int32 CPU tensor, programmed bits left on open lines
           after the remap (> 0: the model serves this matrix digitally),
           or None (no fault injection).
    noise_tag: () int32 CPU tensor, this matrix's read-noise tag, or None.
    sigma_read: relative per-read conductance noise std; applied only
           when ``cim_mvm`` gets a ``read_seed`` and the tag is set.
    folded: (I_tiles*rows, ld) f32 W'(col_pos) * gain, ld = N_pad rounded
           up to 8 (zero columns past N_pad), or None: derived from the
           codes, pos, scale, gain and col_pos by :func:`fold`, never
           cached; not an init field, so ``dataclasses.replace`` drops it
           (a replaced deployment is folded again, never stale).
    device_tags: an expert bank's ``noise_tag`` as int32 on the bank's
           device (set at deploy; the grouped folded form reads each
           expert's tag there, with no copy a call), or None; not an
           init field either.
    A stacked deployment carries a leading repeat axis on every tensor;
    :meth:`layer` takes one repeat's views.
    """

    codes: torch.Tensor
    pos: torch.Tensor
    scale: torch.Tensor
    n_bits: int
    wpt: int
    cols: int
    eta: float
    reversed_df: bool
    in_dim: int
    out_dim: int
    gain: torch.Tensor | None = None
    col_pos: torch.Tensor | None = None
    degraded: torch.Tensor | None = None
    noise_tag: torch.Tensor | None = None
    sigma_read: float = 0.0
    folded: torch.Tensor | None = dataclasses.field(default=None,
                                                    init=False, repr=False)
    device_tags: torch.Tensor | None = dataclasses.field(
        default=None, init=False, repr=False)
    _layers: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def layer(self, r: int) -> "CimDeployment":
        """Repeat ``r`` of a stacked deployment (views, no copy), made
        once: a forward asks for every layer's view."""
        view = self._layers.get(r)
        if view is None:
            view = self._layers[r] = dataclasses.replace(
                self, codes=self.codes[r], pos=self.pos[r],
                scale=self.scale[r],
                **{f: None if getattr(self, f) is None
                   else getattr(self, f)[r]
                   for f in ("gain", "col_pos", "degraded", "noise_tag")})
            if self.folded is not None:
                view.folded = self.folded[r]
            if self.device_tags is not None:
                view.device_tags = self.device_tags[r]
        return view


def package_deployment(codes: torch.Tensor, sign: torch.Tensor,
                       scale: torch.Tensor, plan: MdmPlan,
                       spec: CrossbarSpec, eta: float) -> CimDeployment:
    """Lay out quantised codes and a plan as a :class:`CimDeployment`.

    ``codes`` (I, N) magnitudes and ``sign`` (I, N) +-1; the codes are
    padded with zeros to whole tiles (:func:`package_padded`)."""
    I, N = codes.shape
    ti, tn = spec.grid(I, N)
    i_pad, n_pad = ti * spec.rows, tn * spec.weights_per_tile
    signed = (codes.to(torch.int32) * sign.to(torch.int32)).to(torch.int16)
    signed = F.pad(signed, (0, n_pad - N, 0, i_pad - I))
    return package_padded(signed, scale, plan, spec, eta, I, N)


def package_padded(signed: torch.Tensor, scale: torch.Tensor, plan: MdmPlan,
                   spec: CrossbarSpec, eta: float, in_dim: int, out_dim: int,
                   **operands) -> CimDeployment:
    """A :class:`CimDeployment` of signed int16 codes already padded to
    whole tiles: ``pos[i, tn]`` is the physical row of input i in column
    tile tn, and a column-permuting plan's ``col_position`` becomes
    ``col_pos``; ``operands`` are the nonideal fields (gain, degraded,
    noise_tag, sigma_read).  A deployment that carries a gain, a col_pos
    or read noise is folded (:func:`fold`) unless it is degraded (served
    digitally)."""
    rows = spec.rows
    i = torch.arange(signed.shape[0], device=signed.device)
    pos = plan.row_position.to(signed.device)[i // rows, :, i % rows].to(
        torch.int32)
    col_pos = (None if plan.col_position is None
               else plan.col_position.to(signed.device, torch.int32)
               .contiguous())
    dep = CimDeployment(
        codes=signed.contiguous(), pos=pos.contiguous(),
        scale=scale.to(torch.float32), n_bits=spec.n_bits,
        wpt=spec.weights_per_tile, cols=spec.cols, eta=float(eta),
        reversed_df=bool(plan.reversed_dataflow), in_dim=in_dim,
        out_dim=out_dim, col_pos=col_pos, **operands)
    degraded = dep.degraded is not None and int(dep.degraded) != 0
    return fold(dep) if needs_fold(dep) and not degraded else dep


def deploy(w: torch.Tensor, spec: CrossbarSpec, mode="mdm",
           eta: float = PAPER_ETA,
           plan: MdmPlan | None = None) -> tuple[CimDeployment, MdmPlan]:
    """Quantise, plan and package one (in_dim, out_dim) weight matrix on
    ``w``'s device.  Pass ``plan`` to skip planning."""
    if w.ndim != 2:
        raise ValueError("deploy expects (in_dim, out_dim)")
    codes, sign, scale = quantize_magnitude(w, spec.n_bits)
    if plan is None:
        plan = plan_from_bits(codes_to_bits(codes, spec.n_bits), scale,
                              spec, resolve_pipeline(mode))
    return package_deployment(codes, sign, scale, plan, spec, eta), plan


# Launch geometry of kernel.cu.  The decode form serves M <= DECODE_MAX_M
# rows; a cluster of DECODE_CLUSTER blocks of THREADS threads splits I,
# each block 8 * G columns.  The prefill form tiles (M, N) by
# PREFILL_BM x PREFILL_BN and walks I in slabs of PREFILL_BK.
THREADS = 256
DECODE_MAX_M = 16
DECODE_CLUSTER = 8
DECODE_RM = 4                      # output rows a reduction round
TABLE_MAX = 4096                   # eta*M1 table entries (wpt * 2^K)
PREFILL_BM, PREFILL_BN, PREFILL_BK = 128, 128, 32
PREFILL_STAGES = 3                 # ring of staged x, codes, pos slabs
PREFILL_WLD = PREFILL_BN + 8       # a staged row of W' * gain (floats)
FOLD_COLS = 256                    # the fold: columns a block
FOLD_ROWS = (32, 8, 1)             # the fold: rows a block, widest first
PREFILL_SPLITS = (8, 4, 2)         # folded prefill: splits of I, widest first
# The batched folded decode form: work items of BATCHED_BN columns of a
# member, slabs of BATCHED_BK rows in a ring of BATCHED_STAGES, built for
# BATCHED_BLOCKS blocks a SM; x (16 rows) staged and split at rows of
# BATCHED_XLD floats, Wg at BATCHED_WLD.
BATCHED_BN, BATCHED_BK, BATCHED_STAGES, BATCHED_BLOCKS = 128, 32, 4, 2
BATCHED_WLD, BATCHED_XLD = BATCHED_BN + 8, BATCHED_BK + 4
# The grouped forms.  General (the ragged spec): blocks of GROUPED_BM rows
# of an expert by GROUPED_BN columns, I in slabs of GROUPED_BK rows.
# Decode (cap <= GROUPED_DECODE_MAX_CAP): an (expert, GROUPED_DECODE_BN
# columns) item's slabs of GROUPED_DECODE_BK rows (a row a thread) split
# over a cluster of up to 8 blocks (GROUPED_SPLITS), each thread
# streaming its rows through its own ring of GROUPED_DECODE_STAGES rows,
# GROUPED_DECODE_RB rows of the expert a pass, built for
# GROUPED_DECODE_BLOCKS blocks a SM.  Prefill: an (expert,
# GROUPED_PREFILL_BN columns) item, all of I in slabs of GROUPED_PREFILL_BK
# rows through a ring of GROUPED_PREFILL_STAGES, up to 8 x
# GROUPED_PREFILL_NT rows a pass, GROUPED_PREFILL_KS k steps of 8 a
# rounding group.
GROUPED_BM, GROUPED_BN, GROUPED_BK = 32, 128, 32
GROUPED_DECODE_BN, GROUPED_DECODE_BK, GROUPED_DECODE_STAGES = 128, 16, 8
GROUPED_DECODE_RB, GROUPED_DECODE_BLOCKS = 4, 3
GROUPED_PREFILL_BN, GROUPED_PREFILL_BK, GROUPED_PREFILL_STAGES = 128, 32, 4
GROUPED_PREFILL_NT, GROUPED_PREFILL_KS = 16, 2
GROUPED_SPLITS = (8, 4, 2)
GROUPED_DECODE_MAX_CAP = 32
# The grouped folded forms (a bank folded at deploy).  Decode (cap <=
# GROUPED_FOLDED_DECODE_MAX_CAP): the grouped decode form's items, row
# slices and passes over the fold, I split GROUPED_FOLDED_DECODE_SPLIT
# ways, a thread's two 4-column Wg pieces of a row through its own ring of
# GROUPED_FOLDED_DECODE_STAGES rows, built for
# GROUPED_FOLDED_DECODE_BLOCKS blocks a SM.  Prefill (above): the grouped
# prefill form's items, passes and split over the fold, a ring of
# GROUPED_FOLDED_PREFILL_STAGES (Wg slab, raw x) stages, staged Wg rows of
# GROUPED_FOLDED_PREFILL_WLD floats with f32 x, _WLDB with bf16 x.  The
# first, general form where the decode form's x slab does not fit, and
# for a noiseless read whose (expert, column tile) items alone fill the
# card.
GROUPED_FOLDED_DECODE_STAGES, GROUPED_FOLDED_DECODE_BLOCKS = 4, 3
GROUPED_FOLDED_DECODE_SPLIT = 4    # its split of I (PERF.md, row 1h)
GROUPED_FOLDED_PREFILL_STAGES = 4
GROUPED_FOLDED_PREFILL_WLD = GROUPED_PREFILL_BN + 8
GROUPED_FOLDED_PREFILL_WLDB = GROUPED_PREFILL_BN + 4
GROUPED_FOLDED_DECODE_MAX_CAP = 32
SMEM_MAX = 227 * 1024
SM_SMEM = 228 * 1024      # an SM's shared memory, 1 KB of it reserved a block
# kernel.cu's Geom.form: the ideal forms, the folded forms, the fold, the
# batched folded decode form, the grouped forms (general, decode,
# prefill), the grouped folded forms (general, decode, prefill).
FORM_DECODE, FORM_PREFILL, FORM_DECODE_FOLDED, FORM_PREFILL_FOLDED, \
    FORM_FOLD, FORM_DECODE_BATCHED, FORM_GROUPED, FORM_GROUPED_DECODE, \
    FORM_GROUPED_PREFILL, FORM_GROUPED_FOLDED, FORM_GROUPED_FOLDED_DECODE, \
    FORM_GROUPED_FOLDED_PREFILL = range(12)
GROUPED_FOLDED_FORMS = (FORM_GROUPED_FOLDED, FORM_GROUPED_FOLDED_DECODE,
                        FORM_GROUPED_FOLDED_PREFILL)
# The fields of kernel.cu's ``Geom``, in order.
_GEOM_FIELDS = ("form", "M", "I", "N", "n_pad", "n_tiles", "wpt", "n_bits",
                "cols", "reversed", "fast", "tile", "rps", "gx", "gy", "gz",
                "smem", "off_t", "off_p", "mt", "xbf16", "ld", "noise",
                "rows", "n_ti", "cp_ti", "cp_tn", "experts")


def _table(wpt: int, n_bits: int) -> int:
    """Entries of the eta*M1 table: a row of 2^K a slot."""
    return wpt << n_bits


def _fast(aligned, n_pad, wpt, n_bits) -> bool:
    """16-byte code loads, one pos per 8 columns, the eta*M1 table."""
    return (aligned and n_pad % 8 == 0 and wpt % 8 == 0
            and _table(wpt, n_bits) <= TABLE_MAX)


def folded_ld(n_pad: int) -> int:
    """Row stride of a folded deployment: n_pad rounded up to 8 (a
    thread's 8 columns in two 16-byte loads)."""
    return -(-n_pad // 8) * 8


def _cps_stride(cols: int) -> int:
    """Entries of a tile's col_pos row in shared memory: ``cols`` rounded
    up to 4, plus 4 (16-byte rows, spread over the banks)."""
    return runtime.round4(cols) + 4


def _span_tiles(length: int, stride: int, end: int, unit: int) -> int:
    """The most tiles of ``unit`` that one span [a, min(a + length, end))
    covers, over the spans a = 0, stride, 2 * stride, ... below end."""
    most = 0
    for a in range(0, end, stride):
        b = min(a + length, end)
        most = max(most, (b - 1) // unit - a // unit + 1)
    return most


def _decode_geometry(M, I, n_cols, wpt, n_bits, sm_count, fast, folded):
    """Decode-form fields over ``n_cols`` columns (n_pad, or the folded
    rows' ld), or None where its shared memory would not fit (a very long
    I)."""
    mt = 1 << (M - 1).bit_length()
    # The widest block (G column groups of 8) that still gives two
    # blocks a SM; else G = 8.
    for G in (32, 16, 8):
        gx = math.ceil(n_cols / (8 * G))
        if gx * DECODE_CLUSTER >= 2 * sm_count:
            break
    rps = math.ceil(I / DECODE_CLUSTER)
    # x slab [rps][mt], reused for the slices' sums [KS][RM][8G]; the
    # eta*M1 table (the ideal form's 16-byte path); the block's sums
    # [mt][8G] (offsets in floats).
    slab = max(rps * mt, (THREADS // G) * DECODE_RM * 8 * G)
    off_t = runtime.round4(slab)
    region = _table(wpt, n_bits) if fast and not folded else 0
    off_p = off_t + runtime.round4(region)
    smem = 4 * (off_p + mt * 8 * G)
    if smem > SMEM_MAX:
        return None
    return dict(form=FORM_DECODE_FOLDED if folded else FORM_DECODE,
                fast=int(fast and not folded), tile=G, rps=rps, gx=gx,
                gy=DECODE_CLUSTER, gz=1, smem=smem, off_t=off_t,
                off_p=off_p, mt=mt)


def _prefill_geometry(M, I, N, wpt, n_bits, sm_count, fast, folded):
    """Prefill-form fields (any M and I).  The folded form splits I ``gz``
    ways (a cluster of gz blocks) where one block a (gx, gy) tile would
    leave SMs idle: the widest split whose blocks all fit one at a time
    on the SMs, each with a slab of I at least."""
    bm, bn, bk = PREFILL_BM, PREFILL_BN, PREFILL_BK
    # x as TF32 hi / lo parts, two buffers; the ideal form: the rows'
    # factors, two buffers, a ring of staged raw x, codes and pos slabs,
    # then the eta*M1 table (the 16-byte code path); the folded form: a
    # ring of staged raw x and W' * gain slabs.
    x_parts = 2 * 2 * bm * bk * 4
    if folded:
        stage = bm * (bk + 4) * 4 + bk * PREFILL_WLD * 4
        smem = x_parts + PREFILL_STAGES * stage
    else:
        stage = bm * (bk + 4) * 4 + bk * (bn + 8) * 2 + bk * (bn // 8) * 4
        base = x_parts + 2 * bk * (bn // 8) * 4 + PREFILL_STAGES * stage
        table = 4 * _table(wpt, n_bits)
        if fast and base + table > SMEM_MAX:
            fast = False
        smem = base + (table if fast else 0)
    gx, gy, gz = math.ceil(N / bn), math.ceil(M / bm), 1
    if folded:
        gz = next((s for s in PREFILL_SPLITS
                   if gx * gy * s <= sm_count and math.ceil(I / bk) >= s), 1)
    return dict(form=FORM_PREFILL_FOLDED if folded else FORM_PREFILL,
                fast=int(fast and not folded), tile=bn, rps=0, gx=gx, gy=gy,
                gz=gz, smem=smem, off_t=0, off_p=0, mt=0)


@functools.lru_cache(maxsize=None)
def cim_geometry(M: int, I: int, N: int, i_pad: int, n_pad: int, wpt: int,
                 n_bits: int, cols: int, reversed_df: bool, sm_count: int,
                 aligned: bool, xbf16: bool = False, folded: bool = False,
                 noise: bool = False) -> runtime.Geometry:
    """The launch of ``cim_mvm`` for x (M, I) and a deployment with
    (i_pad, n_pad) codes, on a card with ``sm_count`` SMs; ``aligned``
    says whether the codes start on 16 bytes, ``xbf16`` whether x is
    bf16, ``folded`` whether the call reads the folded W' * gain (rows of
    ``folded_ld(n_pad)`` floats) and ``noise`` whether it draws read
    noise (folded only).  Cached per shape: a decode step pays for it
    once per matrix shape.

    Decode forms (M <= 16): grid (gx, 8), cluster rank r sums the rows
    [r*rps, min((r+1)*rps, I)), slice s of a block the rows r*rps + s +
    KS*j (KS = 256 / G).  Prefill forms: grid (ceil(N/128),
    ceil(M/128), gz), each block all of I in slabs of 32 rows (the folded
    form: the slabs [s * z / gz, s * (z + 1) / gz) of the s slabs, in a
    cluster of gz blocks).  ``fast`` (the ideal forms): 16-byte code
    loads and one pos per 8 columns (wpt % 8 == 0, n_pad % 8 == 0)."""
    if noise and not folded:
        raise ValueError("cim_geometry: read noise is drawn by the folded "
                         "forms only")
    fast = _fast(aligned, n_pad, wpt, n_bits)
    ld = folded_ld(n_pad) if folded else 0
    g = _decode_geometry(M, I, ld or n_pad, wpt, n_bits, sm_count, fast,
                         folded) if M <= DECODE_MAX_M else None
    if g is None:
        g = _prefill_geometry(M, I, N, wpt, n_bits, sm_count, fast, folded)
    g.update(M=M, I=I, N=N, n_pad=n_pad, n_tiles=n_pad // wpt, wpt=wpt,
             n_bits=n_bits, cols=cols, reversed=int(reversed_df),
             xbf16=int(xbf16), ld=ld, noise=int(noise), rows=0, n_ti=0,
             cp_ti=0, cp_tn=0, experts=0)
    return runtime.Geometry.of(_GEOM_FIELDS, g)


@functools.lru_cache(maxsize=None)
def batched_geometry(members: int, M: int, I: int, N: int, i_pad: int,
                     n_pad: int, wpt: int, n_bits: int, cols: int,
                     reversed_df: bool, sm_count: int, xbf16: bool = False,
                     noise: bool = False) -> runtime.Geometry:
    """The batched folded decode form's launch: ``members`` deployments of
    one shape, x (members, M, I) with M <= DECODE_MAX_M.  Work items are
    (member, BATCHED_BN columns), member-major; gx persistent blocks, in
    clusters of gy, take every (gx / gy)-th item.  Where the items would
    leave SMs idle, a cluster of gy blocks splits the n_slabs slabs of I
    (rank r the slabs [n_slabs * r / gy, n_slabs * (r + 1) / gy)): the
    widest split whose blocks fit BATCHED_BLOCKS a SM, each with a slab."""
    if not 1 <= M <= DECODE_MAX_M:
        raise ValueError(f"the batched cim_mvm form takes 1..{DECODE_MAX_M} "
                         f"rows a member, not {M}")
    items = members * math.ceil(N / BATCHED_BN)
    slots = BATCHED_BLOCKS * sm_count
    split = next((s for s in PREFILL_SPLITS if items * s <= slots
                  and math.ceil(I / BATCHED_BK) >= s), 1)
    # The ring (Wg slab and x slab a stage), x's split hi / lo parts in
    # two buffers, and a split's partial sums [16][BATCHED_BN].
    ring = BATCHED_STAGES * (BATCHED_BK * BATCHED_WLD + 16 * BATCHED_XLD)
    floats = ring + 4 * 16 * BATCHED_XLD + (
        16 * BATCHED_BN if split > 1 else 0)
    g = dict(form=FORM_DECODE_BATCHED, M=M, I=I, N=N, n_pad=n_pad,
             n_tiles=n_pad // wpt, wpt=wpt, n_bits=n_bits, cols=cols,
             reversed=int(reversed_df), fast=0, tile=BATCHED_BN, rps=0,
             gx=min(items, slots // split) * split, gy=split, gz=members,
             smem=4 * floats, off_t=0, off_p=0, mt=DECODE_MAX_M,
             xbf16=int(xbf16), ld=folded_ld(n_pad), noise=int(noise),
             rows=0, n_ti=0, cp_ti=0, cp_tn=0, experts=0)
    return runtime.Geometry.of(_GEOM_FIELDS, g)


def _grouped_decode_geometry(I: int, wpt: int, n_bits: int):
    """The grouped decode form's split of I and shared memory, or None
    where its x slab would not fit (a very long I)."""
    bk, bn, rb = GROUPED_DECODE_BK, GROUPED_DECODE_BN, GROUPED_DECODE_RB
    n_slabs = math.ceil(I / bk)
    split = next((s for s in GROUPED_SPLITS if n_slabs >= 4 * s), 1)
    rps = math.ceil(n_slabs / split) * bk
    # The threads' rings (16 code bytes and a pos word a row), later the
    # row slices' sums [16][RB][BN]; the eta*M1 table; the x slab
    # [rps][RB]; the part [RB][BN] (offsets in floats).
    off_t = GROUPED_DECODE_STAGES * THREADS * (16 + 4) // 4
    off_p = off_t + runtime.round4(_table(wpt, n_bits))
    smem = 4 * (off_p + rps * rb + rb * bn)
    if smem > SMEM_MAX:
        return None
    return dict(form=FORM_GROUPED_DECODE, tile=bn, rps=rps, gy=split,
                smem=smem, off_t=off_t, off_p=off_p, mt=rb)


def _grouped_prefill_split(experts: int, cap: int, I: int, N: int,
                           xbf16: bool, assignments: int | None,
                           sm_count: int) -> int:
    """The grouped prefill forms' split of I: where x's rows, each expert
    at its capacity, would fill fewer experts' column tiles than the
    blocks the card holds at once (two a SM with bf16 x, one with f32),
    the widest of 8, 4, 2 that still fits them, each rank with two
    slabs; else 1."""
    gx = math.ceil(N / GROUPED_PREFILL_BN)
    fill = experts if assignments is None else min(
        experts, max(1, math.ceil((assignments - 1) / cap)))
    slots = (2 if xbf16 else 1) * sm_count
    return next((s for s in GROUPED_SPLITS if fill * gx * s <= slots
                 and math.ceil(I / GROUPED_PREFILL_BK) >= 2 * s), 1)


def _grouped_x_row(xbf16: bool) -> int:
    """Bytes of a staged row of raw x in the grouped prefill forms."""
    bk = GROUPED_PREFILL_BK
    return (bk + 8) * 2 if xbf16 else (bk + 4) * 4


def _grouped_prefill_geometry(experts: int, cap: int, I: int, N: int,
                              wpt: int, n_bits: int, xbf16: bool,
                              assignments: int | None, sm_count: int):
    """The grouped prefill form's split of I (:func:`_grouped_prefill_split`)
    and shared memory: a ring of (codes, pos, raw x) slabs, then the eta*M1
    table."""
    bk, bn, rows = (GROUPED_PREFILL_BK, GROUPED_PREFILL_BN,
                    8 * GROUPED_PREFILL_NT)
    stage = (bk * (bn + 8) * 2 + bk * (bn // 8 + 4) * 4
             + rows * _grouped_x_row(xbf16))
    return dict(form=FORM_GROUPED_PREFILL, tile=bn, rps=0,
                gy=_grouped_prefill_split(experts, cap, I, N, xbf16,
                                          assignments, sm_count),
                smem=GROUPED_PREFILL_STAGES * stage + 4 * _table(wpt, n_bits),
                off_t=0, off_p=0, mt=0)


@functools.lru_cache(maxsize=None)
def grouped_geometry(experts: int, cap: int, I: int, N: int, n_pad: int,
                     wpt: int, n_bits: int, cols: int, reversed_df: bool,
                     aligned: bool, xbf16: bool = False,
                     assignments: int | None = None,
                     sm_count: int = 132) -> runtime.Geometry:
    """The grouped ideal forms' launch: ``experts`` deployments of one
    shape, each computing at most ``cap`` rows of x (``assignments`` rows,
    default unknown).  On the 16-byte path (``fast``: ``aligned`` codes,
    wpt and n_pad multiples of 8, the eta*M1 table in shared memory):

    * the decode form for cap <= GROUPED_DECODE_MAX_CAP (a few rows an
      expert): grid (ceil(N / 128), gy, slots) in clusters of (1, gy, 1),
      rank r of gy the slabs [s r / gy, s (r + 1) / gy) of the s slabs of
      16 rows of I (gy the widest of 8, 4, 2 that leaves each rank four
      slabs: four rows a thread), up to GROUPED_DECODE_RB rows of an
      expert a pass;
    * the prefill form above it: grid (ceil(N / 128), gy, slots) in
      clusters of (1, gy, 1), a block all of an expert's rows (up to 128 a
      pass) and rank r of gy the slabs [s r / gy, s (r + 1) / gy) of the s
      slabs of 32 rows of I; gy > 1 only where the assignments, each
      expert at its capacity, fill too few experts to occupy the card's
      ``sm_count`` SMs (one expert at the capacity: gy = 8).

    ``slots`` is min(experts, assignments): block z of a launch computes
    the z-th expert that has a row.  The threshold: each routing of
    ``cim_ab.py --grouped --forms`` forced onto each form at qwen2-moe's
    expert shapes on the H100 (PERF.md, row 1g), the decode form took
    about half the prefill form's time at cap 16 and 32, the prefill
    form about a fifth of the decode form's at cap 128.
    Elsewhere (the ragged spec) the general form: grid (ceil(N / 128),
    ceil(cap / 32), experts), a slab of x (32 x 32) and of W' (32 x 128)
    in shared memory."""
    fast = _fast(aligned, n_pad, wpt, n_bits)
    slots = experts if assignments is None else min(experts, assignments)
    g = _grouped_decode_geometry(I, wpt, n_bits) \
        if fast and cap <= GROUPED_DECODE_MAX_CAP else None
    if g is None and fast:
        g = _grouped_prefill_geometry(experts, cap, I, N, wpt, n_bits, xbf16,
                                      assignments, sm_count)
    if g is None:
        g = dict(form=FORM_GROUPED, tile=GROUPED_BN, rps=0,
                 gy=math.ceil(cap / GROUPED_BM),
                 smem=4 * GROUPED_BK * (GROUPED_BM + GROUPED_BN), off_t=0,
                 off_p=0, mt=0)
        slots = experts
    g.update(M=cap, I=I, N=N, n_pad=n_pad, n_tiles=n_pad // wpt, wpt=wpt,
             n_bits=n_bits, cols=cols, reversed=int(reversed_df),
             fast=int(fast), gx=math.ceil(N / g["tile"]), gz=slots,
             xbf16=int(xbf16), ld=0, noise=0, rows=0, n_ti=0, cp_ti=0,
             cp_tn=0, experts=experts)
    return runtime.Geometry.of(_GEOM_FIELDS, g)


def _grouped_folded_decode_geometry(I: int):
    """The grouped folded decode form's split of I and shared memory, or
    None where no split's x slab fits.  The split: the widest of 4 and 2
    that leaves each rank four slabs (else 1), or 8 where that one's x
    slab would not let GROUPED_FOLDED_DECODE_BLOCKS blocks share an SM."""
    bk, bn, rb = GROUPED_DECODE_BK, GROUPED_DECODE_BN, GROUPED_DECODE_RB
    n_slabs = math.ceil(I / bk)
    splits = [s for s in GROUPED_SPLITS + (1,) if s == 1 or n_slabs >= 4 * s]
    prefer = next(s for s in splits if s <= GROUPED_FOLDED_DECODE_SPLIT)
    # The threads' rings (two 4-column Wg pieces a row), later the row
    # slices' sums [16][RB][BN]; the x slab [rps][RB]; the part [RB][BN]
    # (offsets in floats).
    off_p = GROUPED_FOLDED_DECODE_STAGES * THREADS * 32 // 4
    for split in sorted(s for s in splits if s >= prefer):
        rps = math.ceil(n_slabs / split) * bk
        smem = 4 * (off_p + rps * rb + rb * bn)
        if GROUPED_FOLDED_DECODE_BLOCKS * (smem + 1024) <= SM_SMEM:
            return dict(form=FORM_GROUPED_FOLDED_DECODE, tile=bn, rps=rps,
                        gy=split, smem=smem, off_p=off_p, mt=rb)
    return None


def _grouped_folded_prefill_geometry(experts, cap, I, N, xbf16, assignments,
                                     sm_count):
    """The grouped folded prefill form's split of I (the grouped prefill
    form's) and shared memory: a ring of (Wg slab, raw x) stages."""
    bk, rows = GROUPED_PREFILL_BK, 8 * GROUPED_PREFILL_NT
    wld = GROUPED_FOLDED_PREFILL_WLDB if xbf16 else GROUPED_FOLDED_PREFILL_WLD
    stage = bk * wld * 4 + rows * _grouped_x_row(xbf16)
    return dict(form=FORM_GROUPED_FOLDED_PREFILL, tile=GROUPED_PREFILL_BN,
                rps=0, gy=_grouped_prefill_split(experts, cap, I, N, xbf16,
                                                 assignments, sm_count),
                smem=GROUPED_FOLDED_PREFILL_STAGES * stage, off_p=0, mt=0)


@functools.lru_cache(maxsize=None)
def grouped_folded_geometry(experts: int, cap: int, I: int, N: int,
                            n_pad: int, xbf16: bool = False,
                            noise: bool = False,
                            assignments: int | None = None,
                            sm_count: int = 132,
                            form: int | None = None) -> runtime.Geometry:
    """The grouped folded forms' launch: ``experts`` folded deployments
    of one shape (rows of ``folded_ld(n_pad)`` floats), each computing at
    most ``cap`` rows of x (``assignments`` rows, default unknown);
    ``noise`` whether the read draws noise.  ``slots`` = min(experts,
    assignments): block z computes the z-th expert that has a row.

    * the decode form for cap <= GROUPED_FOLDED_DECODE_MAX_CAP: grid
      (ceil(N / 128), gy, slots) in clusters of (1, gy, 1), slabs of 16
      rows of I split gy ways (:func:`_grouped_folded_decode_geometry`),
      passes of up to 4 rows;
    * the prefill form above it: grid (ceil(N / 128), gy, slots) in
      clusters of (1, gy, 1), a block all of an expert's rows (up to 128
      a pass) over slabs of 32 rows of I, split only where the rows fill
      too few experts to occupy the card's ``sm_count`` SMs;
    * the general (first) form where the decode form's x slab does not
      fit, and at cap <= GROUPED_FOLDED_DECODE_MAX_CAP for a noiseless
      read whose slots x column tiles fill the blocks the card holds of
      the decode form (there it measured faster: PERF.md, row 1h): grid
      (ceil(N / 128), ceil(cap / 32), slots) of 32-row by 128-column
      blocks, a slab of x (32 x 32) and of W_eff (32 x 128) in shared
      memory.

    ``form`` forces one of GROUPED_FOLDED_FORMS (tests and A/B timing);
    a forced form that refuses the shape raises ``ValueError``.  The
    threshold: see ``PERF.md`` row 1h."""
    slots = experts if assignments is None else min(experts, assignments)
    forced = form is not None
    if not forced:
        items = slots * math.ceil(N / GROUPED_DECODE_BN)
        form = (FORM_GROUPED_FOLDED_PREFILL
                if cap > GROUPED_FOLDED_DECODE_MAX_CAP
                else FORM_GROUPED_FOLDED_DECODE
                if noise or items < GROUPED_FOLDED_DECODE_BLOCKS * sm_count
                else FORM_GROUPED_FOLDED)
    if form not in GROUPED_FOLDED_FORMS:
        raise ValueError(f"form {form} is not a grouped folded form "
                         f"{GROUPED_FOLDED_FORMS}")
    g = None
    if form == FORM_GROUPED_FOLDED_DECODE:
        g = _grouped_folded_decode_geometry(I)
        if g is None and forced:
            raise ValueError(f"the grouped folded decode form's x slab does "
                             f"not fit in shared memory at I = {I}")
    elif form == FORM_GROUPED_FOLDED_PREFILL:
        g = _grouped_folded_prefill_geometry(experts, cap, I, N, xbf16,
                                             assignments, sm_count)
    if g is None:
        g = dict(form=FORM_GROUPED_FOLDED, tile=GROUPED_BN, rps=0,
                 gy=math.ceil(cap / GROUPED_BM),
                 smem=4 * GROUPED_BK * (GROUPED_BM + GROUPED_BN), off_p=0,
                 mt=0)
    g.update(M=cap, I=I, N=N, n_pad=n_pad, n_tiles=0, wpt=0, n_bits=0,
             cols=0, reversed=0, fast=0, gx=math.ceil(N / g["tile"]),
             gz=slots, off_t=0, xbf16=int(xbf16), ld=folded_ld(n_pad),
             noise=int(noise), rows=0, n_ti=0, cp_ti=0, cp_tn=0,
             experts=experts)
    return runtime.Geometry.of(_GEOM_FIELDS, g)


@functools.lru_cache(maxsize=None)
def fold_geometry(i_pad: int, n_pad: int, wpt: int, n_bits: int, cols: int,
                  reversed_df: bool, aligned: bool, rows: int = 0
                  ) -> runtime.Geometry:
    """The fold kernel's launch for (i_pad, n_pad) codes: grid
    (ceil(ld / 256), ceil(i_pad / rps)), a block ``rps`` rows by 256
    columns (32 threads of 8 columns, 8 rows at a time).  ``rows``: the
    crossbar rows of a tile where the deployment has col_pos (0: none);
    the col_pos tiles a block touches (cp_ti x cp_tn) go to shared
    memory, ``rps`` the most rows (of 32, 8, 1) whose tiles fit.
    ``fast``: 16-byte code and gain loads (``aligned``: both start on 16
    bytes), one pos a row and, without col_pos, the eta*M1 table."""
    colp = rows > 0
    ld = folded_ld(n_pad)
    fast = (aligned and n_pad % 8 == 0 and wpt % 8 == 0
            and (colp or _table(wpt, n_bits) <= TABLE_MAX))
    for rps in FOLD_ROWS:
        cp_ti = _span_tiles(rps, rps, i_pad, rows) if colp else 0
        cp_tn = _span_tiles(FOLD_COLS, FOLD_COLS, n_pad, wpt) if colp else 0
        smem = 4 * (cp_ti * cp_tn * _cps_stride(cols) if colp
                    else _table(wpt, n_bits) if fast else 0)
        if smem <= SMEM_MAX:
            break
    else:
        raise ValueError(f"cim_mvm fold: col_pos tiles of {rows} rows do "
                         f"not fit in shared memory ({smem} bytes)")
    g = dict(form=FORM_FOLD, M=0, I=i_pad, N=n_pad, n_pad=n_pad,
             n_tiles=n_pad // wpt, wpt=wpt, n_bits=n_bits, cols=cols,
             reversed=int(reversed_df), fast=int(fast), tile=0, rps=rps,
             gx=math.ceil(ld / FOLD_COLS), gy=math.ceil(i_pad / rps), gz=1,
             smem=smem, off_t=0, off_p=0, mt=0, xbf16=0, ld=ld, noise=0,
             rows=rows, n_ti=i_pad // rows if colp else 0, cp_ti=cp_ti,
             cp_tn=cp_tn, experts=0)
    return runtime.Geometry.of(_GEOM_FIELDS, g)


def occupancy(geom: runtime.Geometry) -> dict:
    """Occupancy of the kernel that a launch with ``geom`` runs
    (:func:`cim_geometry`, :func:`fold_geometry`, :func:`batched_geometry`,
    :func:`grouped_geometry`, :func:`grouped_folded_geometry`), from the CUDA
    runtime's occupancy calculator: ``blocks_per_sm`` resident blocks a
    SM and, for a cluster launch, ``clusters`` the card holds at once
    (else None)."""
    out = (ctypes.c_int * 2)()
    rc = runtime.library().cim_occupancy(geom.array, out)
    runtime.check_status("cim_mvm occupancy", rc)
    return dict(blocks_per_sm=out[0], clusters=out[1] or None)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def read_noise_amplitude(dep: CimDeployment) -> float:
    """sigma_read * sqrt((1 - 4^-K) / 3): the per-weight read-noise std
    before the scale, the first-order aggregate of K independent bit
    planes (the reference's ``cim_mvm_xla``)."""
    return dep.sigma_read * float(((1.0 - 4.0 ** -dep.n_bits) / 3.0) ** 0.5)


def noisy(dep: CimDeployment, read_seed) -> bool:
    """Does this read of ``dep`` draw read noise?"""
    return (read_seed is not None and dep.sigma_read > 0.0
            and dep.noise_tag is not None)


def needs_fold(dep: CimDeployment) -> bool:
    """Does ``dep`` carry a gain, a col_pos or read noise (so that the
    kernel reads it folded)?"""
    return (dep.gain is not None or dep.col_pos is not None
            or (dep.sigma_read > 0.0 and dep.noise_tag is not None))


def _check_codes(dep: CimDeployment) -> None:
    codes, pos, scale = dep.codes, dep.pos, dep.scale
    if codes.dtype != torch.int16 or pos.dtype != torch.int32 \
            or scale.dtype != torch.float32:
        raise TypeError("cim_mvm kernel takes int16 codes, int32 pos and "
                        "an f32 scale")
    i_pad, n_pad = codes.shape
    if pos.shape != (i_pad, n_pad // dep.wpt) or scale.numel() != 1:
        raise ValueError(f"pos {tuple(pos.shape)} / scale "
                         f"{tuple(scale.shape)} do not fit codes "
                         f"{tuple(codes.shape)}")
    if not (codes.is_contiguous() and pos.is_contiguous()):
        raise ValueError("cim_mvm kernel takes contiguous codes and pos")
    if dep.n_bits > 16 or dep.cols << dep.n_bits >= 1 << 24:
        raise ValueError("cim_mvm kernel takes n_bits <= 16 and "
                         "cols * 2^n_bits < 2^24 (exact integer moments)")


def _fold_launch(dep: CimDeployment) -> torch.Tensor:
    _check_codes(dep)
    codes, gain, col_pos = dep.codes, dep.gain, dep.col_pos
    i_pad, n_pad = codes.shape
    aligned = codes.data_ptr() % 16 == 0
    if gain is not None:
        if gain.dtype != torch.float32 or gain.shape != codes.shape \
                or not gain.is_contiguous():
            raise ValueError("cim_mvm fold takes a contiguous f32 gain "
                             "shaped like the codes")
        aligned = aligned and gain.data_ptr() % 16 == 0
    rows = 0
    if col_pos is not None:
        if col_pos.dtype != torch.int32 or not col_pos.is_contiguous() \
                or col_pos.ndim != 3 \
                or col_pos.shape[1] != n_pad // dep.wpt \
                or col_pos.shape[2] != dep.cols \
                or i_pad % col_pos.shape[0]:
            raise ValueError(f"col_pos {tuple(col_pos.shape)} does not fit "
                             f"codes {tuple(codes.shape)}")
        rows = i_pad // col_pos.shape[0]
    geom = fold_geometry(i_pad, n_pad, dep.wpt, dep.n_bits, dep.cols,
                         dep.reversed_df, aligned, rows)
    out = torch.empty((i_pad, geom.ld), dtype=torch.float32,
                      device=codes.device)
    if out.numel() == 0:
        return out
    rc = runtime.library().cim_fold_launch(
        codes.data_ptr(), dep.pos.data_ptr(), dep.scale.data_ptr(),
        None if gain is None else gain.data_ptr(),
        None if col_pos is None else col_pos.data_ptr(), out.data_ptr(),
        geom.array, dep.eta, runtime.stream_arg(out.device))
    runtime.count_launch("cim_fold")
    runtime.check_status("cim_fold", rc)
    return out


def fold_weights(dep: CimDeployment) -> torch.Tensor:
    """W'(col_pos) * gain of one (unstacked) deployment as (I_pad, ld)
    f32 with zero columns past N_pad, on the codes' device: the fold
    kernel on CUDA tensors, its plain version (bit-identical) on the
    CPU."""
    if dep.codes.device.type == "cpu":
        return folded_weights(dep)
    return _fold_launch(dep)


def fold(dep: CimDeployment) -> CimDeployment:
    """A copy of ``dep`` with its ``folded`` W'(col_pos) * gain
    (:func:`fold_weights`), which the kernel's folded forms read instead
    of the codes, pos, gain and col_pos."""
    out = dataclasses.replace(dep)
    out.folded = fold_weights(dep)
    return out


def _launch(x: torch.Tensor, dep: CimDeployment,
            read_seed: int | None) -> torch.Tensor:
    codes, wf = dep.codes, dep.folded
    i_pad, n_pad = codes.shape
    if wf is None:
        if needs_fold(dep):
            raise ValueError("cim_mvm kernel: a deployment with a gain, a "
                             "col_pos or read noise is read folded; fold "
                             "it first (ops.fold)")
        _check_codes(dep)
    elif wf.dtype != torch.float32 or wf.shape != (i_pad, folded_ld(n_pad)) \
            or not wf.is_contiguous() or wf.data_ptr() % 16 \
            or dep.scale.dtype != torch.float32 or dep.scale.numel() != 1:
        raise ValueError(f"cim_mvm kernel takes a contiguous 16-byte aligned "
                         f"f32 folded W' of {(i_pad, folded_ld(n_pad))} and "
                         f"an f32 scale, not {tuple(wf.shape)}")
    nsig, seed, tag = 0.0, 0, 0
    noise = wf is not None and noisy(dep, read_seed)
    if noise:
        nsig = read_noise_amplitude(dep)
        seed, tag = int(read_seed) & 0xFFFFFFFF, int(dep.noise_tag) & 0xFFFFFFFF
    M, I, N = x.shape[0], dep.in_dim, dep.out_dim
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    geom = cim_geometry(M, I, N, i_pad, n_pad, dep.wpt, dep.n_bits,
                        dep.cols, dep.reversed_df,
                        _sm_count(x.device.index or 0),
                        codes.data_ptr() % 16 == 0,
                        x.dtype == torch.bfloat16, wf is not None, noise)
    rc = runtime.library().cim_mvm_launch(
        x.data_ptr(), codes.data_ptr(), dep.pos.data_ptr(),
        dep.scale.data_ptr(), out.data_ptr(), geom.array, dep.eta,
        None if wf is None else wf.data_ptr(), seed, tag, nsig,
        runtime.stream_arg(out.device))
    runtime.count_launch("cim_mvm")
    runtime.check_status("cim_mvm", rc)
    return out


def _launch_batched(x: torch.Tensor, dep: CimDeployment,
                    read_seed: int | None, reps: list[int]) -> torch.Tensor:
    wf = dep.folded
    R, i_pad, n_pad = dep.codes.shape
    ld = folded_ld(n_pad)
    if wf is None or wf.dtype != torch.float32 or wf.shape != (R, i_pad, ld) \
            or not wf.is_contiguous() or wf.data_ptr() % 16 \
            or dep.scale.dtype != torch.float32 or dep.scale.shape != (R,) \
            or not dep.scale.is_contiguous():
        raise ValueError("the batched cim_mvm form takes a stacked folded "
                         f"deployment: folded (R, I_pad, ld) = "
                         f"{(R, i_pad, ld)} contiguous f32 on 16 bytes and "
                         "scale (R,) f32")
    G, M = x.shape[0], x.shape[1]
    if not all(0 <= r < R for r in reps):
        raise ValueError(f"members {reps} out of the stack's {R} repeats")
    noise = noisy(dep, read_seed)
    seed = int(read_seed) & 0xFFFFFFFF if noise else 0
    dev = x.device
    rep_t = torch.tensor(reps, dtype=torch.int32, device=dev)
    tags = (dep.noise_tag.reshape(-1)[reps].to(dev, torch.int32)
            if noise else None)
    out = torch.empty((G, M, dep.out_dim), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    geom = batched_geometry(G, M, dep.in_dim, dep.out_dim, i_pad, n_pad,
                            dep.wpt, dep.n_bits, dep.cols, dep.reversed_df,
                            _sm_count(dev.index or 0),
                            x.dtype == torch.bfloat16, noise)
    rc = runtime.library().cim_mvm_batched_launch(
        x.data_ptr(), wf.data_ptr(), i_pad * ld, dep.scale.data_ptr(),
        rep_t.data_ptr(), None if tags is None else tags.data_ptr(),
        out.data_ptr(), geom.array, seed,
        read_noise_amplitude(dep) if noise else 0.0,
        runtime.stream_arg(dev))
    runtime.count_launch("cim_mvm_batched")
    runtime.check_status("cim_mvm_batched", rc)
    return out


def cim_mvm_batched(x: torch.Tensor, dep: CimDeployment,
                    read_seed: int | None = None, members=None,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """y[g] = x[g] @ W_effective of member g of a stacked deployment, in
    one launch: the counterpart of the reference's ``jax.vmap(cim_mvm)``
    over a stacked group.

    x: (G, M, in_dim) f32 or bf16 (other types are cast to f32), M <=
    ``DECODE_MAX_M``; ``dep``: a stacked deployment (a leading repeat
    axis), folded (:func:`fold`, or ``repro_torch.deploy`` at deploy);
    ``members``: the G repeats read, in order (default all; need not be
    consecutive).  Each member reads with its own noise tag under one
    ``read_seed``, as :func:`cim_mvm` does.  Returns (G, M, out_dim) f32:
    the batched folded decode form on CUDA, its plain version (a loop of
    :func:`cim_mvm`'s) on the CPU.
    """
    dev = resolve_device(device)
    check_on(dev, x=x, codes=dep.codes, scale=dep.scale, folded=dep.folded)
    reps = (list(range(dep.codes.shape[0])) if members is None
            else [int(r) for r in members])
    if x.ndim != 3 or x.shape[0] != len(reps) or x.shape[2] != dep.in_dim:
        raise ValueError(f"x {tuple(x.shape)} is not ({len(reps)}, M, "
                         f"{dep.in_dim})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    if dev.type == "cpu":
        return cim_mvm_batched_plain(x, dep, read_seed, reps)
    return _launch_batched(x, dep, read_seed, reps)


def _launch_grouped_folded(x: torch.Tensor, dep: CimDeployment,
                           offsets: torch.Tensor, cap: int,
                           read_seed: int | None,
                           form: int | None = None) -> torch.Tensor:
    wf, scale = dep.folded, dep.scale
    E, i_pad, n_pad = dep.codes.shape
    ld = folded_ld(n_pad)
    if wf.dtype != torch.float32 or wf.shape != (E, i_pad, ld) \
            or not wf.is_contiguous() or wf.data_ptr() % 16 \
            or scale.dtype != torch.float32 or scale.shape != (E,) \
            or not scale.is_contiguous():
        raise ValueError("the grouped folded cim_mvm form takes folded (E, "
                         f"I_pad, ld) = {(E, i_pad, ld)} contiguous f32 on "
                         "16 bytes and scale (E,) f32")
    noise = noisy(dep, read_seed)
    tags = dep.device_tags
    if noise and (tags is None or tags.dtype != torch.int32
                  or tags.shape != (E,) or not tags.is_contiguous()):
        raise ValueError("a noisy read of an expert bank takes its tags on "
                         "the device: device_tags (E,) int32, set at deploy")
    out = torch.zeros((x.shape[0], dep.out_dim), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0 or cap == 0:
        return out
    geom = grouped_folded_geometry(E, cap, dep.in_dim, dep.out_dim, n_pad,
                                   x.dtype == torch.bfloat16, noise,
                                   x.shape[0], _sm_count(x.device.index or 0),
                                   form)
    rc = runtime.library().cim_mvm_grouped_folded_launch(
        x.data_ptr(), wf.data_ptr(), i_pad * ld, scale.data_ptr(),
        tags.data_ptr() if noise else None, offsets.data_ptr(),
        out.data_ptr(), geom.array,
        int(read_seed) & 0xFFFFFFFF if noise else 0,
        read_noise_amplitude(dep) if noise else 0.0,
        runtime.stream_arg(out.device))
    runtime.count_launch("cim_mvm_grouped_folded")
    runtime.check_status("cim_mvm_grouped_folded", rc)
    return out


def _launch_grouped(x: torch.Tensor, dep: CimDeployment,
                    offsets: torch.Tensor, cap: int,
                    read_seed: int | None,
                    form: int | None = None) -> torch.Tensor:
    if dep.folded is not None:
        return _launch_grouped_folded(x, dep, offsets, cap, read_seed, form)
    if needs_fold(dep):
        raise ValueError("the grouped cim_mvm form: a bank with a gain, a "
                         "col_pos or read noise is read folded; fold it "
                         "first (deploy_model_params folds it at deploy)")
    E, i_pad, n_pad = dep.codes.shape
    codes, pos, scale = dep.codes, dep.pos, dep.scale
    if codes.dtype != torch.int16 or pos.dtype != torch.int32 \
            or scale.dtype != torch.float32 or pos.shape != (
                E, i_pad, n_pad // dep.wpt) or scale.shape != (E,) \
            or not (codes.is_contiguous() and pos.is_contiguous()
                    and scale.is_contiguous()):
        raise ValueError("the grouped cim_mvm form takes contiguous int16 "
                         "codes (E, I_pad, N_pad), int32 pos (E, I_pad, "
                         "N_tiles) and an f32 scale (E,)")
    if dep.n_bits > 16 or dep.cols << dep.n_bits >= 1 << 24:
        raise ValueError("cim_mvm kernel takes n_bits <= 16 and "
                         "cols * 2^n_bits < 2^24 (exact integer moments)")
    out = torch.zeros((x.shape[0], dep.out_dim), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0 or cap == 0:
        return out
    geom = grouped_geometry(E, cap, dep.in_dim, dep.out_dim, n_pad, dep.wpt,
                            dep.n_bits, dep.cols, dep.reversed_df,
                            codes.data_ptr() % 16 == 0,
                            x.dtype == torch.bfloat16, x.shape[0],
                            _sm_count(x.device.index or 0))
    rc = runtime.library().cim_mvm_grouped_launch(
        x.data_ptr(), codes.data_ptr(), pos.data_ptr(), scale.data_ptr(),
        offsets.data_ptr(), out.data_ptr(), i_pad * n_pad,
        i_pad * (n_pad // dep.wpt), geom.array, dep.eta,
        runtime.stream_arg(out.device))
    runtime.count_launch("cim_mvm_grouped")
    runtime.check_status("cim_mvm_grouped", rc)
    return out


def cim_mvm_grouped(x: torch.Tensor, dep: CimDeployment,
                    offsets: torch.Tensor, cap: int | None = None,
                    read_seed: int | None = None,
                    device: str | torch.device = "cuda",
                    form: int | None = None) -> torch.Tensor:
    """Expert e's rows of y = those rows of x @ W_effective of expert e,
    in one launch: the counterpart of the reference's
    ``jax.vmap(cim_mvm)`` over the expert axis of an MoE bank
    (``repro.models.moe._expert_mm``).

    x: (A, in_dim) f32 or bf16 (other types are cast to f32), its rows
    sorted by expert; ``dep``: a deployment stacked over E experts (a
    leading expert axis), ideal or, on imperfect devices, folded (a gain,
    col_pos or read noise; ``repro_torch.deploy`` folds each expert at
    deploy); ``offsets``: (E + 1,) int32 on the device, expert e owning
    the rows [offsets[e], offsets[e+1]); ``cap``: the most rows an expert
    computes (default A), its rows past ``offsets[e] + cap`` dropped;
    ``read_seed``: this read's noise, each expert at its own tag, as
    :func:`cim_mvm` (None: noiseless).  Returns (A, out_dim) f32, zero on
    every row no expert computes: on CUDA one of the grouped ideal forms
    (:func:`grouped_geometry` picks it from ``cap``) or, for a folded
    bank, one of the grouped folded forms (:func:`grouped_folded_geometry`
    picks it from ``cap``; ``form`` forces one of GROUPED_FOLDED_FORMS, for
    tests and A/B timing; an unfolded bank with a gain, col_pos or read
    noise raises ``ValueError``); on the CPU the plain version (a loop of
    :func:`cim_mvm`'s over the experts).  The offsets never go to the
    host: the launch is sized by ``cap`` and A, and an expert without
    rows reads no weight.
    """
    dev = resolve_device(device)
    check_on(dev, x=x, codes=dep.codes, pos=dep.pos, scale=dep.scale,
             offsets=offsets, gain=dep.gain, col_pos=dep.col_pos,
             folded=dep.folded, device_tags=dep.device_tags)
    E = dep.codes.shape[0]
    if dep.codes.ndim != 3 or x.ndim != 2 or x.shape[1] != dep.in_dim \
            or offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"the grouped cim_mvm form takes x (A, "
                         f"{dep.in_dim}), a deployment stacked over experts "
                         f"and int32 offsets (E + 1,), not x "
                         f"{tuple(x.shape)}, codes {tuple(dep.codes.shape)}, "
                         f"offsets {tuple(offsets.shape)} {offsets.dtype}")
    cap = x.shape[0] if cap is None else int(cap)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    if form is not None and dep.folded is None:
        raise ValueError("the grouped cim_mvm form: ``form`` picks one of the "
                         "grouped folded forms, for a folded bank only")
    x = x.contiguous()
    if dev.type == "cpu":
        return cim_mvm_grouped_plain(x, dep, offsets, cap, read_seed)
    return _launch_grouped(x, dep, offsets.contiguous(), cap, read_seed,
                           form)


def cim_mvm(x: torch.Tensor, dep: CimDeployment, read_seed: int | None = None,
            device: str | torch.device = "cuda") -> torch.Tensor:
    """y = x @ W_effective for a CIM-deployed weight matrix.

    x: (..., in_dim) f32 or bf16 (read as is; other types are cast to
    f32); returns (..., out_dim) f32.  ``read_seed`` draws this read's
    noise when the deployment carries ``sigma_read > 0`` and a
    ``noise_tag``: eps is a function of (read_seed, noise_tag, i, n)
    alone; None is the noiseless read.  ``x`` and the deployment must
    lie on ``device``: the kernel runs on CUDA, the plain version on the
    CPU.
    """
    dev = resolve_device(device)
    check_on(dev, x=x, codes=dep.codes, pos=dep.pos, scale=dep.scale,
             gain=dep.gain, col_pos=dep.col_pos, folded=dep.folded)
    if x.shape[-1] != dep.in_dim:
        raise ValueError(f"x feature dim {x.shape[-1]} != deployed in_dim "
                         f"{dep.in_dim}")
    batch = x.shape[:-1]
    x2 = x if x.ndim == 2 else x.reshape(-1, dep.in_dim)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.to(torch.float32)
    x2 = x2.contiguous()
    if dev.type == "cpu":
        y = cim_mvm_plain(x2, dep, read_seed)
    else:
        y = _launch(x2, dep, read_seed)
    return y if x.ndim == 2 else y.reshape(*batch, dep.out_dim)
