"""Wrapper of the fused CIM matmul kernel, and deployment packaging.

``deploy()`` turns a dense weight matrix into a :class:`CimDeployment`
(signed int16 codes + MDM physical row-position table) once, at
deployment time; ``cim_mvm()`` then computes the PR-distorted matmul
for any activation batch: the hand-written kernel (``kernel.cu``) on
CUDA tensors, the plain PyTorch version (``ref.py``) on CPU tensors.
"""
from __future__ import annotations

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
from repro_torch.kernels.cim_mvm.ref import cim_mvm_plain
from repro_torch.mapping import resolve_pipeline


@dataclasses.dataclass
class CimDeployment:
    """A weight matrix deployed onto bit-sliced crossbars.

    codes: (I_tiles*rows, N_tiles*wpt) int16 signed codes (sign*magnitude).
    pos:   (I_tiles*rows, N_tiles)     int32 physical row positions.
    scale: ()                          f32 quantisation scale.
    A stacked deployment carries a leading repeat axis on all three;
    :meth:`layer` takes one repeat's views.

    ``gain``, ``col_pos`` and ``sigma_read`` are the reference's
    nonideal-device operands; this slice serves ideal devices only, and
    :func:`cim_mvm` raises ``NotImplementedError`` on a deployment that
    carries any of them.
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
    sigma_read: float = 0.0
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
                gain=None if self.gain is None else self.gain[r],
                col_pos=None if self.col_pos is None else self.col_pos[r])
        return view


def package_deployment(codes: torch.Tensor, sign: torch.Tensor,
                       scale: torch.Tensor, plan: MdmPlan,
                       spec: CrossbarSpec, eta: float) -> CimDeployment:
    """Lay out quantised codes and a plan as a :class:`CimDeployment`.

    ``codes`` (I, N) magnitudes and ``sign`` (I, N) +-1; the codes are
    padded with zeros to whole tiles, and ``pos[i, tn]`` is the physical
    row of input i in column tile tn.
    """
    I, N = codes.shape
    ti, tn = spec.grid(I, N)
    rows, wpt = spec.rows, spec.weights_per_tile
    i_pad, n_pad = ti * rows, tn * wpt
    signed = (codes.to(torch.int32) * sign.to(torch.int32)).to(torch.int16)
    signed = F.pad(signed, (0, n_pad - N, 0, i_pad - I))
    i = torch.arange(i_pad, device=codes.device)
    pos = plan.row_position[i // rows, :, i % rows].to(torch.int32)
    return CimDeployment(
        codes=signed.contiguous(), pos=pos.contiguous(),
        scale=scale.to(torch.float32), n_bits=spec.n_bits, wpt=wpt,
        cols=spec.cols, eta=float(eta),
        reversed_df=bool(plan.reversed_dataflow), in_dim=I, out_dim=N)


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
SMEM_MAX = 227 * 1024
# The fields of kernel.cu's ``Geom``, in order.
_GEOM_FIELDS = ("form", "M", "I", "N", "n_pad", "n_tiles", "wpt", "n_bits",
                "cols", "reversed", "fast", "tile", "rps", "gx", "gy",
                "smem", "off_t", "off_p", "mt")


def _table(wpt: int, n_bits: int) -> int:
    """Entries of the eta*M1 table: a row of 2^K a slot."""
    return wpt << n_bits


def _fast(aligned, n_pad, wpt, n_bits) -> bool:
    """16-byte code loads, one pos per 8 columns, the eta*M1 table."""
    return (aligned and n_pad % 8 == 0 and wpt % 8 == 0
            and _table(wpt, n_bits) <= TABLE_MAX)


def _decode_geometry(M, I, n_pad, wpt, n_bits, sm_count, aligned):
    """Decode-form fields, or None where its shared memory would not
    fit (a very long I)."""
    fast = _fast(aligned, n_pad, wpt, n_bits)
    mt = 1 << (M - 1).bit_length()
    # The widest block (G column groups of 8) that still gives two
    # blocks a SM; else G = 8.
    for G in (32, 16, 8):
        gx = math.ceil(n_pad / (8 * G))
        if gx * DECODE_CLUSTER >= 2 * sm_count:
            break
    rps = math.ceil(I / DECODE_CLUSTER)
    # x slab [rps][mt], reused for the slices' sums [KS][RM][8G]; the
    # eta*M1 table; the block's sums [mt][8G] (offsets in floats).
    slab = max(rps * mt, (THREADS // G) * DECODE_RM * 8 * G)
    off_t = runtime.round4(slab)
    off_p = off_t + (_table(wpt, n_bits) if fast else 0)
    smem = 4 * (off_p + mt * 8 * G)
    if smem > SMEM_MAX:
        return None
    return dict(form=0, fast=int(fast), tile=G, rps=rps, gx=gx,
                gy=DECODE_CLUSTER, smem=smem, off_t=off_t, off_p=off_p,
                mt=mt)


@functools.lru_cache(maxsize=None)
def cim_geometry(M: int, I: int, N: int, i_pad: int, n_pad: int, wpt: int,
                 n_bits: int, cols: int, reversed_df: bool, sm_count: int,
                 aligned: bool) -> runtime.Geometry:
    """The launch of ``cim_mvm`` for x (M, I) and a deployment with
    (i_pad, n_pad) codes, on a card with ``sm_count`` SMs; ``aligned``
    says whether the codes start on 16 bytes.  Cached per shape: a
    decode step pays for it once per matrix shape.

    Decode form (M <= 16): grid (gx, 8), cluster rank r sums the rows
    [r*rps, min((r+1)*rps, I)), slice s of a block the rows r*rps + s +
    KS*j (KS = 256 / G).  Prefill form: grid (ceil(N/128), ceil(M/128)),
    each block all of I in slabs of 32 rows.  ``fast``: 16-byte code
    loads and one pos per 8 columns (wpt % 8 == 0, n_pad % 8 == 0)."""
    del i_pad                       # rows past I hold zero codes
    g = _decode_geometry(M, I, n_pad, wpt, n_bits, sm_count, aligned) \
        if M <= DECODE_MAX_M else None
    if g is None:
        fast = _fast(aligned, n_pad, wpt, n_bits)
        # x as TF32 hi / lo parts and the rows' factors, two buffers each;
        # a ring of staged raw x, codes and pos slabs; the eta*M1 table
        # (dropped, with the 16-byte code path, where it would not fit).
        bm, bn, bk = PREFILL_BM, PREFILL_BN, PREFILL_BK
        stage = bm * (bk + 4) * 4 + bk * (bn + 8) * 2 + bk * (bn // 8) * 4
        smem = (2 * 2 * bm * bk * 4 + 2 * bk * (bn // 8) * 4
                + PREFILL_STAGES * stage)
        if fast and smem + 4 * _table(wpt, n_bits) > SMEM_MAX:
            fast = False
        smem += 4 * _table(wpt, n_bits) if fast else 0
        g = dict(form=1, fast=int(fast), tile=bn, rps=0,
                 gx=math.ceil(N / bn), gy=math.ceil(M / bm), smem=smem,
                 off_t=0, off_p=0, mt=0)
    g.update(M=M, I=I, N=N, n_pad=n_pad, n_tiles=n_pad // wpt, wpt=wpt,
             n_bits=n_bits, cols=cols, reversed=int(reversed_df))
    return runtime.Geometry.of(_GEOM_FIELDS, g)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x: torch.Tensor, dep: CimDeployment) -> torch.Tensor:
    codes, pos, scale = dep.codes, dep.pos, dep.scale
    if codes.dtype != torch.int16 or pos.dtype != torch.int32 \
            or scale.dtype != torch.float32:
        raise TypeError("cim_mvm kernel takes int16 codes, int32 pos and "
                        "an f32 scale")
    i_pad, n_pad = codes.shape
    n_tiles = n_pad // dep.wpt
    if pos.shape != (i_pad, n_tiles) or scale.numel() != 1:
        raise ValueError(f"pos {tuple(pos.shape)} / scale "
                         f"{tuple(scale.shape)} do not fit codes "
                         f"{tuple(codes.shape)}")
    if not (codes.is_contiguous() and pos.is_contiguous()):
        raise ValueError("cim_mvm kernel takes contiguous codes and pos")
    if dep.n_bits > 16 or dep.cols << dep.n_bits >= 1 << 24:
        raise ValueError("cim_mvm kernel takes n_bits <= 16 and "
                         "cols * 2^n_bits < 2^24 (exact integer moments)")
    M, I, N = x.shape[0], dep.in_dim, dep.out_dim
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    codes_ptr = codes.data_ptr()
    geom = cim_geometry(M, I, N, i_pad, n_pad, dep.wpt, dep.n_bits,
                        dep.cols, dep.reversed_df,
                        _sm_count(x.device.index or 0), codes_ptr % 16 == 0)
    rc = runtime.library().cim_mvm_launch(
        x.data_ptr(), codes_ptr, pos.data_ptr(), scale.data_ptr(),
        out.data_ptr(), geom.array, dep.eta,
        runtime.stream_arg(out.device))
    runtime.count_launch("cim_mvm")
    runtime.check_status("cim_mvm", rc)
    return out


def cim_mvm(x: torch.Tensor, dep: CimDeployment,
            device: str | torch.device = "cuda") -> torch.Tensor:
    """y = x @ W_effective for a CIM-deployed weight matrix.

    x: (..., in_dim); returns (..., out_dim) f32.  ``x`` and the
    deployment must lie on ``device``: the kernel runs on CUDA, the
    plain version on the CPU.
    """
    dev = resolve_device(device)
    check_on(dev, x=x, codes=dep.codes, pos=dep.pos, scale=dep.scale)
    if dep.gain is not None or dep.col_pos is not None \
            or dep.sigma_read > 0.0:
        raise NotImplementedError(
            "cim_mvm: gain, column-permuted and read-noise deployments "
            "are not ported yet")
    if x.shape[-1] != dep.in_dim:
        raise ValueError(f"x feature dim {x.shape[-1]} != deployed in_dim "
                         f"{dep.in_dim}")
    batch = x.shape[:-1]
    x2 = x if x.ndim == 2 else x.reshape(-1, dep.in_dim)
    if x2.dtype != torch.float32 or not x2.is_contiguous():
        x2 = x2.to(torch.float32).contiguous()
    if dev.type == "cpu":
        y = cim_mvm_plain(x2, dep)
    else:
        y = _launch(x2, dep)
    return y if x.ndim == 2 else y.reshape(*batch, dep.out_dim)
