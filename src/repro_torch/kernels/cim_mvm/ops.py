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

    def layer(self, r: int) -> "CimDeployment":
        """Repeat ``r`` of a stacked deployment (views, no copy)."""
        return dataclasses.replace(
            self, codes=self.codes[r], pos=self.pos[r], scale=self.scale[r],
            gain=None if self.gain is None else self.gain[r],
            col_pos=None if self.col_pos is None else self.col_pos[r])


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


# Tile configurations of kernel.cu (BM, BK); BN is 64 in both.
_BN = 64
_SMALL_M = 16


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
    small = M <= _SMALL_M
    bm, bk = (8, 64) if small else (64, 16)
    blocks = math.ceil(N / _BN) * math.ceil(M / bm)
    # Enough blocks for ~8 resident a SM: decode's few output tiles
    # split I, the splits summed in order by a second kernel.
    splits = max(1, min(math.ceil(8 * _sm_count(x.device.index or 0)
                                  / blocks), i_pad // bk))
    k_per = math.ceil(math.ceil(i_pad / splits) / bk) * bk
    splits = math.ceil(i_pad / k_per)
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    lib = runtime.library()
    rc = lib.cim_mvm_launch(
        x.data_ptr(), codes.data_ptr(), pos.data_ptr(), scale.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        M, I, N, i_pad, n_pad, n_tiles, splits, k_per, float(dep.eta),
        dep.n_bits, dep.wpt, dep.cols, int(dep.reversed_df), int(small),
        runtime.stream_arg())
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
    x2 = x.reshape(-1, dep.in_dim).to(torch.float32).contiguous()
    if dev.type == "cpu":
        y = cim_mvm_plain(x2, dep)
    else:
        y = _launch(x2, dep)
    return y.reshape(*batch, dep.out_dim)
