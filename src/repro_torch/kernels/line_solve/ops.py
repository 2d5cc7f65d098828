"""Wrapper of the line-preconditioner kernel (``kernel.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.line_solve.ref import line_solve_plain

# A block's shared memory on Hopper (227 KB); a block's threads, one a
# chain.
MAX_SMEM = 232_448
MAX_CHAINS = 256


def line_solve(g: torch.Tensor, r: torch.Tensor, cw) -> torch.Tensor:
    """z = M^-1 r for the crossbar solver's line preconditioner: M =
    blockdiag(wordline chains along k, bitline chains along j) of
    conductances g (T, J, K) and wire conductance ``cw``; r (T, 2, J, K)
    of g's dtype (f64 or f32).  On a CUDA tensor the kernel runs (or
    this raises); on a CPU tensor its plain version."""
    if g.dim() != 3 or tuple(r.shape) != (g.shape[0], 2, *g.shape[1:]):
        raise ValueError(f"line_solve takes g (T, J, K) and r (T, 2, J, K), "
                         f"got {tuple(g.shape)} and {tuple(r.shape)}")
    if g.dtype != r.dtype or g.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"line_solve takes f64 or f32 g and r of one dtype, "
                        f"got {g.dtype} and {r.dtype}")
    if g.device != r.device:
        raise ValueError(f"g is on {g.device}, r on {r.device}")
    if g.device.type == "cpu":
        return line_solve_plain(g, r, cw)
    T, J, K = g.shape
    f64 = int(g.dtype == torch.float64)
    lib = runtime.library()
    smem = lib.line_solve_smem(J, K, f64)
    if smem > MAX_SMEM or max(J, K) > MAX_CHAINS:
        raise ValueError(f"line_solve: a {J}x{K} tile takes {smem} bytes of "
                         f"shared memory (at most {MAX_SMEM}) and "
                         f"{max(J, K)} chains a family (at most "
                         f"{MAX_CHAINS})")
    g, r = g.contiguous(), r.contiguous()
    z = torch.empty_like(r)
    rc = lib.line_solve_launch(g.data_ptr(), r.data_ptr(), z.data_ptr(), T,
                               J, K, float(cw), f64,
                               runtime.stream_arg(g.device))
    runtime.count_launch("line_solve")
    runtime.check_status("line_solve", rc)
    return z


def occupancy(J: int, K: int, dtype=torch.float64) -> dict:
    """The kernel's launch at (J, K) in ``dtype``: resident blocks a SM
    (the CUDA runtime's occupancy calculator), shared memory and
    threads a block."""
    out = (ctypes.c_int * 3)()
    rc = runtime.library().line_solve_occupancy(
        J, K, int(dtype == torch.float64), out)
    runtime.check_status("line_solve occupancy", rc)
    return dict(blocks_per_sm=out[0], smem_bytes=out[1], threads=out[2])
