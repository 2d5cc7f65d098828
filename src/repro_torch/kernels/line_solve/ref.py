"""Plain PyTorch version of the line-preconditioner kernel: the Thomas
algorithm in the reference's order (``src/repro/crossbar/batched.py``:
``_thomas_factor``, then forward and back substitution), one chain
step at a time over every chain of the batch."""
from __future__ import annotations

import torch


def thomas_factor(lo: torch.Tensor, d: torch.Tensor, hi: torch.Tensor):
    """Thomas (LU) factorisation of batched tridiagonal chains along the
    last axis (``lo[..., 0]`` and ``hi[..., -1]`` zero): the eliminated
    superdiagonal ``c`` and the pivots ``denom``.  The chains are
    strictly diagonally dominant, so no pivoting is needed."""
    c, denom = torch.empty_like(d), torch.empty_like(d)
    c_prev = torch.zeros_like(d[..., 0])
    for i in range(d.shape[-1]):
        denom[..., i] = d[..., i] - lo[..., i] * c_prev
        c_prev = hi[..., i] / denom[..., i]
        c[..., i] = c_prev
    return c, denom


def chain_bands(cw: torch.Tensor, n: int, shape: tuple, dtype, device):
    """(lo, hi) of ``shape[:-1]`` chains of ``n`` nodes tied by wire
    conductance ``cw``: -cw off the diagonal, 0 past the chain's ends."""
    i = torch.arange(n, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    cw = torch.as_tensor(cw, dtype=dtype, device=device)
    lo = torch.where(i > 0, -cw, zero).expand(shape)
    hi = torch.where(i < n - 1, -cw, zero).expand(shape)
    return lo, hi


def chain_solve(lo, d, hi, r) -> torch.Tensor:
    """Solve the tridiagonal chains (lo, d, hi) for ``r``, all along the
    last axis, in the reference's Thomas order: each forward step takes
    the factor's pivot and superdiagonal, then y; the back sweep z."""
    lo, d, hi, r = (t.movedim(-1, 0) for t in (lo, d, hi, r))
    c, y = torch.empty_like(r), torch.empty_like(r)
    c_prev, y_prev = torch.zeros_like(r[0]), torch.zeros_like(r[0])
    for i in range(r.shape[0]):
        denom = d[i] - lo[i] * c_prev
        c_prev = hi[i] / denom
        y_prev = (r[i] - lo[i] * y_prev) / denom
        c[i], y[i] = c_prev, y_prev
    z = y
    for i in range(r.shape[0] - 2, -1, -1):
        z[i] = y[i] - c[i] * z[i + 1]
    return z.movedim(0, -1)


def line_diagonals(g: torch.Tensor, cw) -> torch.Tensor:
    """The nodal matrix's diagonal (T, 2, J, K) for conductances g
    (T, J, K) and wire conductance ``cw``: ``cw (1 + has_right) + g`` on
    the wordline plane, ``cw (1 + has_up) + g`` on the bitline plane
    (``src/repro/crossbar/solver.py::_jacobi_diag``)."""
    J, K = g.shape[-2:]
    has_right = (torch.arange(K, device=g.device) < K - 1).to(g.dtype)
    has_up = (torch.arange(J, device=g.device) < J - 1).to(g.dtype)
    return torch.stack([cw * (1.0 + has_right) + g,
                        cw * (1.0 + has_up)[:, None] + g], dim=-3)


def line_solve_plain(g: torch.Tensor, r: torch.Tensor, cw) -> torch.Tensor:
    """z = M^-1 r for the line preconditioner of conductances g
    (T, J, K): wordline chains along k on plane 0 of r (T, 2, J, K),
    bitline chains along j on plane 1."""
    T, J, K = g.shape
    diag = line_diagonals(g, cw)
    lo_k, hi_k = chain_bands(cw, K, (T, J, K), g.dtype, g.device)
    lo_j, hi_j = chain_bands(cw, J, (T, K, J), g.dtype, g.device)
    zW = chain_solve(lo_k, diag[:, 0], hi_k, r[:, 0])
    zB = chain_solve(lo_j, diag[:, 1].transpose(1, 2), hi_j,
                     r[:, 1].transpose(1, 2))
    return torch.stack([zW, zB.transpose(1, 2)], dim=1)
