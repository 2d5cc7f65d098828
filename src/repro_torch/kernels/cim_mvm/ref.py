"""Plain PyTorch versions of the fused CIM matmul.

``cim_effective_weights`` / ``cim_mvm_plain`` are the counterpart of the
reference's fused XLA path (``repro/kernels/cim_mvm/xla.py``): W' is
expanded from the int16 codes with the kernel's formula, the optional
column permutation, gain and read noise applied in the reference's
order, and multiplied with ``torch.matmul``.  The read noise comes from
:func:`read_noise`, the kernel's Philox4x32-10 in int64 arithmetic.
``cim_mvm_ref`` is the independent oracle through the materialised
Eq-17 path (``repro_torch.core.noise.noisy_magnitude``).  The batched
and grouped forms' plain versions are loops of ``cim_mvm_plain``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.bitslice import codes_to_bits
from repro_torch.core.mdm import MdmPlan
from repro_torch.core.noise import noisy_magnitude
from repro_torch.core.tiling import CrossbarSpec

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def cim_effective_weights(codes: torch.Tensor, pos: torch.Tensor,
                          scale: torch.Tensor, *, n_bits: int, wpt: int,
                          cols: int, eta: float, reversed_df: bool,
                          col_pos: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """W' (I, N) f32 from signed codes (I, N) int16, row positions
    (I, N // wpt) int32 and the scale:
    W' = sign * scale * [(1 + eta*p) * M0 + eta*M1].  ``col_pos``
    ((Ti, Tn, cols) int32) sends bit k of weight n to the bitline
    ``col_pos[ti, tn, col(n, k)]`` instead of ``col(n, k)``."""
    c = codes.to(torch.int32)
    mag = c.abs()
    sign = torch.where(c < 0, -1.0, 1.0)
    m0 = mag.to(torch.float32) * (2.0 ** -n_bits)
    N = codes.shape[1]
    dev = codes.device
    slot = torch.arange(N, dtype=torch.int64, device=dev) % wpt
    if col_pos is not None:
        rows = codes.shape[0] // col_pos.shape[0]
        tii = torch.arange(codes.shape[0], device=dev) // rows
        tnn = torch.arange(N, device=dev) // wpt
    m1 = torch.zeros_like(m0)
    for k in range(n_bits):
        bit = ((mag >> (n_bits - 1 - k)) & 1).to(torch.float32)
        col = slot * n_bits + k
        if reversed_df:
            col = (cols - 1) - col
        if col_pos is None:
            colf = col.to(torch.float32)
        else:
            colf = col_pos[tii[:, None], tnn[None, :],
                           col[None, :]].to(torch.float32)
        m1 = m1 + bit * (2.0 ** -(k + 1)) * colf
    p = pos.to(torch.float32).repeat_interleave(wpt, dim=1)
    return sign * scale * ((1.0 + eta * p) * m0 + eta * m1)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant a < 2^32 and b in
    [0, 2^32) (int64), by 16-bit halves of a so that no product leaves
    the int64 range."""
    t = b * (a & 0xFFFF)
    u = b * (a >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def _box_muller(a: torch.Tensor, b: torch.Tensor):
    """Two standard normals from two 32-bit words (int64): r cos(2 pi u2)
    and r sin(2 pi u2) on their top 24 bits."""
    u1 = ((a >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    u2 = ((b >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = math.pi * (2.0 * u2)
    return r * torch.cos(theta), r * torch.sin(theta)


def read_noise(read_seed: int, tag: int, n_rows: int, n_cols: int,
               device) -> torch.Tensor:
    """(n_rows, n_cols) f32 standard normals, the kernel's stream: entry
    (i, n) is normal n & 3 of Philox4x32-10 at key (read_seed, tag) mod
    2^32 and counter (i, n >> 2, 0, 0) — Box-Muller on words 0, 1 for
    n & 3 in {0, 1}, on words 2, 3 for {2, 3}.  The words are exact
    (int64 arithmetic masked to 32 bits); the normals differ from the
    kernel's only in the last bits of log, sin and cos."""
    groups = -(-n_cols // 4)
    c0 = torch.arange(n_rows, dtype=torch.int64,
                      device=device)[:, None].expand(n_rows, groups)
    c1 = torch.arange(groups, dtype=torch.int64,
                      device=device)[None, :].expand(n_rows, groups)
    c2 = torch.zeros((n_rows, groups), dtype=torch.int64, device=device)
    c3 = c2
    k0, k1 = int(read_seed) & _M32, int(tag) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    z = torch.stack(_box_muller(c0, c1) + _box_muller(c2, c3), dim=-1)
    return z.reshape(n_rows, 4 * groups)[:, :n_cols]


def folded_weights(dep) -> torch.Tensor:
    """The fold's plain version: a deployment's W'(col_pos) * gain as
    (I_pad, ld) f32, ld = N_pad rounded up to 8, zero columns past N_pad
    (what ``deployment_weights(dep, None)`` gives, padded)."""
    w = cim_effective_weights(dep.codes, dep.pos, dep.scale,
                              n_bits=dep.n_bits, wpt=dep.wpt, cols=dep.cols,
                              eta=dep.eta, reversed_df=dep.reversed_df,
                              col_pos=dep.col_pos)
    if dep.gain is not None:
        w = w * dep.gain
    n_pad = w.shape[1]
    ld = -(-n_pad // 8) * 8
    return w if ld == n_pad else F.pad(w, (0, ld - n_pad))


def deployment_weights(dep, read_seed: int | None = None) -> torch.Tensor:
    """A deployment's W' (I_pad, N_pad) f32 for one read: the Eq-17
    expansion (with its column permutation), times the gain — read from
    ``dep.folded`` where the deployment is folded — plus (sigma_read *
    agg) * scale * eps when the read is noisy."""
    from repro_torch.kernels.cim_mvm.ops import noisy, read_noise_amplitude

    n_pad = dep.codes.shape[1]
    w = (dep.folded if dep.folded is not None
         else folded_weights(dep))[:, :n_pad]
    if noisy(dep, read_seed):
        eps = read_noise(read_seed, int(dep.noise_tag), *w.shape, w.device)
        w = w + read_noise_amplitude(dep) * dep.scale * eps
    return w


def cim_mvm_plain(x: torch.Tensor, dep,
                  read_seed: int | None = None) -> torch.Tensor:
    """y = x @ W' for x (M, in_dim) f32 or bf16; returns (M, out_dim)
    f32."""
    i_pad = dep.codes.shape[0]
    x = F.pad(x.to(torch.float32), (0, i_pad - x.shape[-1]))
    return (x @ deployment_weights(dep, read_seed))[:, :dep.out_dim]


def cim_mvm_ref(x: torch.Tensor, codes_signed: torch.Tensor, plan: MdmPlan,
                spec: CrossbarSpec, eta: float) -> torch.Tensor:
    """Oracle: y = x @ W' from signed codes (I, N) and an MDM plan."""
    mag = codes_signed.to(torch.int32).abs()
    sign = torch.where(codes_signed < 0, -1.0, 1.0)
    bits = codes_to_bits(mag, spec.n_bits)
    w_eff = sign * noisy_magnitude(bits, plan.scale, plan, spec, eta)
    return x.to(torch.float32) @ w_eff


def cim_mvm_batched_plain(x: torch.Tensor, dep, read_seed: int | None = None,
                          members=None) -> torch.Tensor:
    """The batched form's plain version: y[g] = x[g] @ W'(member g) for x
    (G, M, in_dim) and a stacked deployment ``dep``, ``members`` its G
    repeats read (default all); returns (G, M, out_dim) f32."""
    reps = range(dep.codes.shape[0]) if members is None else members
    return torch.stack([cim_mvm_plain(x[g], dep.layer(int(r)), read_seed)
                        for g, r in enumerate(reps)])


def cim_mvm_grouped_plain(x: torch.Tensor, dep, offsets,
                          cap: int | None = None) -> torch.Tensor:
    """The grouped form's plain version: for x (A, in_dim) sorted by
    expert and a deployment stacked over E experts, the rows [offsets[e],
    min(offsets[e+1], offsets[e] + cap)) of y are :func:`cim_mvm_plain`
    of those rows of x through expert e; every other row is 0.  Returns
    (A, out_dim) f32."""
    off = [int(o) for o in torch.as_tensor(offsets).tolist()]
    cap = x.shape[0] if cap is None else int(cap)
    y = torch.zeros((x.shape[0], dep.out_dim), dtype=torch.float32,
                    device=x.device)
    for e in range(dep.codes.shape[0]):
        a, b = off[e], min(off[e + 1], off[e] + cap)
        if b > a:
            y[a:b] = cim_mvm_plain(x[a:b], dep.layer(e))
    return y
