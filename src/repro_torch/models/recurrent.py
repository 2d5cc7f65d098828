"""Recurrent sequence mixers of the port: the selective SSM (mamba),
mLSTM and sLSTM (xLSTM).

Port of ``repro.models.recurrent``.  The mamba mixer is plain PyTorch on
both devices: the reference runs it outside any kernel
(``jax.lax.associative_scan`` and jnp ops), so it has no hand-written
counterpart.  Its prefill walks chunks of ``chunk`` steps carrying the
state (B, Di, N), with a doubling scan inside a chunk, in the
reference's dtypes: ``w_in`` in the parameters' dtype, the conv, dt,
B/C, the scan and ``w_out`` in f32, the output cast back.

The mLSTM prefill is chunkwise: a Python loop carries
the matrix state across chunks of ``chunk`` steps while the inside of a
chunk is a decay-masked quasi-attention, as in the reference;
``mlstm_decode`` is the one-step form.  The two agree only to f32
rounding (log-sigmoid cumsums and clipped decay ratios against a product
of sigmoids), so each is held to its own reference function.

The sLSTM keeps the genuine per-step recurrence; its input projection
``gx = x W_gates + b_gates`` and output projection stay matmuls, and the
recurrence runs in one call of ``scan``: the ``slstm_scan`` kernel on
CUDA tensors (:mod:`repro_torch.kernels.slstm_scan`), its plain version
on CPU tensors.  Decode is the mixer at S = 1, as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan.ops import slstm_scan

F32 = torch.float32


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ------------------------------ Mamba ------------------------------------

def mamba_chunk_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t along dim 1 (the chunk), from h0.

    a, b (B, c, Di, N); h0 (B, Di, N).  Returns (h (B, c, Di, N),
    h_last).  The prefix products and sums come from a doubling
    (Hillis-Steele) scan, log2(c) steps; the closed form cumprod(a) *
    cumsum(b / cumprod(a)) would divide by an underflowed product."""
    c, d = a.shape[1], 1
    while d < c:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    h = a * h0[:, None] + b
    return h, h[:, -1]


def _ssm_inputs(g, xc: torch.Tensor):
    """dt (softplus, f32), B and C of the selective SSM, and A, from the
    conv output ``xc`` (f32)."""
    dt = F.softplus(xc @ g("w_dt").to(F32) + g("b_dt")).to(F32)
    b_ssm, c_ssm = (xc @ g("w_bc").to(F32)).chunk(2, dim=-1)
    return dt, b_ssm, c_ssm, -torch.exp(g("a_log").to(F32))


def _mamba_out(g, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    y = y + xc * g("d_skip")
    return ((y * _silu(z.to(F32))) @ g("w_out").to(F32)).to(dtype)


def mamba_mixer(p: dict, x: torch.Tensor, state: tuple | None,
                chunk: int = 64, prefix: str = ""):
    """Selective SSM over x (B, S, D).  state = (conv (B, K-1, Di),
    ssm (B, Di, N)) or None (zeros).  ``prefix`` names the parameters
    (``ssm_`` in a hybrid block).  Returns (y (B, S, D), (conv, ssm))."""
    g = lambda n: p[prefix + n]
    B, S, _ = x.shape
    K, Di = g("conv_w").shape
    N = g("a_log").shape[-1]
    x_in, z = (x @ g("w_in")).chunk(2, dim=-1)          # (B, S, Di)
    conv_state = (torch.zeros((B, K - 1, Di), dtype=x_in.dtype,
                              device=x.device)
                  if state is None else state[0])
    h = (torch.zeros((B, Di, N), dtype=F32, device=x.device)
         if state is None else state[1])

    x_pad = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)
    xf, w = x_pad.to(F32), g("conv_w").to(F32)
    conv = 0
    for k in range(K):
        conv = conv + xf[:, k:k + S] * w[k]
    xc = _silu(conv + g("conv_b").to(F32))              # (B, S, Di) f32
    new_conv = x_pad[:, S:][:, -(K - 1):] if K > 1 else conv_state
    dt, b_ssm, c_ssm, A = _ssm_inputs(g, xc)

    # Padded steps have dt = 0: a = 1 and b = 0 carry h unchanged.
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    padded = lambda t: F.pad(t, (0, 0, 0, pad)) if pad else t
    xc_p, dt_p, b_p, c_p = map(padded, (xc, dt, b_ssm, c_ssm))
    ys = []
    for c0 in range(0, n_chunks * chunk, chunk):
        dt_c = dt_p[:, c0:c0 + chunk]
        a = torch.exp(dt_c[..., None] * A)              # (B, c, Di, N)
        bx = ((dt_c * xc_p[:, c0:c0 + chunk])[..., None]
              * b_p[:, c0:c0 + chunk, None, :])
        h_all, h = mamba_chunk_scan(a, bx, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all,
                               c_p[:, c0:c0 + chunk]))
    y = torch.cat(ys, dim=1)[:, :S]
    return _mamba_out(g, y, xc, z, x.dtype), (new_conv, h)


def mamba_decode(p: dict, x: torch.Tensor, state: tuple, prefix: str = ""):
    """Single-token step.  x (B, 1, D); state = (conv, ssm)."""
    g = lambda n: p[prefix + n]
    conv_state, h = state
    x_in, z = (x[:, 0] @ g("w_in")).chunk(2, dim=-1)    # (B, Di)
    window = torch.cat([conv_state, x_in[:, None]], dim=1)  # (B, K, Di)
    conv = torch.einsum("bkd,kd->bd", window.to(F32),
                        g("conv_w").to(F32)) + g("conv_b")
    xc = _silu(conv)
    dt, b_ssm, c_ssm, A = _ssm_inputs(g, xc)
    a = torch.exp(dt[..., None] * A)                    # (B, Di, N)
    h_new = a * h + (dt * xc)[..., None] * b_ssm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h_new, c_ssm)
    return (_mamba_out(g, y, xc, z, x.dtype)[:, None],
            (window[:, 1:], h_new))


# ------------------------------ mLSTM ------------------------------------

def _qkv_gates(p: dict, xi: torch.Tensor, eq: str):
    """q, k (scaled by Dh^-1/2), v, input gate and the raw forget-gate
    pre-activation of the mLSTM, in f32."""
    H, Dh = p["wq"].shape[1], p["wq"].shape[2]
    q = torch.einsum(eq, xi, p["wq"]).to(F32)
    k = torch.einsum(eq, xi, p["wk"]).to(F32) * Dh ** -0.5
    v = torch.einsum(eq, xi, p["wv"]).to(F32)
    if_pre = (xi @ p["w_if"] + p["b_if"]).to(F32)
    return q, k, v, torch.sigmoid(if_pre[..., :H]), if_pre[..., H:]


def _mlstm_out(p: dict, y: torch.Tensor, o_pre: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    y = y * torch.sigmoid(o_pre.to(F32))
    return (y @ p["w_down"].to(F32)).to(dtype)


def mlstm_mixer(p: dict, x: torch.Tensor, state: tuple | None,
                chunk: int = 128):
    """Chunkwise matrix-LSTM.  x (B, S, D); state = (S (B, H, Dh, Dh),
    n (B, H, Dh)) or None.  Returns (y (B, S, D), (S, n))."""
    B, S, _ = x.shape
    xi, o_pre = (x @ p["w_up"]).chunk(2, dim=-1)        # (B, S, Di)
    H, Dh = p["wq"].shape[1], p["wq"].shape[2]
    q, k, v, i_g, f_pre = _qkv_gates(p, xi, "bsi,ihd->bshd")
    logf = F.logsigmoid(f_pre)                          # (B, S, H)

    S_m = (torch.zeros((B, H, Dh, Dh), dtype=F32, device=x.device)
           if state is None else state[0])
    n_v = (torch.zeros((B, H, Dh), dtype=F32, device=x.device)
           if state is None else state[1])

    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S

    def padded(t):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) if pad else t

    q, k, v, i_g, logf = map(padded, (q, k, v, i_g, logf))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=F32,
                                   device=x.device))
    ys = []
    for c0 in range(0, n_chunks * chunk, chunk):
        q_c, k_c, v_c, i_c, lf_c = (t[:, c0:c0 + chunk]
                                    for t in (q, k, v, i_g, logf))
        lf_cum = torch.cumsum(lf_c, dim=1)              # (B, c, H)
        decay = torch.exp(lf_cum)
        # inter-chunk
        y_int = torch.einsum("bchd,bhde->bche", q_c, S_m) * decay[..., None]
        n_int = torch.einsum("bchd,bhd->bch", q_c, n_v) * decay
        # intra-chunk, decay ratio exp(lf_cum[t] - lf_cum[s]) for s <= t
        att = torch.einsum("bchd,bshd->bhcs", q_c, k_c)  # (B, H, c, s)
        dm = lf_cum.transpose(1, 2)                     # (B, H, c)
        dmat = torch.exp(torch.clamp(dm[..., :, None] - dm[..., None, :],
                                     -60, 0))
        w = att * dmat * causal * i_c.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhcs,bshd->bchd", w, v_c)
        n_intra = w.sum(-1).transpose(1, 2)             # (B, c, H)
        den = torch.clamp(torch.abs(n_int + n_intra), min=1.0)[..., None]
        ys.append((y_int + y_intra) / den)
        # state update
        tot = torch.exp(lf_cum[:, -1])                  # (B, H)
        decay_to_end = torch.exp(torch.clamp(
            lf_cum[:, -1][:, None] - lf_cum, -60, 0)) * i_c  # (B, c, H)
        # The decay goes onto k first: a three-operand einsum would
        # build a (B, c, H, Dh, Dh) product (8.6 GB at xlstm-1.3b width).
        k_d = k_c * decay_to_end[..., None]
        S_m = S_m * tot[..., None, None] + torch.einsum(
            "bchd,bche->bhde", k_d, v_c)
        n_v = n_v * tot[..., None] + k_d.sum(1)

    y = torch.cat(ys, dim=1)[:, :S].reshape(B, S, H * Dh)
    return _mlstm_out(p, y, o_pre, x.dtype), (S_m, n_v)


def mlstm_decode(p: dict, x: torch.Tensor, state: tuple):
    """Single-token mLSTM step.  x (B, 1, D)."""
    B = x.shape[0]
    xi, o_pre = (x[:, 0] @ p["w_up"]).chunk(2, dim=-1)
    q, k, v, i_g, f_pre = _qkv_gates(p, xi, "bi,ihd->bhd")
    f_g = torch.sigmoid(f_pre)
    S_m, n_v = state
    S_new = S_m * f_g[..., None, None] + (i_g[..., None, None]
                                          * k[..., :, None] * v[..., None, :])
    n_new = n_v * f_g[..., None] + i_g[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, S_new)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)),
                      min=1.0)
    y = (num / den[..., None]).reshape(B, -1)
    return _mlstm_out(p, y, o_pre, x.dtype)[:, None], (S_new, n_new)


def slstm_scan_kernel(gx, r_gates, h0, c0):
    """``slstm_scan`` on the inputs' own device."""
    return slstm_scan(gx, r_gates, h0, c0, device=gx.device)


def slstm_mixer(p: dict, x: torch.Tensor, state: tuple | None,
                scan: Callable = slstm_scan_kernel):
    """Sequential scalar-LSTM with block-diagonal (per-head) recurrence.
    x (B, S, D); state = (h (B, H, Dh), c (B, H, Dh)) or None.
    ``scan(gx, r_gates, h0, c0) -> (hs, hT, cT)`` runs the recurrence.
    Returns (y (B, S, D), (h, c))."""
    B, S, _ = x.shape
    H, Dh = p["w_gates"].shape[1], p["w_gates"].shape[2] // 4
    gx = torch.einsum("bsd,dhg->bshg", x, p["w_gates"]) + p["b_gates"]
    h0 = (torch.zeros((B, H, Dh), dtype=F32, device=x.device)
          if state is None else state[0])
    c0 = (torch.zeros((B, H, Dh), dtype=F32, device=x.device)
          if state is None else state[1])
    # gx and R in the parameters' dtype (the scan widens bf16 exactly),
    # the state f32: hs, h and c come back f32, as the reference's scan.
    hs, h, c = scan(gx, p["r_gates"], h0, c0)
    y = hs.reshape(B, S, H * Dh) @ p["w_out"].to(F32)
    return y.to(x.dtype), (h, c)


def slstm_decode(p: dict, x: torch.Tensor, state: tuple,
                 scan: Callable = slstm_scan_kernel):
    """Single-token sLSTM step: the mixer at S = 1."""
    return slstm_mixer(p, x, state, scan=scan)
