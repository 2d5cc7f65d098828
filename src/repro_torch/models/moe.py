"""Sort-based Mixture-of-Experts with capacity buckets.

Port of ``repro.models.moe``: a softmax router picks each token's top-K
experts (ties to the lower index, as ``jax.lax.top_k``), the weights
renormalised over the K; the assignments are sorted by expert (a stable
argsort), each expert keeps at most ``cap`` of them (the reference's
capacity formulas, verbatim) and the rest are dropped (the token keeps
its residual path); the routed SwiGLU experts run on the kept rows and
each token sums its K weighted outputs; fused shared experts with a
sigmoid gate add to every token.  Routing, gating and the shared
experts stay digital, as in the reference.  The load-balancing aux loss
(Switch form) is returned; serving ignores it.

The reference builds a zero-padded (E, cap + 1, D) buffer and runs
``jax.vmap(cim_mvm)`` over the expert axis.  With deployed expert banks
the port packs the kept assignments instead, sorted by expert, into a
compact block of rows with per-expert offsets on the device, and runs
the three expert products through the grouped ``cim_mvm`` form: one
launch a bank, no host sync for the routing's counts, no read of an
expert no token chose.  Without a deployment the products are the
reference's digital einsum over the capacity buffer.  An expert whose
deployment is degraded (``degraded != 0``) is served digitally in f32,
as the reference's ``_expert_mm``; the port decides that on the host.

A token's K contributions are summed in ascending expert order, the
order of the reference's sorted scatter-add, in the activation dtype
and without atomics, so a bf16 sum does not change from run to run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Dispatch(NamedTuple):
    """Where each routed assignment goes, in expert-sorted order.

    e: (N,) expert; r: (N,) row in the expert's bucket (``bound`` for a
    dropped assignment); keep: (N,) bool; a: (N,) row of the compact
    block (``N`` for a dropped one); offsets: (E + 1,) int32, expert e's
    compact rows [offsets[e], offsets[e+1]); bound: the most rows an
    expert can keep (host-known, sizes the grid and the buffer).
    """

    e: torch.Tensor
    r: torch.Tensor
    keep: torch.Tensor
    a: torch.Tensor
    offsets: torch.Tensor
    bound: int


def _route(logits: torch.Tensor, K: int):
    """softmax, top-K (stable: equal probabilities to the lower index),
    renormalised weights.  logits (..., E) f32."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = vals[..., :K], idx[..., :K]
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    return probs, topk_w, topk_idx


def _aux_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
              E: int) -> torch.Tensor:
    """E * sum(dispatch fraction * mean router probability)."""
    frac = torch.bincount(topk_idx.reshape(-1), minlength=E).to(
        torch.float32) / topk_idx.numel()
    return E * torch.sum(frac * probs.reshape(-1, E).mean(0))


def _dispatch(e_s: torch.Tensor, r: torch.Tensor, keep: torch.Tensor,
              kept: torch.Tensor, bound: int) -> Dispatch:
    """The compact rows of the kept assignments: expert e's ``kept[e]``
    rows start at the exclusive cumsum of ``kept``."""
    n = e_s.numel()
    offsets = torch.zeros(kept.numel() + 1, dtype=torch.int64,
                          device=e_s.device)
    offsets[1:] = torch.cumsum(kept, 0)
    a = torch.where(keep, offsets[e_s] + r, n)
    r = torch.where(keep, r, bound)
    return Dispatch(e_s, r, keep, a, offsets.to(torch.int32), bound)


def _combine(y_tok: torch.Tensor, topk_idx: torch.Tensor,
             order: torch.Tensor) -> torch.Tensor:
    """out[t] = the sum of token t's K rows of ``y_tok``, added in
    ascending expert order in y's dtype.  ``y_tok`` is in the sorted
    order ``order`` (position i holds flat assignment ``order[i]``, flat
    t * K + k being token t's k-th choice ``topk_idx[t, k]``); returns
    (T, D)."""
    T, K = topk_idx.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    rank = torch.argsort(topk_idx, dim=-1, stable=True)      # experts up
    flat = torch.arange(T, device=order.device)[:, None] * K + rank
    rows = y_tok[inv[flat]]                                   # (T, K, D)
    out = rows[:, 0]
    for k in range(1, K):
        out = out + rows[:, k]
    return out


def _expert_mm(x: torch.Tensor, w: torch.Tensor, dep, disp: Dispatch,
               grouped) -> torch.Tensor:
    """Every expert's product on its kept assignments: x (N, in) in the
    dispatch's order, w (E, in, out) -> (N, out) in x's dtype, zero on a
    dropped assignment.  ``dep``: the bank stacked over experts, read
    through ``grouped(x, dep, offsets, cap)`` (the grouped cim_mvm form),
    or None for the reference's digital einsum."""
    E = w.shape[0]
    n = x.shape[0]
    if dep is None:
        buf = x.new_zeros((E, disp.bound + 1, x.shape[1]))
        buf[disp.e, disp.r] = x
        ye = torch.einsum("ecd,edf->ecf", buf[:, :disp.bound], w)
        y = ye[disp.e, disp.r.clamp(max=max(disp.bound - 1, 0))]
        return torch.where(disp.keep[:, None], y, 0).to(x.dtype)
    xc = x.new_empty((n + 1, x.shape[1]))
    xc[disp.a] = x                   # dropped rows all land on row n
    y = grouped(xc, dep, disp.offsets, disp.bound)[disp.a]
    if dep.degraded is not None:
        for e in torch.nonzero(dep.degraded.reshape(-1)).reshape(-1).tolist():
            # Demoted expert: served digitally in f32 on its weights.
            rows = disp.keep & (disp.e == e)
            dig = x.to(torch.float32) @ w[e].to(torch.float32)
            y = torch.where(rows[:, None], dig, y)
    return y.to(x.dtype)


def _experts(p: dict, xs: torch.Tensor, c, disp: Dispatch, grouped,
             prefix: str) -> torch.Tensor:
    """The routed SwiGLU experts on the assignments' rows ``xs``."""
    g = lambda n: p[prefix + n]
    mm = lambda a, n: _expert_mm(a, g(n), c(prefix + n), disp, grouped)
    h = _silu(mm(xs, "we_gate")) * mm(xs, "we_up")
    return mm(h, "we_down")


def _shared(p: dict, x: torch.Tensor, out: torch.Tensor,
            prefix: str) -> torch.Tensor:
    g = lambda n: p[prefix + n]
    hs = _silu(x @ g("ws_gate")) * (x @ g("ws_up"))
    ys = hs @ g("ws_down")
    gate = torch.sigmoid((x @ g("shared_gate")).to(torch.float32))
    return out + ys * gate.to(ys.dtype)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, grouped,
            prefix: str = "ffn_", cim: dict | None = None):
    """x (B, S, D) -> (y (B, S, D), aux loss f32 scalar).

    ``grouped(x, dep, offsets, cap)`` is the expert banks' matmul
    (``repro_torch.models.model.Ops.grouped``); ``cim`` the layer's
    deployments, the banks under ``ffn_we_{gate,up,down}`` stacked over
    experts (pipeline ``mdm_expert``).  ``cfg.moe_dispatch="grouped"``
    routes each sequence into its own capacity buckets
    (:func:`moe_ffn_grouped`)."""
    if cfg.moe_dispatch == "grouped":
        return moe_ffn_grouped(p, x, cfg, grouped, prefix, cim=cim)
    c = (lambda n: None) if cim is None else cim.get
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.n_experts_per_token
    xt = x.reshape(T, D)
    dev = x.device

    logits = (xt @ p[prefix + "router"]).to(torch.float32)       # (T, E)
    probs, topk_w, topk_idx = _route(logits, K)
    aux = _aux_loss(probs, topk_idx, E)

    cap = int(((K * T * cfg.capacity_factor / E) // 128 + 1) * 128)
    cap = min(cap, T * K)

    e_flat = topk_idx.reshape(-1)
    tok_flat = torch.arange(T * K, device=dev) // K
    w_flat = topk_w.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_s, tok_s, w_s = e_flat[order], tok_flat[order], w_flat[order]
    counts = torch.bincount(e_flat, minlength=E)
    offsets = torch.cumsum(counts, 0) - counts                   # exclusive
    pos = torch.arange(T * K, device=dev) - offsets[e_s]
    keep = pos < cap
    disp = _dispatch(e_s, pos, keep, torch.clamp(counts, max=cap), cap)

    ys = _experts(p, xt[tok_s], c, disp, grouped, prefix)
    y_tok = ys * (keep * w_s)[:, None].to(ys.dtype)
    out = _combine(y_tok, topk_idx, order)
    if cfg.n_shared_experts:
        out = _shared(p, xt, out, prefix)
    return out.reshape(B, S, D).to(x.dtype), aux


def moe_ffn_grouped(p: dict, x: torch.Tensor, cfg: ModelConfig, grouped,
                    prefix: str = "ffn_", cim: dict | None = None):
    """Group-local dispatch: each sequence routes its S tokens into its
    own capacity buckets (per-group capacity K*S*cf/E rounded to 8, the
    reference's).  The kept assignments of every group meet in one
    compact block sorted by expert, so the expert products are still one
    grouped launch a bank."""
    c = (lambda n: None) if cim is None else cim.get
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_per_token
    dev = x.device

    logits = (x @ p[prefix + "router"]).to(torch.float32)        # (B, S, E)
    probs, topk_w, topk_idx = _route(logits, K)
    aux = _aux_loss(probs, topk_idx, E)

    cap = int(((K * S * cfg.capacity_factor / E) // 8 + 1) * 8)
    cap = min(cap, S * K)

    e_flat = topk_idx.reshape(B, S * K)
    tok_flat = (torch.arange(S * K, device=dev) // K)[None].expand(B, S * K)
    w_flat = topk_w.reshape(B, S * K)
    order = torch.argsort(e_flat, dim=-1, stable=True)           # (B, SK)
    e_s = torch.gather(e_flat, 1, order)
    tok_s = torch.gather(tok_flat, 1, order)
    w_s = torch.gather(w_flat, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    offsets = torch.cumsum(counts, -1) - counts                  # (B, E)
    pos = torch.arange(S * K, device=dev)[None] - torch.gather(offsets, 1,
                                                                e_s)
    keep = pos < cap
    # Expert e's kept rows, group by group: group b's start after the
    # kept rows of groups < b.
    kept = torch.clamp(counts, max=cap)                          # (B, E)
    base = torch.cumsum(kept, 0) - kept
    r = torch.gather(base, 1, e_s) + pos
    flat_order = (order + torch.arange(B, device=dev)[:, None] * (S * K))
    disp = _dispatch(e_s.reshape(-1), r.reshape(-1), keep.reshape(-1),
                     kept.sum(0), min(B * cap, B * S * K))
    tok_g = (tok_s + torch.arange(B, device=dev)[:, None] * S).reshape(-1)
    xt = x.reshape(B * S, D)

    ys = _experts(p, xt[tok_g], c, disp, grouped, prefix)
    y_tok = ys * (keep.reshape(-1) * w_s.reshape(-1))[:, None].to(ys.dtype)
    out = _combine(y_tok, topk_idx.reshape(B * S, K), flat_order.reshape(-1))
    if cfg.n_shared_experts:
        out = _shared(p, xt, out, prefix)
    return out.reshape(B, S, D).to(x.dtype), aux
