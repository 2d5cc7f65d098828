"""Model assembly of the port: the ``"attn"`` decoder (SwiGLU MLP or
routed MoE, optional q/k/v biases) and the xLSTM ``("mlstm", "slstm")``
stack.

Port of the dense, MoE and xLSTM paths of ``repro.models.model``.  The
reference scans its stacked layers with ``lax.scan``; here a Python loop
walks ``for r in repeats: for slot in pattern`` (the reference's scan
order) and takes each layer's views of the stacked parameters, decode
state and deployments.  One ``apply_model`` serves prefill (all prompt
positions) and decode (one position, ``decode=True``): attention caches
are ring buffers keyed by absolute positions, recurrent blocks carry
O(1) states (mLSTM ``S``/``n``, sLSTM ``h``/``c``).

With a ``cim`` deployment tree (``cfg.cim.enabled`` serving, built by
``repro_torch.deploy.deploy_model_params``), every attention q/k/v/o
and SwiGLU projection runs through ``cim_mvm``, every deployed MoE
expert bank through ``cim_mvm``'s grouped form (``models/moe.py``) and
every attention through ``flash_attention``: the hand-written kernels on
CUDA tensors.
As in the reference, the mLSTM and sLSTM blocks take no deployment:
their projections stay digital even where the deploy planned them.
Every sLSTM recurrence runs through ``slstm_scan``.  Which four
functions a forward calls is one :class:`Ops` tuple handed to
:func:`apply_model`: :data:`KERNELS` (the default) or :data:`PLAIN`,
the plain PyTorch versions, which validate the kernels on the card.

Activations, parameters and the KV cache are in ``cfg.dtype`` (f32 or
bf16); each ``cim_mvm`` result (f32) is cast to the activation dtype,
as in the reference, and logits are f32.  A deployment that lost
programmed bits to open lines (``degraded != 0``) is served digitally,
``x @ w`` on the full-precision weight; the reference decides that
with ``lax.cond`` in its traced graph, the port on the host.  A
forward's ``read_seed`` draws this read's noise in every deployment
that carries read noise (each with its own tag).

Unlike the reference's pure functions, the decode state is updated in
place: the cache write of each step and each new recurrent state goes
into the state's tensors, so a step never copies the whole state.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.kernels.cim_mvm.ops import cim_mvm, cim_mvm_grouped
from repro_torch.kernels.cim_mvm.ref import (
    cim_mvm_grouped_plain,
    cim_mvm_plain,
)
from repro_torch.kernels.slstm_scan.ref import slstm_scan_plain
from repro_torch.models import schema as sch
from repro_torch.models.attention import (
    EMPTY_POS,
    flash_attention,
    flash_attention_plain,
    rope,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.recurrent import (
    mlstm_decode,
    mlstm_mixer,
    slstm_mixer,
    slstm_scan_kernel,
)

ModelState = dict[str, Any]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * w.to(torch.float32)).to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Ops(NamedTuple):
    """The four kernels a forward pass calls.

    ``matmul(x, dep, read_seed)``: x (..., in_dim) through one
    ``CimDeployment`` (``read_seed`` None: a noiseless read);
    ``attention(q, k, v, q_pos, k_pos, window, chunk)``: causal
    attention over absolute positions;
    ``slstm_scan(gx, r_gates, h0, c0) -> (hs, hT, cT)``: the sLSTM
    recurrence;
    ``grouped(x, dep, offsets, cap) -> y``: x (A, in_dim) sorted by
    expert through an expert bank (``dep`` stacked over experts), expert
    e's rows [offsets[e], min(offsets[e+1], offsets[e] + cap)) (f32).
    """
    matmul: Callable[..., torch.Tensor]
    attention: Callable[..., torch.Tensor]
    slstm_scan: Callable[..., tuple]
    grouped: Callable[..., torch.Tensor]


def _matmul_kernel(x: torch.Tensor, dep, read_seed=None) -> torch.Tensor:
    return cim_mvm(x, dep, read_seed, device=x.device)


def _matmul_plain(x: torch.Tensor, dep, read_seed=None) -> torch.Tensor:
    y = cim_mvm_plain(x.reshape(-1, dep.in_dim), dep, read_seed)
    return y.reshape(*x.shape[:-1], dep.out_dim)


def _attention_kernel(q, k, v, q_pos, k_pos, window, chunk):
    return flash_attention(q, k, v, q_positions=q_pos, k_positions=k_pos,
                           window=window, chunk=chunk, device=q.device)


def _grouped_kernel(x, dep, offsets, cap):
    return cim_mvm_grouped(x, dep, offsets, cap, device=x.device)


KERNELS = Ops(_matmul_kernel, _attention_kernel, slstm_scan_kernel,
              _grouped_kernel)
PLAIN = Ops(_matmul_plain, flash_attention_plain, slstm_scan_plain,
            cim_mvm_grouped_plain)


def _cim_matmul(x: torch.Tensor, w: torch.Tensor, dep, ops: Ops,
                read_seed: int | None = None) -> torch.Tensor:
    """x @ w, through the deployed crossbars when a deployment exists;
    a degraded deployment (programmed bits on open lines) is served
    digitally on the full-precision weight."""
    if dep is None:
        return x @ w
    if dep.degraded is not None and int(dep.degraded) != 0:
        return (x @ w.reshape(dep.in_dim, dep.out_dim)).to(x.dtype)
    return ops.matmul(x, dep, read_seed).to(x.dtype)


def dense_mlp(p: dict, x: torch.Tensor, cim: dict | None = None,
              ops: Ops = KERNELS, read_seed: int | None = None
              ) -> torch.Tensor:
    """SwiGLU MLP: silu(x Wg) * (x Wu), then Wd."""
    c = (lambda n: None) if cim is None else cim.get
    mm = lambda a, n: _cim_matmul(a, p[n], c(n), ops, read_seed)
    h = _silu(mm(x, "ffn_w_gate")) * mm(x, "ffn_w_up")
    return mm(h, "ffn_w_down")


def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cache: dict | None,
               cim: dict | None = None, ops: Ops = KERNELS,
               read_seed: int | None = None):
    """Attention sublayer.  ``cache`` holds one layer's ring buffers
    {k (B, C, Hkv, Dh), v, kpos (C,)}, written in place at
    ``positions % C``; with per-lane positions (B, S), ``kpos`` is
    (B, C) and each lane writes its own slots.  Under ``cfg.qkv_bias``
    the q, k, v biases are added after the projections, before RoPE.
    Returns y (B, S, D)."""
    c = (lambda n: None) if cim is None else cim.get
    B, S, _ = x.shape

    def qkv_proj(name):
        w, dep = p[name], c(name)
        if dep is None:
            return torch.einsum("bsd,dhk->bshk", x, w)
        return _cim_matmul(x, w, dep, ops, read_seed).reshape(
            B, S, *w.shape[-2:])

    q, k, v = qkv_proj("wq"), qkv_proj("wk"), qkv_proj("wv")
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        k_all, v_all, k_pos = k, v, positions
    else:
        C = cache["k"].shape[1]
        Sw = min(S, C)
        pw = positions[..., S - Sw:]
        idx = (pw % C).to(torch.int64)
        kw = k[:, S - Sw:].to(cache["k"].dtype)
        vw = v[:, S - Sw:].to(cache["v"].dtype)
        if positions.ndim == 2:
            # Per-slot state: every lane has its own clock and kpos row,
            # so the write is a per-lane scatter, one slot a (lane,
            # position).
            b = torch.arange(B, device=idx.device)[:, None]
            cache["k"][b, idx] = kw
            cache["v"][b, idx] = vw
            cache["kpos"][b, idx] = pw
        else:
            cache["k"][:, idx] = kw
            cache["v"][:, idx] = vw
            cache["kpos"][idx] = pw
        k_all, v_all, k_pos = cache["k"], cache["v"], cache["kpos"]

    out = ops.attention(q, k_all, v_all, positions, k_pos,
                        cfg.sliding_window, cfg.attn_chunk)
    if c("wo") is None:
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return _cim_matmul(out.reshape(B, S, -1), p["wo"], c("wo"), ops,
                       read_seed)


def block_apply(bt: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, state: dict | None, decode: bool,
                cim: dict | None = None, ops: Ops = KERNELS,
                read_seed: int | None = None) -> torch.Tensor:
    """One block of type ``bt``: pre-norm mixer, then (``"attn"`` only)
    the pre-norm FFN: the MoE with ``cfg.n_experts`` (its aux loss
    dropped: serving ignores it), else the SwiGLU MLP.  ``state`` is the
    block's slice of the decode state, advanced in place."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    if bt == "attn":
        y = attn_apply(p, h, cfg, positions, state, cim=cim, ops=ops,
                       read_seed=read_seed)
    elif bt == "mlstm":
        st = None if state is None else (state["S"], state["n"])
        if decode:
            y, new = mlstm_decode(p, h, st)
        else:
            y, new = mlstm_mixer(p, h, st, chunk=cfg.mlstm_chunk)
        if state is not None:
            state["S"].copy_(new[0])
            state["n"].copy_(new[1])
    elif bt == "slstm":
        st = None if state is None else (state["h"], state["c"])
        y, new = slstm_mixer(p, h, st, scan=ops.slstm_scan)
        if state is not None:
            state["h"].copy_(new[0])
            state["c"].copy_(new[1])
    else:
        raise ValueError(f"unknown block type {bt}")
    x = x + y
    if bt == "attn" and cfg.mlp_type != "none":
        hf = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
        if cfg.n_experts:
            x = x + moe_ffn(p, hf, cfg, ops.grouped, cim=cim)[0]
        else:
            x = x + dense_mlp(p, hf, cim=cim, ops=ops, read_seed=read_seed)
    return x


def apply_model(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                state: ModelState | None = None, decode: bool = False,
                cim: dict | None = None, ops: Ops = KERNELS,
                read_seed: int | None = None):
    """tokens (B, S) -> (logits (B, S, V) f32, new_state).

    ``state`` (from :func:`init_decode_state`) is advanced in place;
    the returned dict shares its tensors with a new ``pos``.  A shared
    clock ``pos`` is a Python int; a per-slot one (``per_slot=True``)
    a (B,) tensor, which gives lane b the positions ``pos[b] + arange(S)``.
    ``decode`` selects the one-step mLSTM form (one token after a
    prefill), as the reference's ``decode`` flag does.  ``read_seed``
    is this forward's crossbar read (None: noiseless).
    """
    check_supported(cfg)
    x = params["embed"][tokens.to(torch.int64)]
    S = x.shape[1]
    pos0 = 0 if state is None else state["pos"]
    if isinstance(pos0, torch.Tensor):          # per-slot clocks (B,)
        positions = pos0[:, None] + torch.arange(S, dtype=torch.int32,
                                                 device=x.device)
    else:
        positions = torch.arange(pos0, pos0 + S, dtype=torch.int32,
                                 device=x.device)
    slots = [f"slot{i}_{bt}" for i, bt in enumerate(cfg.block_pattern)]
    for r in range(cfg.pattern_repeats):
        for bt, slot in zip(cfg.block_pattern, slots):
            p = {k: v[r] for k, v in params[slot].items()}
            ci = None if cim is None else {
                k: d.layer(r) for k, d in cim.get(slot, {}).items()}
            st = (None if state is None
                  else {k: v[r] for k, v in state[slot].items()})
            x = block_apply(bt, p, x, cfg, positions, st, decode, cim=ci,
                            ops=ops, read_seed=read_seed)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    new_state = None if state is None else dict(state, pos=pos0 + S)
    return lm_logits(params, cfg, x), new_state


def lm_logits(params: dict, cfg: ModelConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    logits = (hidden @ params["lm_head"]).to(torch.float32)
    if cfg.padded_vocab > cfg.vocab_size:
        pad = (torch.arange(cfg.padded_vocab, device=logits.device)
               >= cfg.vocab_size).to(torch.float32)
        logits = logits - 1e9 * pad
    return logits


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device: str | torch.device,
                      per_slot: bool = False) -> ModelState:
    """Fresh decode state, one dict per pattern slot, stacked over the
    repeats R: ``"attn"`` ring buffers k, v (R, B, C, Hkv, Dh) with
    C = min(cache_len, sliding_window or cache_len) and ``kpos`` (R, C)
    starting at EMPTY_POS (self-masking); mLSTM ``S`` (R, B, H, Dh, Dh)
    and ``n`` (R, B, H, Dh) with Dh = d_model * ssm_expand / H; sLSTM
    ``h`` and ``c`` (R, B, H, d_model / H); recurrent states f32 and
    zero.  ``cache_len`` sizes only attention caches.  ``pos`` is 0.

    ``per_slot=True`` is the slot-pool layout of continuous batching:
    ``pos`` is a (B,) int32 tensor of zeros and ``kpos`` (R, B, C), so
    each lane keeps its own clock and ring occupancy."""
    check_supported(cfg)
    R, H = cfg.pattern_repeats, cfg.n_heads
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(
        (R, batch) + shape, dtype=dtype, device=device)
    state: ModelState = {}
    for i, bt in enumerate(cfg.block_pattern):
        if bt == "attn":
            Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
            C = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                 else cache_len)
            dtype = sch.param_dtype(cfg)
            st = {"k": zeros(C, Hkv, Dh, dtype=dtype),
                  "v": zeros(C, Hkv, Dh, dtype=dtype),
                  "kpos": torch.full((R,) + ((batch,) if per_slot else ())
                                     + (C,), EMPTY_POS, dtype=torch.int32,
                                     device=device)}
        elif bt == "mlstm":
            Dh = cfg.d_model * cfg.ssm_expand // H
            st = {"S": zeros(H, Dh, Dh), "n": zeros(H, Dh)}
        else:                                   # "slstm"
            Dh = cfg.d_model // H
            st = {"h": zeros(H, Dh), "c": zeros(H, Dh)}
        state[f"slot{i}_{bt}"] = st
    state["pos"] = (torch.zeros(batch, dtype=torch.int32, device=device)
                    if per_slot else 0)
    return state


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device) -> dict:
    """Random parameters at the config's widths, in ``cfg.dtype`` (see
    ``schema``)."""
    return sch.materialize(cfg, generator, device)

