"""Model assembly of the port: the ``"attn"`` decoder (SwiGLU or GELU
MLP or routed MoE, optional q/k/v biases), the ``"hybrid"`` and
``"mamba"`` blocks and the xLSTM ``("mlstm", "slstm")`` stack.

Port of ``repro.models.model``.  A forward takes tokens or, for a stub
frontend (``cfg.frontend``), precomputed (B, S, d_model) embeddings in
place of the token lookup.  The
reference scans its stacked layers with ``lax.scan``; here a Python loop
walks ``for r in repeats: for slot in pattern`` (the reference's scan
order) and takes each layer's views of the stacked parameters, decode
state and deployments.  One ``apply_model`` serves prefill (all prompt
positions) and decode (one position, ``decode=True``): attention caches
are ring buffers keyed by absolute positions, recurrent blocks carry
O(1) states (mamba ``conv``/``ssm``, mLSTM ``S``/``n``, sLSTM
``h``/``c``).  A hybrid block (hymba) averages its attention and mamba
heads, ``0.5 * (attention + mamba)``, then runs its FFN.

With a ``cim`` deployment tree (``cfg.cim.enabled`` serving, built by
``repro_torch.deploy.deploy_model_params``), every attention q/k/v/o
and MLP projection runs through ``cim_mvm``, every deployed MoE
expert bank through ``cim_mvm``'s grouped form (``models/moe.py``) and
every attention through ``flash_attention``: the hand-written kernels on
CUDA tensors.
As in the reference, the mamba, mLSTM and sLSTM mixers take no
deployment: their projections stay digital (mLSTM's even where the
deploy planned them), and the mamba mixer is plain PyTorch on both
devices (the reference has no kernel for it).
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

Training (:func:`train_loss`) runs the same forward digitally, as the
reference's does: no deployment, :data:`PLAIN` ops (the plain attention
and sLSTM scan, differentiable under autograd), each pattern repeat
recomputed in the backward under ``cfg.remat`` (the reference's
``jax.checkpoint`` around its scan body), and the MoE's aux loss summed
over the layers.  Each stacked parameter is split into its per-layer
views once a forward (``unbind``), so the backward stacks a leaf's
gradient in one pass instead of materialising the whole stacked leaf
for every layer's ``select``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
    mamba_decode,
    mamba_mixer,
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
    ``grouped(x, dep, offsets, cap, read_seed) -> y``: x (A, in_dim)
    sorted by expert through an expert bank (``dep`` stacked over
    experts), expert e's rows [offsets[e], min(offsets[e+1], offsets[e] +
    cap)) (f32), each expert read with its own noise tag.
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


def _grouped_kernel(x, dep, offsets, cap, read_seed=None):
    return cim_mvm_grouped(x, dep, offsets, cap, read_seed, device=x.device)


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
    """The MLP, by its parameters: SwiGLU, silu(x Wg) * (x Wu), where
    there is an ``ffn_w_gate``, else GELU, gelu(x Wu) in the tanh form
    (``jax.nn.gelu``'s default); then Wd."""
    c = (lambda n: None) if cim is None else cim.get
    mm = lambda a, n: _cim_matmul(a, p[n], c(n), ops, read_seed)
    if "ffn_w_gate" in p:
        h = _silu(mm(x, "ffn_w_gate")) * mm(x, "ffn_w_up")
    else:
        h = torch.nn.functional.gelu(mm(x, "ffn_w_up"), approximate="tanh")
    return mm(h, "ffn_w_down")


def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cache: dict | None,
               cim: dict | None = None, ops: Ops = KERNELS,
               read_seed: int | None = None, prefix: str = ""):
    """Attention sublayer.  ``cache`` holds one layer's ring buffers
    {k (B, C, Hkv, Dh), v, kpos (C,)}, written in place at
    ``positions % C``; with per-lane positions (B, S), ``kpos`` is
    (B, C) and each lane writes its own slots.  A prefill longer than
    the ring writes, and attends over, its last C keys only, as the
    reference does.  Under ``cfg.qkv_bias`` the q, k, v biases are added
    after the projections, before RoPE.  ``prefix`` names the
    parameters and deployments (``attn_`` in a hybrid block).
    Returns y (B, S, D)."""
    cim = {} if cim is None else cim
    c = lambda n: cim.get(prefix + n)
    g = lambda n: p[prefix + n]
    B, S, _ = x.shape

    def qkv_proj(name):
        w, dep = g(name), c(name)
        if dep is None:
            return torch.einsum("bsd,dhk->bshk", x, w)
        return _cim_matmul(x, w, dep, ops, read_seed).reshape(
            B, S, *w.shape[-2:])

    q, k, v = qkv_proj("wq"), qkv_proj("wk"), qkv_proj("wv")
    if cfg.qkv_bias:
        q, k, v = q + g("bq"), k + g("bk"), v + g("bv")
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
        return torch.einsum("bshk,hkd->bsd", out, g("wo"))
    return _cim_matmul(out.reshape(B, S, -1), g("wo"), c("wo"), ops,
                       read_seed)


def _mamba(p: dict, h: torch.Tensor, cfg: ModelConfig, state: dict | None,
           decode: bool, prefix: str = "") -> torch.Tensor:
    """The mamba mixer (one step when ``decode``), its conv and ssm
    state advanced in place."""
    st = None if state is None else (state["conv"], state["ssm"])
    if decode:
        y, new = mamba_decode(p, h, st, prefix=prefix)
    else:
        y, new = mamba_mixer(p, h, st, chunk=cfg.ssm_chunk, prefix=prefix)
    if state is not None:
        state["conv"].copy_(new[0])
        state["ssm"].copy_(new[1])
    return y


def block_apply(bt: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, state: dict | None, decode: bool,
                cim: dict | None = None, ops: Ops = KERNELS,
                read_seed: int | None = None):
    """One block of type ``bt``: pre-norm mixer, then (``"attn"`` and
    ``"hybrid"``) the pre-norm FFN: the MoE with ``cfg.n_experts``, else
    the dense MLP.  ``state`` is the block's slice of the decode state,
    advanced in place.  Returns (x, aux): the MoE's load-balancing loss
    (f32 scalar), 0.0 for a block without one."""
    aux = 0.0
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    if bt == "attn":
        y = attn_apply(p, h, cfg, positions, state, cim=cim, ops=ops,
                       read_seed=read_seed)
    elif bt == "hybrid":
        y_attn = attn_apply(p, h, cfg, positions, state, cim=cim, ops=ops,
                            read_seed=read_seed, prefix="attn_")
        y = 0.5 * (y_attn + _mamba(p, h, cfg, state, decode, "ssm_"))
    elif bt == "mamba":
        y = _mamba(p, h, cfg, state, decode)
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
    if bt in ("attn", "hybrid") and cfg.mlp_type != "none":
        hf = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
        if cfg.n_experts:
            yf, aux = moe_ffn(p, hf, cfg, ops.grouped, cim=cim,
                              read_seed=read_seed)
            x = x + yf
        else:
            x = x + dense_mlp(p, hf, cim=cim, ops=ops, read_seed=read_seed)
    return x, aux


# Matmul outputs, the tensors ``remat="dots"`` keeps for the backward
# (the reference's ``checkpoint_dots`` policy saves every dot_general).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, remat: str) -> Callable:
    """``fn`` recomputed in the backward: everything (``"full"``), all
    but its matmul outputs (``"dots"``), or nothing (``"none"``)."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        ctx = lambda: create_selective_checkpoint_contexts(_save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    raise ValueError(f"remat={remat!r} not in ('full', 'dots', 'none')")


def apply_model(params: dict, cfg: ModelConfig,
                tokens: torch.Tensor | None = None, *,
                embeds: torch.Tensor | None = None,
                state: ModelState | None = None, decode: bool = False,
                cim: dict | None = None, ops: Ops = KERNELS,
                read_seed: int | None = None, return_hidden: bool = False):
    """tokens (B, S), or embeds (B, S, D) in place of the token lookup
    (cast to ``cfg.dtype``; exactly one of the two) -> (logits (B, S, V)
    f32, new_state).

    ``state`` (from :func:`init_decode_state`) is advanced in place;
    the returned dict shares its tensors with a new ``pos``.  A shared
    clock ``pos`` is a Python int; a per-slot one (``per_slot=True``)
    a (B,) tensor, which gives lane b the positions ``pos[b] + arange(S)``.
    ``decode`` selects the one-step mamba and mLSTM forms (one token after a
    prefill), as the reference's ``decode`` flag does.  ``read_seed``
    is this forward's crossbar read (None: noiseless).

    ``return_hidden`` returns (hidden (B, S, D) after the final norm,
    new_state, aux) instead: ``aux`` is the MoE's aux loss summed over
    the layers (0.0 without experts).  A stateless forward with autograd
    on recomputes each pattern repeat in the backward as ``cfg.remat``
    says (the reference's training forward).
    """
    check_supported(cfg)
    if (tokens is None) == (embeds is None):
        raise ValueError("apply_model takes tokens or embeds, exactly one")
    if embeds is None:
        x = params["embed"][tokens.to(torch.int64)]
    else:
        x = embeds.to(sch.param_dtype(cfg))
    S = x.shape[1]
    pos0 = 0 if state is None else state["pos"]
    if isinstance(pos0, torch.Tensor):          # per-slot clocks (B,)
        positions = pos0[:, None] + torch.arange(S, dtype=torch.int32,
                                                 device=x.device)
    else:
        positions = torch.arange(pos0, pos0 + S, dtype=torch.int32,
                                 device=x.device)
    slots = [f"slot{i}_{bt}" for i, bt in enumerate(cfg.block_pattern)]
    layers = {slot: {k: v.unbind(0) for k, v in params[slot].items()}
              for slot in slots}

    def repeat(x: torch.Tensor, r: int):
        aux = 0.0
        for bt, slot in zip(cfg.block_pattern, slots):
            p = {k: v[r] for k, v in layers[slot].items()}
            ci = None if cim is None else {
                k: d.layer(r) for k, d in cim.get(slot, {}).items()}
            st = (None if state is None
                  else {k: v[r] for k, v in state[slot].items()})
            x, a = block_apply(bt, p, x, cfg, positions, st, decode, cim=ci,
                               ops=ops, read_seed=read_seed)
            aux = aux + a
        return x, aux

    if state is None and torch.is_grad_enabled():
        repeat = _remat(repeat, cfg.remat)
    aux = 0.0
    for r in range(cfg.pattern_repeats):
        x, a = repeat(x, r)
        aux = aux + a

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    new_state = None if state is None else dict(state, pos=pos0 + S)
    if return_hidden:
        return x, new_state, aux
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
    starting at EMPTY_POS (self-masking); mamba ``conv`` (R, B, K-1, Di)
    in the parameters' dtype and ``ssm`` (R, B, Di, N), Di = d_model *
    ssm_expand (a hybrid block has both the ring and these); mLSTM ``S``
    (R, B, H, Dh, Dh) and ``n`` (R, B, H, Dh) with Dh = d_model *
    ssm_expand / H; sLSTM ``h`` and ``c`` (R, B, H, d_model / H);
    recurrent states f32 and zero.  ``cache_len`` sizes only attention
    caches.  ``pos`` is 0.

    ``per_slot=True`` is the slot-pool layout of continuous batching:
    ``pos`` is a (B,) int32 tensor of zeros and ``kpos`` (R, B, C), so
    each lane keeps its own clock and ring occupancy."""
    check_supported(cfg)
    R, H = cfg.pattern_repeats, cfg.n_heads
    dtype = sch.param_dtype(cfg)
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(
        (R, batch) + shape, dtype=dtype, device=device)
    Di = cfg.d_model * cfg.ssm_expand
    state: ModelState = {}
    for i, bt in enumerate(cfg.block_pattern):
        st = {}
        if bt in ("attn", "hybrid"):
            Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
            C = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                 else cache_len)
            st = {"k": zeros(C, Hkv, Dh, dtype=dtype),
                  "v": zeros(C, Hkv, Dh, dtype=dtype),
                  "kpos": torch.full((R,) + ((batch,) if per_slot else ())
                                     + (C,), EMPTY_POS, dtype=torch.int32,
                                     device=device)}
        if bt in ("hybrid", "mamba"):
            st.update(conv=zeros(cfg.ssm_conv - 1, Di, dtype=dtype),
                      ssm=zeros(Di, cfg.ssm_state))
        elif bt == "mlstm":
            Dh = cfg.d_model * cfg.ssm_expand // H
            st = {"S": zeros(H, Dh, Dh), "n": zeros(H, Dh)}
        elif bt == "slstm":
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



# -------------------------------- loss -----------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean CE; labels < 0 are masked."""
    ce, n = _ce_sum(logits, labels)
    return ce / torch.clamp(n, min=1)


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the valid tokens' CE, their count)."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def train_loss(params: dict, cfg: ModelConfig, batch: dict,
               cim: dict | None = None):
    """batch: {"tokens": (B, S+1)} or {"embeds": (B, S, D), "labels":
    (B, S)} -> (loss, {"ce", "aux"}), f32 scalars; loss = ce + 0.01 aux.

    Digital, as the reference's: the plain ops (:data:`PLAIN`) and no
    deployment (``cim`` is refused).  With ``cfg.loss_chunk`` dividing
    S, the logits and CE go ``loss_chunk`` positions at a time, each
    chunk recomputed in the backward (the reference's checkpointed
    ``chunk_ce``), so the (B, S, V) logits never exist whole."""
    if cim is not None:
        raise ValueError("train_loss trains digitally, as the reference's: "
                         "it takes no cim deployment")
    if "embeds" in batch:
        hidden, _, aux = apply_model(params, cfg, embeds=batch["embeds"],
                                     ops=PLAIN, return_hidden=True)
        labels = batch["labels"]
    else:
        toks = batch["tokens"]
        hidden, _, aux = apply_model(params, cfg, toks[:, :-1], ops=PLAIN,
                                     return_hidden=True)
        labels = toks[:, 1:]
    aux = torch.as_tensor(aux, dtype=torch.float32, device=hidden.device)

    S = hidden.shape[1]
    if cfg.loss_chunk and S % cfg.loss_chunk == 0:
        chunk_ce = lambda h, l: _ce_sum(lm_logits(params, cfg, h), l)
        tot, cnt = 0.0, 0
        for c0 in range(0, S, cfg.loss_chunk):
            sl = slice(c0, c0 + cfg.loss_chunk)
            s, n = checkpoint(chunk_ce, hidden[:, sl], labels[:, sl],
                              use_reentrant=False)
            tot, cnt = tot + s, cnt + n
        ce = tot / torch.clamp(cnt, min=1)
    else:
        ce = cross_entropy(lm_logits(params, cfg, hidden), labels)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}
