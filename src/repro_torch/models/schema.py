"""Parameter schema of the served models: names, shapes, initialisation.

Port of the ``"attn"`` (dense or MoE FFN, optional q/k/v biases),
``"mlstm"`` and ``"slstm"`` parts of ``repro.models.schema``.  Names
and shapes map 1:1 onto the reference's parameter tree: ``embed``,
``final_norm``, ``lm_head`` and one ``slot{i}_{block}`` dict per entry
of the block pattern (for the dense decoder ``slot0_attn/{norm, wq,
wk, wv, wo, ffn_norm, ffn_w_up, ffn_w_down, ffn_w_gate}``, with
``bq``/``bk``/``bv`` under ``qkv_bias``; for an MoE decoder the FFN is
``ffn_{norm, router, we_gate, we_up, we_down}`` and, with shared
experts, ``ffn_{ws_gate, ws_up, ws_down, shared_gate}``; for xLSTM
``slot0_mlstm`` and ``slot1_slstm``), the block parameters stacked
over the pattern repeats.

The init draws from an explicit ``torch.Generator`` (its numbers differ
from JAX's for the same seed; reference weights reach the port through
``repro_torch.convert``).  Its standard deviations mirror the
reference's ``ParamSpec.stddev()`` exactly as the reference applies it
to the *stacked* shapes: the repeat axis enters the fan-in, so ``wq``
(R, D, H, Dh) gets (R*D*H)^-1/2 and the 3-D ``ffn_w_*`` (R, D, F) get
R^-1/2 (so do the mLSTM ``wq``/``wk``/``wv``, the sLSTM ``w_gates``,
the MoE router (R, D, E) and shared gate (R, D, 1)), while the 4-D
expert banks (R, E, D, F) get (R*E*D)^-1/2.  That is a reference
quirk, kept here on purpose.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, check_supported


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"         # normal | zeros | ones
    scale: float = 0.0           # stddev; 0 -> fan-in rule below

    def stddev(self) -> float:
        if self.scale:
            return self.scale
        fan_in = self.shape[0] if len(self.shape) == 1 else 1
        if len(self.shape) >= 2:
            fan_in = 1
            for s in self.shape[:-1]:
                fan_in *= s
            if len(self.shape) == 3:
                fan_in = self.shape[0]
        return fan_in ** -0.5


def attn_block_schema(cfg: ModelConfig) -> dict:
    """The ``"attn"`` block: attention (with q/k/v biases under
    ``qkv_bias``), then its FFN: the routed MoE when ``n_experts`` is
    set, else the SwiGLU MLP, each under the ``ffn_`` prefix."""
    D, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    s = {
        "norm": ParamSpec((D,), "ones"),
        "wq": ParamSpec((D, H, Dh)),
        "wk": ParamSpec((D, Hkv, Dh)),
        "wv": ParamSpec((D, Hkv, Dh)),
        "wo": ParamSpec((H, Dh, D)),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, Dh), "zeros")
        s["bk"] = ParamSpec((Hkv, Dh), "zeros")
        s["bv"] = ParamSpec((Hkv, Dh), "zeros")
    ffn = moe_schema(cfg) if cfg.n_experts else mlp_schema(cfg)
    s.update({f"ffn_{k}": v for k, v in ffn.items()})
    return s


def mlp_schema(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "norm": ParamSpec((D,), "ones"),
        "w_up": ParamSpec((D, F)),
        "w_down": ParamSpec((F, D)),
        "w_gate": ParamSpec((D, F)),
    }


def moe_schema(cfg: ModelConfig) -> dict:
    """Router (D, E), the routed experts' banks (E, D, Fe) / (E, Fe, D)
    and, with ``n_shared_experts``, the fused shared experts of width
    ``d_ff`` and their gate (D, 1)."""
    D, E = cfg.d_model, cfg.n_experts
    Fe = cfg.moe_d_ff or cfg.d_ff
    s = {
        "norm": ParamSpec((D,), "ones"),
        "router": ParamSpec((D, E)),
        "we_gate": ParamSpec((E, D, Fe)),
        "we_up": ParamSpec((E, D, Fe)),
        "we_down": ParamSpec((E, Fe, D)),
    }
    if cfg.n_shared_experts:
        F = cfg.d_ff
        s["ws_gate"] = ParamSpec((D, F))
        s["ws_up"] = ParamSpec((D, F))
        s["ws_down"] = ParamSpec((F, D))
        s["shared_gate"] = ParamSpec((D, 1))
    return s


def mlstm_schema(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Di = D * cfg.ssm_expand
    H = cfg.n_heads
    Dh = Di // H
    return {
        "norm": ParamSpec((D,), "ones"),
        "w_up": ParamSpec((D, 2 * Di)),
        "wq": ParamSpec((Di, H, Dh)),
        "wk": ParamSpec((Di, H, Dh)),
        "wv": ParamSpec((Di, H, Dh)),
        "w_if": ParamSpec((Di, 2 * H), "normal", 0.01),
        "b_if": ParamSpec((2 * H,), "zeros"),
        "w_down": ParamSpec((Di, D)),
    }


def slstm_schema(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    Dh = D // H
    return {
        "norm": ParamSpec((D,), "ones"),
        "w_gates": ParamSpec((D, H, 4 * Dh)),
        "r_gates": ParamSpec((H, Dh, 4 * Dh), "normal", 0.02),
        "b_gates": ParamSpec((H, 4 * Dh), "zeros"),
        "w_out": ParamSpec((D, D)),
    }


_BLOCK_SCHEMAS = {"attn": attn_block_schema, "mlstm": mlstm_schema,
                  "slstm": slstm_schema}


def model_schema(cfg: ModelConfig) -> dict:
    """Full parameter schema; blocks stacked over pattern repeats."""
    check_supported(cfg)
    V, D, R = cfg.padded_vocab, cfg.d_model, cfg.pattern_repeats
    schema = {
        "embed": ParamSpec((V, D), "normal", 0.02),
        "final_norm": ParamSpec((D,), "ones"),
        "lm_head": ParamSpec((D, V)),
    }
    for i, bt in enumerate(cfg.block_pattern):
        schema[f"slot{i}_{bt}"] = {
            k: ParamSpec((R,) + s.shape, s.init, s.scale)
            for k, s in _BLOCK_SCHEMAS[bt](cfg).items()}
    return schema


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """The parameters' torch dtype, ``cfg.dtype`` by name."""
    return getattr(torch, cfg.dtype)


def materialize(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device) -> dict:
    """Initialised parameter dict matching :func:`model_schema`, drawn
    leaf by leaf in schema order from ``generator`` (which must live on
    ``device``), in ``cfg.dtype``."""
    dtype = param_dtype(cfg)

    def build(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        w = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=device)
        return w.mul_(spec.stddev()).to(dtype)

    def walk(node):
        if isinstance(node, ParamSpec):
            return build(node)
        return {k: walk(v) for k, v in node.items()}

    return walk(model_schema(cfg))
