"""Parameter schema of the served models: names, shapes, initialisation.

Port of the ``"attn"`` (dense or MoE FFN, optional q/k/v biases),
``"hybrid"``, ``"mamba"``, ``"mlstm"`` and ``"slstm"`` parts of
``repro.models.schema``.  Names
and shapes map 1:1 onto the reference's parameter tree: ``embed``,
``final_norm``, ``lm_head`` and one ``slot{i}_{block}`` dict per entry
of the block pattern (for the dense decoder ``slot0_attn/{norm, wq,
wk, wv, wo, ffn_norm, ffn_w_up, ffn_w_down, ffn_w_gate}``, with
``bq``/``bk``/``bv`` under ``qkv_bias`` and no ``ffn_w_gate`` under
the GELU MLP; for an MoE decoder the FFN is
``ffn_{norm, router, we_gate, we_up, we_down}`` and, with shared
experts, ``ffn_{ws_gate, ws_up, ws_down, shared_gate}``; a hybrid
block ``slot0_hybrid/{norm, attn_wq, attn_wk, attn_wv, attn_wo, ssm_w_in,
ssm_conv_w, ssm_conv_b, ssm_w_dt, ssm_b_dt, ssm_w_bc, ssm_a_log,
ssm_d_skip, ssm_w_out}`` and its ``ffn_`` MLP; a mamba block the
``ssm_`` names unprefixed and no FFN; for xLSTM ``slot0_mlstm`` and
``slot1_slstm``), the block parameters stacked over the pattern repeats.

The init draws from an explicit ``torch.Generator`` (its numbers differ
from JAX's for the same seed; reference weights reach the port through
``repro_torch.convert``).  Its standard deviations mirror the
reference's ``ParamSpec.stddev()`` exactly as the reference applies it
to the *stacked* shapes: the repeat axis enters the fan-in, so ``wq``
(R, D, H, Dh) gets (R*D*H)^-1/2 and the 3-D ``ffn_w_*`` (R, D, F) get
R^-1/2 (so do the mLSTM ``wq``/``wk``/``wv``, the sLSTM ``w_gates``,
the mamba ``w_in``/``w_bc``/``w_out``, the MoE router (R, D, E) and
shared gate (R, D, 1)), while the 4-D
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


def attn_schema(cfg: ModelConfig) -> dict:
    """Attention, with q/k/v biases under ``qkv_bias``."""
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
    return s


def mlp_schema(cfg: ModelConfig) -> dict:
    """The SwiGLU MLP's up, down and gate; the GELU MLP has no gate."""
    D, F = cfg.d_model, cfg.d_ff
    s = {
        "norm": ParamSpec((D,), "ones"),
        "w_up": ParamSpec((D, F)),
        "w_down": ParamSpec((F, D)),
    }
    if cfg.mlp_type == "swiglu":
        s["w_gate"] = ParamSpec((D, F))
    return s


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


def mamba_schema(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Di = D * cfg.ssm_expand
    N = cfg.ssm_state
    return {
        "norm": ParamSpec((D,), "ones"),
        "w_in": ParamSpec((D, 2 * Di)),
        "conv_w": ParamSpec((cfg.ssm_conv, Di), "normal", 0.5),
        "conv_b": ParamSpec((Di,), "zeros"),
        "w_dt": ParamSpec((Di, Di), "normal", 1e-3),
        "b_dt": ParamSpec((Di,), "ones"),
        "w_bc": ParamSpec((Di, 2 * N)),
        "a_log": ParamSpec((Di, N), "zeros"),
        "d_skip": ParamSpec((Di,), "ones"),
        "w_out": ParamSpec((Di, D)),
    }


def hybrid_schema(cfg: ModelConfig) -> dict:
    """Hymba's block: attention and mamba heads side by side."""
    s = {f"attn_{k}": v for k, v in attn_schema(cfg).items() if k != "norm"}
    s.update({f"ssm_{k}": v for k, v in mamba_schema(cfg).items()
              if k != "norm"})
    s["norm"] = ParamSpec((cfg.d_model,), "ones")
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


_BLOCK_SCHEMAS = {"attn": attn_schema, "mamba": mamba_schema,
                  "mlstm": mlstm_schema, "slstm": slstm_schema,
                  "hybrid": hybrid_schema}


def block_schema(cfg: ModelConfig, block_type: str) -> dict:
    """One block's parameters; attn and hybrid blocks carry the FFN
    under ``ffn_``: the routed MoE when ``n_experts`` is set, else the
    SwiGLU or GELU MLP."""
    s = dict(_BLOCK_SCHEMAS[block_type](cfg))
    if block_type in ("attn", "hybrid") and cfg.mlp_type != "none":
        ffn = moe_schema(cfg) if cfg.n_experts else mlp_schema(cfg)
        s.update({f"ffn_{k}": v for k, v in ffn.items()})
    return s


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
            for k, s in block_schema(cfg, bt).items()}
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


def abstract_params(cfg: ModelConfig, dtype: torch.dtype | None = None
                    ) -> dict:
    """The parameter dict of :func:`model_schema` as ``meta`` tensors in
    ``dtype`` (default ``cfg.dtype``): shapes for the dry-run, nothing
    allocated (the reference's ``ShapeDtypeStruct`` tree)."""
    dtype = dtype or param_dtype(cfg)

    def walk(node):
        if isinstance(node, ParamSpec):
            return torch.empty(node.shape, dtype=dtype, device="meta")
        return {k: walk(v) for k, v in node.items()}

    return walk(model_schema(cfg))
