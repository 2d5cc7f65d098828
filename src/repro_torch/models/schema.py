"""Parameter schema of the served models: names, shapes, initialisation.

Port of the ``"attn"``, ``"mlstm"`` and ``"slstm"`` parts of
``repro.models.schema``.  Names and shapes map 1:1 onto the reference's
parameter tree: ``embed``, ``final_norm``, ``lm_head`` and one
``slot{i}_{block}`` dict per entry of the block pattern (for the dense
decoder ``slot0_attn/{norm, wq, wk, wv, wo, ffn_norm, ffn_w_gate,
ffn_w_up, ffn_w_down}``; for xLSTM ``slot0_mlstm`` and ``slot1_slstm``),
the block parameters stacked over the pattern repeats.

The init draws from an explicit ``torch.Generator`` (its numbers differ
from JAX's for the same seed; reference weights reach the port through
``repro_torch.convert``).  Its standard deviations mirror the
reference's ``ParamSpec.stddev()`` exactly as the reference applies it
to the *stacked* shapes: the repeat axis enters the fan-in, so ``wq``
(R, D, H, Dh) gets (R*D*H)^-1/2 and the 3-D ``ffn_w_*`` (R, D, F) get
R^-1/2 (so do the mLSTM ``wq``/``wk``/``wv`` and the sLSTM
``w_gates``).  That is a reference quirk, kept here on purpose.
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
    D, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh, F = cfg.resolved_head_dim, cfg.d_ff
    return {
        "norm": ParamSpec((D,), "ones"),
        "wq": ParamSpec((D, H, Dh)),
        "wk": ParamSpec((D, Hkv, Dh)),
        "wv": ParamSpec((D, Hkv, Dh)),
        "wo": ParamSpec((H, Dh, D)),
        "ffn_norm": ParamSpec((D,), "ones"),
        "ffn_w_up": ParamSpec((D, F)),
        "ffn_w_down": ParamSpec((F, D)),
        "ffn_w_gate": ParamSpec((D, F)),
    }


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
