"""Config system of the port: model and CIM deployment configs.

The port's own copy of ``repro.configs.base``: the field names and
defaults match the reference, so a reference config converts field by
field.  Only the fields the port's serving paths read are kept: the
``"attn"`` decoder (dense or MoE, with or without qkv bias) and the
xLSTM stack; the mamba / hybrid, frontend and sharding knobs arrive
with the slices that port those paths.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class CimConfig:
    """CIM deployment of matmuls onto memristive crossbars (the paper)."""

    enabled: bool = False
    # Mapping strategy: a named pipeline ("baseline" | "reverse" |
    # "sort" | "mdm" | "mdm_expert" | ...) or a spec string, resolved by
    # repro_torch.mapping.resolve_pipeline.
    mode: str = "mdm"
    eta: float = 2e-3            # PR noise coefficient (Eq 17)
    rows: int = 64
    cols: int = 64
    n_bits: int = 8
    r: float = 2.5
    r_on: float = 300e3
    r_off: float = 3e6


@dataclass(frozen=True)
class ModelConfig:
    """Decoder description (the reference's field names).

    ``block_pattern`` is the repeating unit of per-layer block types;
    n_layers must be a multiple of its length.  The port serves
    ``("attn",)`` with a SwiGLU MLP or, with ``n_experts``, a routed
    SwiGLU MoE (plus fused shared experts), and ``("mlstm", "slstm")``
    without an MLP (``mlp_type="none"``).
    """

    name: str = "model"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0            # 0 -> d_model // n_heads
    block_pattern: tuple = ("attn",)
    rope_theta: float = 1e4
    qkv_bias: bool = False
    sliding_window: int = 0      # 0 = global attention
    attn_chunk: int = 512        # KV chunk of the plain flash attention
    # MoE
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0            # routed-expert hidden width (0 -> d_ff)
    capacity_factor: float = 1.25
    # "global" sorts all B*S tokens into one capacity space; "grouped"
    # sorts each sequence on its own (models/moe.py).
    moe_dispatch: str = "global"
    mlp_type: str = "swiglu"
    norm_eps: float = 1e-5
    ssm_expand: int = 1          # mLSTM inner width = d_model * ssm_expand
    mlstm_chunk: int = 128       # mLSTM chunkwise length
    dtype: str = "bfloat16"
    cim: CimConfig = field(default_factory=CimConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_repeats(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not a "
                             f"multiple of pattern {self.block_pattern}")
        return self.n_layers // len(self.block_pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 128 multiple; padded logits are masked."""
        return ((self.vocab_size + 127) // 128) * 128

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# Block patterns the port serves, each with the MLP type it takes.
SUPPORTED_PATTERNS = {("attn",): "swiglu", ("mlstm", "slstm"): "none"}
MOE_DISPATCH = ("global", "grouped")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations outside the port's slices so far: the
    mamba and hybrid blocks, frontends and other MLP types are still to
    be ported."""
    pattern = tuple(cfg.block_pattern)
    if pattern not in SUPPORTED_PATTERNS:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r}, block_pattern="
            f"{cfg.block_pattern!r}: the port serves "
            f"{sorted(SUPPORTED_PATTERNS)} so far; mamba and hybrid "
            "blocks are still to be ported")
    if cfg.mlp_type != SUPPORTED_PATTERNS[pattern]:
        raise NotImplementedError(
            f"{cfg.name}: block_pattern={cfg.block_pattern!r} is served "
            f"with mlp_type={SUPPORTED_PATTERNS[pattern]!r} so far")
    moe = cfg.family == "moe" or cfg.n_experts
    if moe and (pattern != ("attn",) or cfg.n_experts < 1
                or not 1 <= cfg.n_experts_per_token <= cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name}: MoE is served on the ('attn',) pattern with "
            f"1 <= n_experts_per_token <= n_experts, not n_experts="
            f"{cfg.n_experts}, top-{cfg.n_experts_per_token} on "
            f"{cfg.block_pattern!r}")
    if moe and cfg.moe_dispatch not in MOE_DISPATCH:
        raise NotImplementedError(
            f"{cfg.name}: moe_dispatch={cfg.moe_dispatch!r} not in "
            f"{MOE_DISPATCH}")
    if cfg.qkv_bias and pattern != ("attn",):
        raise NotImplementedError(
            f"{cfg.name}: qkv bias is served on the ('attn',) pattern only")
