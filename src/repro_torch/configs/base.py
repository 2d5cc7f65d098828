"""Config system of the port: model and CIM deployment configs.

The port's own copy of ``repro.configs.base``: the field names and
defaults match the reference, so a reference config converts field by
field.  Only the fields the port's paths read are kept: the ``"attn"``
decoder (dense or MoE, with or without qkv bias, SwiGLU or GELU MLP,
token or stub-frontend inputs), the mamba / hybrid blocks and the xLSTM
stack, the two knobs training reads (``remat``, ``loss_chunk``),
:class:`TrainConfig` and the dry-run's :class:`ShapeConfig` cells
(``SHAPES``); the reference's sharding and TPU-layout knobs are
not ported.
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
    n_layers must be a multiple of its length.  The port serves any
    pattern of ``"attn"``, ``"hybrid"`` (attention and mamba heads in
    one block) and ``"mamba"`` blocks with a SwiGLU MLP on the attn and
    hybrid blocks (on ``("attn",)`` also a GELU MLP or, with
    ``n_experts``, a routed SwiGLU MoE plus fused shared experts), and
    ``("mlstm", "slstm")`` without an MLP (``mlp_type="none"``).
    ``frontend`` ("vision" or "audio", on ``("attn",)``) marks a model
    whose prompts are precomputed (B, S, d_model) embeddings from a stub
    frontend (``repro_torch.models.frontend``); its decode steps feed
    tokens.
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
    frontend: str = ""           # "" | "vision" | "audio" (stub frontends)
    mlp_type: str = "swiglu"     # swiglu | gelu | none
    norm_eps: float = 1e-5
    ssm_state: int = 16          # mamba state width N
    ssm_conv: int = 4            # mamba causal conv width K
    ssm_expand: int = 1          # mamba / mLSTM inner width = d_model * this
    ssm_chunk: int = 64          # mamba chunked-scan length
    mlstm_chunk: int = 128       # mLSTM chunkwise length
    dtype: str = "bfloat16"
    remat: str = "full"          # full | dots | none (training only)
    loss_chunk: int = 0          # 0 = unchunked cross-entropy
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

    @property
    def is_recurrent_only(self) -> bool:
        return all(b in ("mamba", "mlstm", "slstm")
                   for b in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Decode state O(1) in context (recurrent) or windowed attention:
        the long_500k eligibility rule."""
        has_global_attn = any(b in ("attn", "hybrid")
                              for b in self.block_pattern)
        return (not has_global_attn) or self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the dry-run (the reference's)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule, data-parallel and checkpoint settings of a
    training run (the reference's fields and defaults)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1        # grad-accumulation factor
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    grad_compression: str = ""   # "" | "int8_ef" (cross-pod error-feedback)
    log_every: int = 10


# Block types the port serves with a SwiGLU MLP, and the xLSTM pattern.
SWIGLU_BLOCKS = ("attn", "hybrid", "mamba")
XLSTM_PATTERN = ("mlstm", "slstm")
MOE_DISPATCH = ("global", "grouped")
FRONTENDS = ("", "vision", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port does
    not serve, naming what it refuses.  Served: patterns of
    ``SWIGLU_BLOCKS`` with the SwiGLU MLP, ``("attn",)`` also with the
    GELU MLP, the routed MoE on ``("attn",)``, the xLSTM pattern with no
    MLP, and a stub frontend (``FRONTENDS``) on ``("attn",)``."""
    pattern = tuple(cfg.block_pattern)
    if pattern == XLSTM_PATTERN:
        want = ("none",)
    elif pattern == ("attn",):
        want = ("swiglu", "gelu")
    elif pattern and set(pattern) <= set(SWIGLU_BLOCKS):
        want = ("swiglu",)
    else:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r}, block_pattern="
            f"{cfg.block_pattern!r}: the port serves patterns of "
            f"{SWIGLU_BLOCKS} and {XLSTM_PATTERN}")
    if cfg.mlp_type not in want:
        raise NotImplementedError(
            f"{cfg.name}: mlp_type={cfg.mlp_type!r} on block_pattern="
            f"{cfg.block_pattern!r}: the port serves it with mlp_type in "
            f"{want}")
    if cfg.frontend not in FRONTENDS or (cfg.frontend
                                         and pattern != ("attn",)):
        raise NotImplementedError(
            f"{cfg.name}: frontend={cfg.frontend!r} on block_pattern="
            f"{cfg.block_pattern!r}: the port serves the stub frontends "
            f"{FRONTENDS[1:]} on the ('attn',) pattern")
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
    if cfg.qkv_bias and not {"attn", "hybrid"} & set(pattern):
        raise NotImplementedError(
            f"{cfg.name}: qkv bias needs an attention block")
