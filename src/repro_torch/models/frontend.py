"""Stub modality frontends of the [vlm] / [audio] archs.

Port of ``repro.models.frontend``.  The backbone is the served model;
the frontend (InternViT for internvl2-76b, EnCodec for musicgen-medium)
is a stub whose output, precomputed patch or frame embeddings of width
``d_model``, is the prompt (``ServeEngine.generate`` on a config with
``cfg.frontend``).  :func:`synthetic_embeddings` stands in for it;
:func:`embedding_spec` gives its shape alone, for the dry-run
(``launch/dryrun.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import param_dtype


def synthetic_embeddings(cfg: ModelConfig, batch: int, seq: int,
                         generator: torch.Generator,
                         dtype: torch.dtype | None = None) -> torch.Tensor:
    """Unit-variance (batch, seq, d_model) embeddings drawn in f32 from
    ``generator`` on its device, in ``dtype`` (default ``cfg.dtype``).
    The numbers differ from the reference's for the same seed."""
    x = torch.randn((batch, seq, cfg.d_model), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return x.to(dtype or param_dtype(cfg))


def embedding_spec(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype | None = None) -> torch.Tensor:
    """The frontend's (batch, seq, d_model) output as a ``meta`` tensor:
    a shape and dtype, nothing allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    return torch.empty((batch, seq, cfg.d_model),
                       dtype=dtype or param_dtype(cfg), device="meta")
