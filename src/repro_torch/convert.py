"""Reference parameters -> the port's parameters.

The reference's parameter pytree, as numpy arrays, is how weights reach
the port (no JAX PRNG stream is re-derived in torch).  The key layout
is the reference's, walked from the port's schema
(``repro_torch.models.schema.model_schema``): ``embed``, ``final_norm``,
``lm_head`` and one dict per pattern slot, for the dense decoder
``slot0_attn/{norm, wq (R, D, H, Dh), wk, wv, wo (R, H, Dh, D),
ffn_norm, ffn_w_gate, ffn_w_up, ffn_w_down}`` (with ``bq``, ``bk``,
``bv`` under ``qkv_bias``; an MoE decoder's FFN is ``ffn_{norm,
router (R, D, E), we_gate (R, E, D, F), we_up, we_down}`` and, with
shared experts, ``ffn_{ws_gate, ws_up, ws_down, shared_gate}``), for xLSTM
``slot0_mlstm/{norm, w_up, wq (R, Di, H, Dh), wk, wv, w_if, b_if,
w_down}`` and ``slot1_slstm/{norm, w_gates (R, D, H, 4Dh), r_gates
(R, H, Dh, 4Dh), b_gates, w_out}``.  A checkpoint the reference saved
(``repro.checkpoint.save_checkpoint``) loads the same way through
:func:`params_from_checkpoint`.

Health state crosses too: the reference's ``HealthConfig`` and
``DetectorConfig`` (:func:`health_config_from_reference`), and its
lifetime draws (:func:`take_reference_draws`): JAX's ``fold_in`` streams
cannot be reproduced in torch, so a parity test makes the port's
lifetimes read the reference's logical cell fields instead of drawing
their own.  So do Monte-Carlo cell samples
(:func:`cell_sample_from_reference`).  So does a trainer's optimizer
state (:func:`opt_state_from_numpy`), so that both packages' trainers
start from the same params and moments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.health import DetectorConfig, HealthConfig
from repro_torch.models.schema import ParamSpec, model_schema, param_dtype
from repro_torch.nonideal.models import CellSample
from repro_torch.optim.adamw import AdamWState


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> dict:
    """Copy a reference parameter tree of numpy arrays onto ``device``,
    in ``cfg.dtype``.

    Every leaf of the port's schema must be present with its shape;
    extra keys raise too, so nothing is dropped silently.  Leaves may
    also be tensors (any device and dtype).  A bf16 leaf of the
    reference (an ml_dtypes array, from ``np.asarray(jax_array)``)
    crosses as its uint16 bits, so no ``ml_dtypes`` import is needed.
    """
    return _schema_tree(tree, cfg, resolve_device(device), param_dtype(cfg))


def _schema_tree(tree: Mapping, cfg: ModelConfig, dev: torch.device,
                 dtype: torch.dtype) -> dict:
    """``tree`` checked against the port's schema, leaf by leaf on
    ``dev`` in ``dtype``."""
    def walk(spec, node, path):
        if isinstance(spec, ParamSpec):
            a = node if isinstance(node, torch.Tensor) else _tensor(node)
            if tuple(a.shape) != tuple(spec.shape):
                raise ValueError(f"{path}: shape {tuple(a.shape)} != "
                                 f"schema {spec.shape}")
            return a.to(device=dev, dtype=dtype)
        extra = set(node) - set(spec)
        missing = set(spec) - set(node)
        if extra or missing:
            raise ValueError(f"{path or 'params'}: missing {sorted(missing)}"
                             f", unexpected {sorted(extra)}")
        return {k: walk(spec[k], node[k], f"{path}/{k}".lstrip("/"))
                for k in spec}

    return walk(model_schema(cfg), tree, "")


def opt_state_from_numpy(state, cfg: ModelConfig,
                         device: str | torch.device = "cuda") -> AdamWState:
    """The reference's ``AdamWState`` with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, opt_state)``) as the port's on
    ``device``: step int32, m, v, master and ef_error (or None) f32,
    each tree checked against the schema as :func:`params_from_numpy`
    checks params."""
    dev = resolve_device(device)
    tree = lambda t: None if t is None else _schema_tree(
        t, cfg, dev, torch.float32)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step, tree(state.m), tree(state.v), tree(state.master),
                      tree(state.ef_error))


def _tensor(a) -> torch.Tensor:
    """A numpy array (bf16 of ml_dtypes included) as a CPU tensor copy."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_checkpoint(directory: str, cfg: ModelConfig,
                           step: int | None = None,
                           device: str | torch.device = "cuda") -> dict:
    """The parameters of a reference checkpoint (default: its latest
    step) on ``device`` in ``cfg.dtype``, with :func:`params_from_numpy`'s
    checks.  A trainer checkpoint keeps them under ``"params"``."""
    tree = load_checkpoint(directory, step, device=device)
    if "embed" not in tree and "params" in tree:
        tree = tree["params"]
    return params_from_numpy(tree, cfg, device=device)


def _fields(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def detector_config_from_reference(c) -> DetectorConfig:
    """The port's :class:`DetectorConfig` with the fields of the
    reference's ``c``."""
    return DetectorConfig(**_fields(DetectorConfig, c))


def health_config_from_reference(c) -> HealthConfig:
    """The port's :class:`HealthConfig` (its detector included) with the
    fields of the reference's ``c``."""
    kw = _fields(HealthConfig, c)
    kw["detector"] = detector_config_from_reference(c.detector)
    return HealthConfig(**kw)


def reference_draws(ref_lifetime, device="cuda") -> Callable[[int], tuple]:
    """A :class:`repro_torch.deploy.lifetime.MatrixLifetime` ``draws``
    hook that reads the reference's lifetime ``ref_lifetime`` live: for
    reprogram count n, its logical ``stuck_log``, ``gamma_log`` and
    ``relax_log`` (the deploy's captured cells, or the draws of its n-th
    reprogram) as tensors on ``device``.  The reference must have made
    its n-th reprogram first."""
    dev = resolve_device(device)

    def draws(n: int) -> tuple:
        if ref_lifetime.reprograms != n:
            raise ValueError(f"{ref_lifetime.name}: the reference has made "
                             f"{ref_lifetime.reprograms} reprograms, not {n}")
        return tuple(None if f is None else _tensor(f).to(dev) for f in (
            ref_lifetime.stuck_log, ref_lifetime.gamma_log,
            ref_lifetime.relax_log))

    return draws


def take_reference_draws(lifetimes: Mapping, ref_lifetimes: Mapping) -> None:
    """Make every port lifetime of ``lifetimes`` read its cells from the
    reference's lifetime of the same name (:func:`reference_draws`):
    ``slot/pname/r``, or ``slot/pname/r/e{k}`` for an expert, the
    reference's names for the same matrices."""
    for name, lt in lifetimes.items():
        lt.draws = reference_draws(ref_lifetimes[name], lt.dep.codes.device)


def cell_sample_from_reference(sample, device="cuda") -> CellSample:
    """The port's :class:`repro_torch.nonideal.models.CellSample` with
    the fields of a reference ``CellSample`` (arrays: stuck int8, gamma,
    read and relax f32, relax possibly None) on ``device``."""
    dev = resolve_device(device)
    return CellSample(*(None if f is None else _tensor(f).to(dev)
                        for f in sample))
