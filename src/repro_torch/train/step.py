"""The training step: loss -> grads -> AdamW, with gradient-accumulation
microbatching and cross-pod int8 error-feedback gradient compression.

Port of ``repro.train.step``.  The reference jits a pure function that
returns new trees; here a step runs eagerly under autograd and updates
the params and optimizer state in place (``optim/adamw.py``).  The loss
is the digital :func:`repro_torch.models.model.train_loss`, as the
reference trains.

Compression runs where the reference's does: ``grad_compression ==
"int8_ef"`` on a mesh with a "pod" axis.  The pods are processes here:
the axis must span every process of the default ``torch.distributed``
group, one pod each.  Pod p takes rows ``[p B/n, (p+1) B/n)`` of the
global batch (the reference's ``shard_map`` over the batch's leading
dim), the gradients are summed compressed and divided by n, and the
metrics averaged.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed.compression import psum_compressed
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.model import train_loss
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_update,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.schedule import cosine_schedule

F32 = torch.float32


def _split_micro(batch: dict, n: int) -> list[dict]:
    """The reference's row split: microbatch (or pod) i takes rows
    [i B/n, (i+1) B/n) of every batch entry."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows does not split into {n} "
                         f"microbatches")
    return [{k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
            for i in range(n)]


def loss_and_grads(params: dict, cfg: ModelConfig, batch: dict):
    """(grads, metrics) of one batch: the gradient of each leaf in
    ``tree_leaves(params)`` order (its dtype; zeros for a leaf the loss
    does not read), and loss, ce, aux."""
    with torch.enable_grad():
        req = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(req)
        loss, metrics = train_loss(req, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return grads, {"loss": loss.detach(), "ce": metrics["ce"].detach(),
                   "aux": metrics["aux"].detach()}


def _grads_of(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """(params, batch) -> (grads, metrics), with microbatch
    accumulation: the mean of the microbatches' grads (summed in f32)
    and losses, the ce and aux of the last microbatch."""
    if tcfg.microbatches <= 1:
        return lambda params, batch: loss_and_grads(params, cfg, batch)

    def accumulated(params, batch):
        acc, loss_sum = None, None
        for mb in _split_micro(batch, tcfg.microbatches):
            g, metrics = loss_and_grads(params, cfg, mb)
            if acc is None:
                acc = [x.to(F32, copy=True) for x in g]
                loss_sum = metrics["loss"]
            else:
                for a, x in zip(acc, g):
                    a.add_(x)
                loss_sum = loss_sum + metrics["loss"]
            del g
        inv = 1.0 / tcfg.microbatches
        for a in acc:
            a.mul_(inv)
        return acc, dict(metrics, loss=loss_sum * inv)

    return accumulated


def _pods(ctx: ShardingCtx | None) -> int:
    """The number of pods compressed over: 0 without a "pod" axis."""
    mesh = None if ctx is None else ctx.mesh
    if mesh is None or "pod" not in mesh.axis_names:
        return 0
    n = mesh.shape["pod"]
    if n != mesh.process_count:
        raise NotImplementedError(
            f"grad compression over a 'pod' axis of {n} needs one process a "
            f"pod; the mesh spans {mesh.process_count} process(es)")
    return n


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    ctx: ShardingCtx | None = None) -> Callable:
    """The (params, opt_state, batch) -> (params, opt_state, metrics)
    step.  ``params`` and the state's tensors are updated in place;
    metrics are f32 scalars: loss, ce, aux, grad_norm, clip, lr.
    ``batch`` holds tensors on the params' device."""
    grads_of = _grads_of(cfg, tcfg)
    pods = _pods(ctx) if tcfg.grad_compression == "int8_ef" else 0

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        if pods:
            import torch.distributed as dist

            local = _split_micro(batch, pods)[ctx.mesh.process_index]
            grads, metrics = grads_of(params, local)
            grads, new_ef = psum_compressed(
                [g.to(F32) for g in grads], tree_leaves(opt_state.ef_error))
            grads = [g / pods for g in grads]
            for e, x in zip(tree_leaves(opt_state.ef_error), new_ef):
                e.copy_(x)
            names = sorted(metrics)
            m = torch.stack([metrics[k] for k in names])
            dist.all_reduce(m)
            metrics = dict(zip(names, m / pods))
        else:
            grads, metrics = grads_of(params, batch)
        lr = cosine_schedule(opt_state.step, peak_lr=tcfg.learning_rate,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)
        params, opt_state, om = adamw_update(
            grads, opt_state, params, lr=lr, beta1=tcfg.beta1,
            beta2=tcfg.beta2, weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip)
        return params, opt_state, dict(metrics, **om, lr=lr)

    return train_step
