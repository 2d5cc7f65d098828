"""AdamW with f32 master weights.

Port of ``repro.optim.adamw``: f32 moments and master copy, params cast
back to their own dtype, decoupled weight decay, global-norm clipping,
``eps`` = 1e-8.  The reference builds new trees; here the state and the
params are updated in place, leaf by leaf, so that at most one leaf's
f32 temporaries are alive at once (a literal port would hold an f32 copy
of every gradient together: +15.3 GB at phi3-mini's width) and each
gradient is released once its leaf is done.

Trees are nested dicts of tensors, walked in the reference's leaf order
(``jax.tree_util.tree_leaves``: dict keys sorted).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates taken
    m: dict
    v: dict
    master: dict                # f32 master copy of params
    ef_error: dict | None       # error-feedback residual (grad compression)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, dict keys sorted at every level."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for k in sorted(tree) for t in tree_leaves(tree[k])]


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a nested dict; the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: tree_map(fn, v) for k, v in tree.items()}


def adamw_init(params: dict, use_error_feedback: bool = False) -> AdamWState:
    """Zero moments, an f32 master copy (a copy even of f32 params) and,
    for grad compression, a zero error-feedback residual."""
    zeros = lambda: tree_map(lambda x: torch.zeros_like(x, dtype=F32), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step, zeros(), zeros(),
                      tree_map(lambda x: x.to(F32, copy=True), params),
                      zeros() if use_error_feedback else None)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (in f32), summed in the
    reference's leaf order; a list of tensors is taken in its order."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    total = None
    for x in leaves:
        s = torch.sum(torch.square(x.to(F32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(grads, state: AdamWState, params: dict, *, lr,
                 beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step, in place: ``params`` and the state's tensors are
    updated and returned as (params, new_state, metrics).

    ``grads`` is a tree like ``params`` or a list of its leaves in
    :func:`tree_leaves` order; a list is emptied leaf by leaf as the
    update goes, so each gradient's memory is freed once used.  ``lr``
    is a float or an f32 scalar tensor."""
    if not isinstance(grads, list):
        grads = tree_leaves(grads)
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = step.to(F32)
    bc1 = 1 - beta1 ** t
    bc2 = 1 - beta2 ** t
    lr = torch.as_tensor(lr, dtype=F32, device=gnorm.device)
    leaves = zip(tree_leaves(params), tree_leaves(state.m),
                 tree_leaves(state.v), tree_leaves(state.master))
    for i, (p, mu, nu, w) in enumerate(leaves):
        # Two f32 temporaries of this leaf's size at most; each step is
        # the reference's expression in its rounding order.
        g = grads[i].to(F32, copy=True).mul_(clip)
        grads[i] = None
        tmp = g * (1 - beta1)
        mu.mul_(beta1).add_(tmp)
        torch.mul(g, 1 - beta2, out=tmp).mul_(g)
        nu.mul_(beta2).add_(tmp)
        del g
        torch.div(nu, bc2, out=tmp).sqrt_().add_(eps)
        upd = torch.div(mu, bc1).div_(tmp)
        torch.mul(w, weight_decay, out=tmp)
        w.sub_(upd.add_(tmp).mul_(lr))
        del tmp, upd
        p.copy_(w)
    grads.clear()
    new_state = AdamWState(step, state.m, state.v, state.master,
                           state.ef_error)
    return params, new_state, {"grad_norm": gnorm, "clip": clip}
