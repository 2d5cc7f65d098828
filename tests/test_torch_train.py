"""The port's training path against the reference's (CPU).

Bounds.  The loss, ``ce`` and ``aux`` of ``train_loss`` at rtol 1e-5,
and every gradient leaf within ``1e-4 * max|g_ref|`` of that leaf, both
in f32 (SMOKE configs, ``dtype="float32"``; the two packages sum in
different orders, and the worst leaf seen is hymba's at ~2e-5).  The
optimizer's pieces (``cosine_schedule``, ``global_norm``, AdamW's
moments and master) at rtol 1e-6 on the same inputs (bf16 params to
one bf16 rounding, 2^-8).  A whole step's metrics at rtol 1e-5, its
moments within ``1e-4 * max`` of the reference's and its params within
``lr / 100``: AdamW's normalised update can turn a gradient difference
near zero into up to +-lr, which these inputs do not meet (the largest
difference seen is 4e-7 at lr 1e-3).  Trainer losses at the reference's
own rtol 1e-5 (``tests/test_train.py:45``), for the port's trajectory
and against the reference's from its carried-across state; microbatches
at the reference's rtol 1e-4 and (rtol 1e-2, atol 1e-3) for params
(``tests/test_train.py:86-94``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import TrainConfig as JTrain
from repro.data import SyntheticTokenDataset as JData
from repro.distributed.sharding import ShardingCtx as JCtx
from repro.models import model as jmodel
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.adamw import global_norm as j_global_norm
from repro.optim.schedule import cosine_schedule as j_cosine
from repro.train import Trainer as JTrainer
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import ModelConfig, TrainConfig, get_config
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data import SyntheticTokenDataset
from repro_torch.models.model import init_params, train_loss
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import Trainer, Watchdog, make_train_step
from repro_torch.train.step import loss_and_grads

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4            # x max|g_ref| of the leaf
OPT_RTOL = 1e-6
B, S = 2, 32
PHI3 = "phi3-mini-3.8b"


def port_config(jcfg) -> ModelConfig:
    """The port's config with the reference config's field values."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)
                          if f.name != "cim"})


def smoke(arch: str, **kw):
    return j_get_config(arch, smoke=True).replace(dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, seed: int = 0):
    """(numpy params, numpy batch, loss, ce, aux, numpy grads) of the
    reference's ``jax.value_and_grad(train_loss)`` on a SMOKE config."""
    jcfg = smoke(arch, remat="none")
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    if jcfg.frontend:
        batch = {"embeds": rng.standard_normal(
                     (B, S, jcfg.d_model)).astype(np.float32),
                 "labels": rng.integers(-1, jcfg.vocab_size,
                                        (B, S)).astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                        (B, S + 1)).astype(np.int32)}
    fn = jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, jcfg, JCtx(), b), has_aux=True)
    (loss, m), grads = fn(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return (np_tree(params), batch, float(loss), float(m["ce"]),
            float(m["aux"]), [np.asarray(g) for g in
                              jax.tree_util.tree_leaves(grads)])


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_grads(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max() + 1e-30,
                                   err_msg=f"leaf {i}")


CASES = ([(PHI3, remat, chunk) for remat in ("full", "dots", "none")
          for chunk in (0, 8)]
         + [(arch, "full", 0) for arch in ("qwen2-moe-a2.7b", "xlstm-1.3b",
                                           "hymba-1.5b", "musicgen-medium")])


@pytest.mark.parametrize("arch,remat,chunk", CASES)
def test_loss_and_grads_match_reference(arch, remat, chunk):
    """train_loss and every gradient leaf against jax.value_and_grad of
    the reference's train_loss, on the same params and batch; values
    depend on neither remat nor loss_chunk.  qwen2-moe carries the aux
    loss, xlstm the sLSTM scan under autograd, hymba mamba and a window,
    musicgen the embeds + labels batch (some labels masked)."""
    params, batch, loss, ce, aux, grads = _reference(arch)
    cfg = port_config(smoke(arch, remat=remat, loss_chunk=chunk))
    tparams = params_from_numpy(params, cfg, device="cpu")
    got, metrics = loss_and_grads(tparams, cfg, _torch_batch(batch))
    for k, want in (("loss", loss), ("ce", ce), ("aux", aux)):
        np.testing.assert_allclose(float(metrics[k]), want, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    if arch == "qwen2-moe-a2.7b":
        assert aux > 0
    _check_grads(got, grads)


def test_train_loss_is_digital_and_checks_remat():
    cfg = port_config(smoke(PHI3))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.int32)}
    with pytest.raises(ValueError, match="digitally"):
        train_loss(params, cfg, batch, cim={})
    with pytest.raises(ValueError, match="remat"):
        loss_and_grads(params, cfg.replace(remat="most"), batch)


def test_config_fields_match_reference():
    for f in dataclasses.fields(TrainConfig):
        assert getattr(TrainConfig(), f.name) == getattr(JTrain(), f.name)
    assert {f.name for f in dataclasses.fields(TrainConfig)} == \
        {f.name for f in dataclasses.fields(JTrain)}
    cfg = get_config(PHI3)
    assert (cfg.remat, cfg.loss_chunk) == ("full", 0)


# ------------------------------- optimizer --------------------------------

@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (100, 1000),
                                          (10, 10)])
def test_cosine_schedule_matches_reference(warmup, total):
    for step in (0, 1, 2, 3, 5, 9, 10, 11, 500, 2000):
        kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
        want = float(j_cosine(jnp.asarray(step, jnp.int32), **kw))
        got = cosine_schedule(step, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=OPT_RTOL,
                                   err_msg=str(step))
    assert float(cosine_schedule(0, peak_lr=1.0, warmup_steps=2,
                                 total_steps=8)) == 0.0


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"b": {"w": (rng.standard_normal((5, 3)) * scale).astype(
                np.float32),
                  "a": (rng.standard_normal((4,)) * scale).astype(
                      np.float32)},
            "a": (rng.standard_normal((2, 2, 3)) * scale).astype(np.float32)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def test_global_norm_matches_reference():
    t = _tree(0, 3.0)
    want = float(j_global_norm(t))
    np.testing.assert_allclose(float(global_norm(_to_torch(t))), want,
                               rtol=OPT_RTOL)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    assert [tuple(x.shape) for x in tree_leaves(_to_torch(t))] == \
        [x.shape for x in leaves]


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(grad_scale, dtype):
    """Three updates on the same grads and state: params (in their
    dtype), moments, master, step, grad norm and clip (the clip active
    at grad_scale 10).  The port updates in place."""
    jdt = jnp.dtype(dtype)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), _tree(1))
    jstate = j_adamw_init(params)
    tparams = _to_torch(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), params))
    tparams = tree_map(lambda x: x.to(getattr(torch, dtype)), tparams)
    tstate = adamw_init(tparams)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.95, weight_decay=0.1,
              grad_clip=1.0)
    for i in range(3):
        grads = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt),
                                       _tree(10 + i, grad_scale))
        params, jstate, jm = j_adamw_update(grads, jstate, params, **kw)
        tg = tree_map(lambda x: x.to(getattr(torch, dtype)), _to_torch(
            jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                   grads)))
        before = [x.data_ptr() for x in tree_leaves(tparams)]
        tparams, tstate, tm = adamw_update(tg, tstate, tparams, **kw)
        assert [x.data_ptr() for x in tree_leaves(tparams)] == before
        assert int(tstate.step) == int(jstate.step) == i + 1
        for k in ("grad_norm", "clip"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=OPT_RTOL)
        if grad_scale > 1:
            assert float(tm["clip"]) < 1
        for name, got, want in (("m", tstate.m, jstate.m),
                                ("v", tstate.v, jstate.v),
                                ("master", tstate.master, jstate.master),
                                ("params", tparams, params)):
            for g, w in zip(tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                tol = OPT_RTOL if dtype == "float32" or name != "params" \
                    else 2 ** -8
                np.testing.assert_allclose(
                    g.to(torch.float32).numpy(), np.asarray(w, np.float32),
                    rtol=tol, atol=1e-12, err_msg=name)


def test_adamw_frees_a_list_of_grads():
    params = _to_torch(_tree(2))
    state = adamw_init(params)
    grads = [torch.ones_like(x) for x in tree_leaves(params)]
    adamw_update(grads, state, params, lr=1e-3)
    assert grads == []
    ef = adamw_init(params, use_error_feedback=True).ef_error
    assert all(not x.any() and x.dtype == torch.float32
               for x in tree_leaves(ef))


# --------------------------------- steps ----------------------------------

def _phi3_state(seed: int = 0):
    """SMOKE phi3 (f32) params from the reference's init, both packages'
    configs."""
    jcfg = smoke(PHI3)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, port_config(jcfg), jparams


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    """make_train_step against the reference's on the same params,
    optimizer state and batch, two steps: the metrics, the moments and
    the params (see the module docstring's bounds)."""
    jcfg, cfg, jparams = _phi3_state()
    kw = dict(microbatches=micro, learning_rate=1e-3, warmup_steps=0,
              total_steps=10)
    jstep = jax.jit(j_make_train_step(jcfg, JTrain(**kw), JCtx()))
    tstep = make_train_step(cfg, TrainConfig(**kw))
    jopt = j_adamw_init(jparams)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tparams = params_from_numpy(np_tree(jparams), cfg, device="cpu")
    topt = opt_state_from_numpy(np_tree(jopt), cfg, device="cpu")
    ds = JData(cfg.vocab_size, S, 4, seed=5)
    for step in range(2):
        toks = ds.batch_at(step)
        jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)})
        tparams, topt, tm = tstep(tparams, topt,
                                  {"tokens": torch.from_numpy(toks)})
        assert set(tm) == set(jm) == {"loss", "ce", "aux", "grad_norm",
                                      "clip", "lr"}
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        for name in ("m", "v"):
            for g, w in zip(tree_leaves(getattr(topt, name)),
                            jax.tree_util.tree_leaves(getattr(jopt, name))):
                w = np.asarray(w)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=0,
                    atol=GRAD_TOL * np.abs(w).max() + 1e-30, err_msg=name)
        for g, w in zip(tree_leaves(tparams),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=float(tm["lr"]) / 100 + 1e-7)


def test_trainer_matches_reference_from_carried_state(tmp_path):
    """Five Trainer steps of both packages from the reference's init
    carried across (params and optimizer state): the same losses."""
    jcfg, cfg, _ = _phi3_state()
    kw = dict(total_steps=5, checkpoint_every=100, log_every=1,
              learning_rate=1e-3, warmup_steps=2, async_checkpoint=False)
    jt = JTrainer(jcfg, JTrain(checkpoint_dir=str(tmp_path / "j"), **kw),
                  JData(cfg.vocab_size, S, 4, seed=3))
    jt.init_state()
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tt = Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path / "t"), **kw),
                 SyntheticTokenDataset(cfg.vocab_size, S, 4, seed=3),
                 device="cpu")
    tt.params = params_from_numpy(np_tree(jt.params), cfg, device="cpu")
    tt.opt_state = opt_state_from_numpy(np_tree(jt.opt_state), cfg,
                                        device="cpu")
    want = jt.run(5)
    got = tt.run(5)
    assert [m["step"] for m in got] == [m["step"] for m in want] == \
        [1, 2, 3, 4, 5]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=OPT_RTOL)


# --------------------------- trainer contracts ----------------------------
# The reference's own (tests/test_train.py), on the port.

def make_trainer(d, **kw):
    cfg = get_config(PHI3, smoke=True)
    tcfg = TrainConfig(**dict(dict(
        total_steps=10, checkpoint_every=4, checkpoint_dir=str(d),
        log_every=2, learning_rate=1e-3, async_checkpoint=False), **kw))
    ds = SyntheticTokenDataset(cfg.vocab_size, 32, 8, seed=3)
    return Trainer(cfg, tcfg, ds, device="cpu")


def test_restart_reproduces_trajectory(tmp_path):
    tr = make_trainer(tmp_path)
    tr.init_state()
    ref = {m["step"]: m["loss"] for m in tr.run(10)}
    tr2 = make_trainer(tmp_path)
    assert tr2.resume_or_init()
    assert tr2.step == 8
    log2 = tr2.run(10)
    assert [m["step"] for m in log2] == [10]
    for m in log2:
        np.testing.assert_allclose(m["loss"], ref[m["step"]], rtol=1e-5)


def test_injected_failure_recovery(tmp_path):
    """A mid-run failure recovers from the checkpoint and ends at the
    same loss as an uninterrupted run (asynchronous saves here)."""
    clean = make_trainer(tmp_path / "a", async_checkpoint=True)
    clean.init_state()
    ref = clean.run(10)
    faulty = make_trainer(tmp_path / "b", async_checkpoint=True)
    faulty.init_state()
    log = faulty.run(10, fail_at={6})
    assert log[-1]["step"] == 10
    np.testing.assert_allclose(log[-1]["loss"], ref[-1]["loss"], rtol=1e-5)
    with pytest.raises(RuntimeError, match="injected"):
        make_trainer(tmp_path / "c").run(3, fail_at={0}, max_retries=0)


def test_microbatch_grad_accumulation_equivalence():
    """microbatches=4 gives (numerically) the same update as one batch."""
    cfg = get_config(PHI3, smoke=True)
    ds = SyntheticTokenDataset(cfg.vocab_size, 32, 8, seed=5)
    batch = {"tokens": torch.from_numpy(ds.batch_at(0))}
    outs = {}
    for n in (1, 4):
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(cfg, TrainConfig(microbatches=n,
                                                learning_rate=1e-3))
        p2, _, metrics = step(params, adamw_init(params), batch)
        outs[n] = (p2, float(metrics["loss"]))
    np.testing.assert_allclose(outs[1][1], outs[4][1], rtol=1e-4)
    for x, y in zip(tree_leaves(outs[1][0]), tree_leaves(outs[4][0])):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=1e-2, atol=1e-3)


def test_loss_decreases(tmp_path):
    tr = make_trainer(tmp_path)
    tr.init_state()
    log = tr.run(10)
    assert log[-1]["loss"] < log[0]["loss"] + 0.05
    assert all(m["dt"] > 0 for m in log)


def test_watchdog_flags_stragglers():
    wd = Watchdog(threshold=2.0)
    assert not wd.observe(0, 1.0)
    assert not wd.observe(1, 1.1)
    assert wd.observe(2, 5.0)        # straggler
    assert wd.stragglers[0][0] == 2


def test_training_entry_points_default_to_the_card(tmp_path):
    """Without device="cpu" the trainer and the optimizer-state
    conversion refuse to run on a box with no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = get_config(PHI3, smoke=True)
    ds = SyntheticTokenDataset(cfg.vocab_size, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path)), ds)
    jcfg, _, jparams = _phi3_state()
    state = jax.tree_util.tree_map(np.asarray, j_adamw_init(jparams))
    with pytest.raises(RuntimeError, match="CUDA"):
        opt_state_from_numpy(state, port_config(jcfg))
