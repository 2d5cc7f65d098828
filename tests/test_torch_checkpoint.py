"""Checkpoints both ways between the port and the reference (CPU).

Tolerances: none for the files.  Every leaf the reference's
``save_checkpoint`` wrote (f32, bf16, float8, int32) loads back
bit-identical; the port's ``save_checkpoint`` writes the reference's
bytes (every ``.npy`` and ``index.json``); serving from
``params_from_checkpoint`` gives the same deployment and tokens as
serving from ``params_from_numpy`` on the same weights.  A trainer
resumed from the other package's checkpoint holds the writer's state
bit for bit and takes its next step to the loss the writer's own next
step reaches: in f32 at the reference's rtol 1e-5
(``tests/test_train.py:45``), in bf16 at 1e-3 (the packages' bf16
forwards round differently: 2e-4 seen).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest_step
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint
from repro.configs import get_config as j_get_config
from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.configs.base import TrainConfig as JTrain
from repro.data import SyntheticTokenDataset as JData
from repro.models import model as jmodel
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    restore_into,
)
from repro_torch.checkpoint import save_checkpoint as t_save
from repro_torch.checkpoint.ckpt import leaf_items, parse_keystr
from repro_torch.configs import CimConfig, ModelConfig, TrainConfig
from repro_torch.convert import (
    opt_state_from_numpy,
    params_from_checkpoint,
    params_from_numpy,
)
from repro_torch.data import SyntheticTokenDataset
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_map
from repro_torch.train import Trainer
from repro_torch.deploy import PlanCache
from repro_torch.serve import ServeEngine

# torch dtype each reference dtype loads as.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2, "int32": torch.int32}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({2: np.uint16, 1: np.uint8, 4: np.uint32}[a.itemsize])


def _tree():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    return {"a": jnp.asarray(x),
            "b": {"w": jnp.asarray(x * 3, jnp.bfloat16),
                  "n": jnp.asarray(7, jnp.int32),
                  "f8": jnp.asarray(x, jnp.float8_e4m3fn),
                  "f8b": jnp.asarray(x / 4, jnp.float8_e5m2)},
            "slot0_attn": {"wq": jnp.asarray(x[None] * 0.5)}}


def test_leaves_load_bit_identical(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    save_checkpoint(str(tmp_path), 7, jax.tree_util.tree_map(
        lambda x: x + 1 if x.dtype == jnp.int32 else x, t))
    assert latest_step(str(tmp_path)) == j_latest_step(str(tmp_path)) == 7
    assert latest_step(str(tmp_path / "none")) is None
    for step, n in ((3, 7), (None, 8)):
        out = load_checkpoint(str(tmp_path), step, device="cpu")
        assert set(out) == {"a", "b", "slot0_attn"}
        assert set(out["b"]) == {"w", "n", "f8", "f8b"}
        assert int(out["b"]["n"]) == n
        for path, leaf in jax.tree_util.tree_leaves_with_path(t):
            keys = parse_keystr(jax.tree_util.keystr(path))
            got = out
            for k in keys:
                got = got[k]
            want = np.asarray(leaf)
            assert got.dtype == DTYPES[str(want.dtype)], keys
            assert tuple(got.shape) == want.shape, keys
            if keys == ["b", "n"]:
                continue
            int_view = {1: torch.uint8, 2: torch.int16,
                        4: torch.int32}[want.itemsize]
            np.testing.assert_array_equal(
                got.view(int_view).numpy().view(_bits(want).dtype),
                _bits(want), err_msg=str(keys))


def test_keystr_paths():
    assert parse_keystr("['slot0_attn']['wq']") == ["slot0_attn", "wq"]
    assert parse_keystr("['a'][0]['b']") == ["a", 0, "b"]
    assert parse_keystr('["x"]') == ["x"]
    # NamedTuple fields (an optimizer state's leaves), as keystr prints them
    assert parse_keystr("['opt'].m['embed']") == ["opt", "m", "embed"]
    assert parse_keystr("['opt'].step") == ["opt", "step"]
    assert parse_keystr(".attr") == ["attr"]
    for bad in ("", "['a']junk", "['a'].", "['a'].1b", "['a']..b", "[a]"):
        with pytest.raises(ValueError):
            parse_keystr(bad)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), device="cpu")


@pytest.mark.parametrize("wrap", [False, True])
def test_serving_from_a_checkpoint(wrap, tmp_path):
    """A reference checkpoint of phi3-shaped weights (saved bare, or
    under ``"params"`` as the trainer saves them) serves exactly as the
    same weights handed over as numpy."""
    jcfg = JModel(name="ckpt-test", n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=2, d_ff=64, vocab_size=128,
                  block_pattern=("attn",), remat="none", dtype="float32",
                  attn_chunk=32,
                  cim=JCim(enabled=True, mode="mdm", rows=16, cols=16,
                           n_bits=4))
    tcfg = ModelConfig(**{f: getattr(jcfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "block_pattern", "dtype", "attn_chunk")},
        cim=CimConfig(enabled=True, mode="mdm", rows=16, cols=16, n_bits=4))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    save_checkpoint(str(tmp_path / "ck"), 5,
                    {"params": jparams, "step": jnp.asarray(5)} if wrap
                    else jparams)
    a = params_from_checkpoint(str(tmp_path / "ck"), tcfg, device="cpu")
    b = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                          device="cpu")
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert torch.equal(leaf, flat_b[path]), path

    prompts = torch.from_numpy(
        np.random.default_rng(3).integers(0, 128, (2, 8)))
    outs = []
    for params, sub in ((a, "a"), (b, "b")):
        eng = ServeEngine(tcfg, params, max_seq=32,
                          plan_cache=PlanCache(str(tmp_path / sub)),
                          device="cpu")
        outs.append((eng, eng.generate(prompts, 6)))
    (ea, ta), (eb, tb) = outs
    assert torch.equal(ta, tb)
    for pname, d in ea.cim["slot0_attn"].items():
        for f in ("codes", "pos", "scale"):
            assert torch.equal(getattr(d, f),
                               getattr(eb.cim["slot0_attn"][pname], f))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    jcfg = JModel(name="ckpt-test", n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=2, d_ff=64, vocab_size=128,
                  block_pattern=("attn",), remat="none", dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    save_checkpoint(str(tmp_path), 1, jparams)
    tcfg = ModelConfig(name="ckpt-test", n_layers=2, d_model=32, n_heads=2,
                       n_kv_heads=2, d_ff=48, vocab_size=128,
                       dtype="float32")
    with pytest.raises(ValueError):
        params_from_checkpoint(str(tmp_path), tcfg, device="cpu")


# ------------------------------ write side --------------------------------

def _port_tree(t):
    """The port's copy of a reference tree (dicts and NamedTuples of
    jax arrays): torch tensors of the same dtypes and bits."""
    if isinstance(t, dict):
        return {k: _port_tree(v) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return tuple.__new__(type(t), [None if v is None else _port_tree(v)
                                       for v in t])
    a = np.asarray(t)
    want = DTYPES[str(a.dtype)]
    if a.dtype.itemsize == 4 or str(a.dtype) == "int32":
        return torch.from_numpy(a.copy())
    int_view = {1: torch.uint8, 2: torch.int16}[a.itemsize]
    return torch.from_numpy(_bits(a).copy()).view(int_view).view(want)


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), d)] = f.read()
    return out


def test_save_writes_the_reference_bytes(tmp_path):
    """The same tree (f32, bf16, float8, int32 leaves; dicts and an
    AdamWState with a None field) saved by both packages: the same files,
    byte for byte."""
    t = _tree()
    params = {"w": t["a"], "n": {"b": t["b"]["w"]}}
    tree = {"params": params, "opt": j_adamw_init(params),
            "extra": {"f8": t["b"]["f8"], "f8b": t["b"]["f8b"],
                      "n": t["b"]["n"]}}
    save_checkpoint(str(tmp_path / "j"), 4, tree)
    path = t_save(str(tmp_path / "t"), 4, _port_tree(tree))
    assert path.endswith("step_00000004")
    want, got = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_reads_a_reference_trainer_checkpoint(tmp_path):
    """A reference Trainer's checkpoint ({"params", "opt": AdamWState},
    leaves like ``['opt'].m['embed']``) loads in the port, every leaf
    bit for bit.  The port before this change refused its paths."""
    jcfg = j_get_config("phi3-mini-3.8b", smoke=True)
    jt = JTrainer(jcfg, JTrain(checkpoint_dir=str(tmp_path),
                               async_checkpoint=False),
                  JData(jcfg.vocab_size, 8, 2))
    jt.init_state()
    jt.save()
    tree = load_checkpoint(str(tmp_path), device="cpu")
    assert set(tree) == {"params", "opt"}
    assert set(tree["opt"]) == {"step", "m", "v", "master"}
    state = {"params": jt.params, "opt": jt.opt_state}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        got = tree
        for k in parse_keystr(jax.tree_util.keystr(path)):
            got = got[k]
        want = np.asarray(leaf)
        assert got.dtype == DTYPES[str(want.dtype)]
        int_view = {2: torch.int16, 4: torch.int32}[want.itemsize]
        np.testing.assert_array_equal(
            got.view(int_view).numpy().view(_bits(want).dtype), _bits(want))


def _trainers(tmp_path, dtype):
    """Both packages' trainers on SMOKE phi3 in ``dtype``, the port's
    state carried from the reference's init; checkpoints every 2 steps,
    into one directory each."""
    jcfg = j_get_config("phi3-mini-3.8b", smoke=True).replace(dtype=dtype)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)
                          if f.name != "cim"})
    kw = dict(total_steps=6, checkpoint_every=2, log_every=1,
              learning_rate=1e-3, warmup_steps=1, async_checkpoint=False)
    jt = JTrainer(jcfg, JTrain(checkpoint_dir=str(tmp_path / "j"), **kw),
                  JData(jcfg.vocab_size, 16, 4, seed=1))
    tt = Trainer(tcfg, TrainConfig(checkpoint_dir=str(tmp_path / "t"), **kw),
                 SyntheticTokenDataset(jcfg.vocab_size, 16, 4, seed=1),
                 device="cpu")
    jt.init_state()
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)
    tt.params = params_from_numpy(np_tree(jt.params), tcfg, device="cpu")
    tt.opt_state = opt_state_from_numpy(np_tree(jt.opt_state), tcfg,
                                        device="cpu")
    return jt, tt


# The next-step loss across packages: f32 at the reference's rtol; bf16
# at 1e-3, as the two packages' bf16 forwards round differently (XLA
# keeps fused bf16 elementwise chains in f32; 2e-4 seen), with the
# restored state itself held bit for bit.
NEXT_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _state_bits(jstate: dict, tstate: dict) -> None:
    """The reference's {"params", "opt"} state and the port's: the same
    leaves, bit for bit."""
    flat = jax.tree_util.tree_leaves_with_path(jstate)
    ours = dict(leaf_items(tstate))
    assert len(flat) == len(ours)
    for path, leaf in flat:
        want = np.asarray(leaf)
        got = ours[jax.tree_util.keystr(path)]
        int_view = {2: torch.int16, 4: torch.int32}[want.itemsize]
        np.testing.assert_array_equal(
            got.view(int_view).numpy().view(_bits(want).dtype), _bits(want))


def _snapshot(tt) -> dict:
    return {"params": tree_map(torch.clone, tt.params),
            "opt": tt.opt_state._replace(**{
                f: tree_map(torch.clone, getattr(tt.opt_state, f))
                for f in ("m", "v", "master")},
                step=tt.opt_state.step.clone())}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_resumes_in_reference_trainer(tmp_path, dtype):
    """The port's Trainer checkpoints at step 2; the reference's
    Trainer.resume_or_init restores it (step 2, the port's state bit for
    bit) and its next step's loss is the port's own step-3 loss."""
    jt, tt = _trainers(tmp_path, dtype)
    tt.run(2)
    at2 = _snapshot(tt)
    log = tt.run(3)
    jt = JTrainer(jt.cfg, dataclasses.replace(
        jt.tcfg, checkpoint_dir=str(tmp_path / "t")), jt.dataset)
    assert jt.resume_or_init() and jt.step == 2
    _state_bits({"params": jt.params, "opt": jt.opt_state}, at2)
    jlog = jt.run(3)
    assert jlog[-1]["step"] == log[-1]["step"] == 3
    np.testing.assert_allclose(jlog[-1]["loss"], log[-1]["loss"],
                               rtol=NEXT_LOSS_RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_resumes_in_port_trainer(tmp_path, dtype):
    """The reverse: the reference's Trainer checkpoints at step 2, the
    port's resumes there (its own init overwritten in place, the
    reference's state bit for bit) and its next step's loss is the
    reference's step-3 loss."""
    jt, tt = _trainers(tmp_path, dtype)
    jt.run(2)
    at2 = jax.tree_util.tree_map(np.array, {"params": jt.params,
                                            "opt": jt.opt_state})
    jlog = jt.run(3)
    fresh = Trainer(tt.cfg, dataclasses.replace(
        tt.tcfg, checkpoint_dir=str(tmp_path / "j")), tt.dataset,
        device="cpu")
    assert fresh.resume_or_init() and fresh.step == 2
    _state_bits(at2, fresh.state())
    log = fresh.run(3)
    assert log[-1]["step"] == 3
    np.testing.assert_allclose(log[-1]["loss"], jlog[-1]["loss"],
                               rtol=NEXT_LOSS_RTOL[dtype])


def test_roundtrip_bf16_bit_for_bit(tmp_path):
    params = {"a": torch.randn(3, 4, generator=torch.Generator()
                               .manual_seed(0)).to(torch.bfloat16),
              "b": {"c": torch.arange(5, dtype=torch.int32)}}
    state = {"params": params, "opt": adamw_init(params)}
    t_save(str(tmp_path), 7, state)
    out = load_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(out["params"]["a"].view(torch.int16),
                       params["a"].view(torch.int16))
    assert out["opt"]["step"].dtype == torch.int32
    target = {"params": {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
                         "b": {"c": torch.zeros(5, dtype=torch.int32)}},
              "opt": adamw_init(params)}
    restore_into(str(tmp_path), 7, target)
    assert torch.equal(target["params"]["a"].view(torch.int16),
                       params["a"].view(torch.int16))
    j = j_load_checkpoint(str(tmp_path), 7, {
        "params": {"a": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16),
                   "b": {"c": jax.ShapeDtypeStruct((5,), jnp.int32)}}})
    np.testing.assert_array_equal(
        _bits(np.asarray(j["params"]["a"])),
        params["a"].view(torch.int16).numpy().view(np.uint16))
    for bad in ({"params": {"zz": torch.zeros(1)}},
                {"params": {"a": torch.zeros(4, 3, dtype=torch.bfloat16)}},
                {"params": {"a": torch.zeros(3, 4)}}):
        with pytest.raises((KeyError, ValueError)):
            restore_into(str(tmp_path), 7, bad)


def test_manager_retention_async_and_atomic(tmp_path):
    """keep=2 of four async saves, no .tmp left; the snapshot is taken
    at save() (an in-place update right after does not reach the file);
    a failed background save re-raises at wait()."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    w = torch.zeros(4)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": w})
        w.add_(1)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    assert torch.equal(load_checkpoint(str(tmp_path), 4, "cpu")["w"],
                       torch.full((4,), 3.0))
    assert mgr.restore_latest({"w": w})[0] == 4 and float(w[0]) == 3.0
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(
        {"w": w}) == (None, None)
    (tmp_path / "file").write_text("")
    bad = CheckpointManager(str(tmp_path / "file"), async_save=True)
    bad.save(1, {"w": w})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                          # the error is handed over once
