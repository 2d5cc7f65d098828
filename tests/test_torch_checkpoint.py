"""The port reads the reference's checkpoints (CPU).

Tolerances: none.  Every leaf the reference's ``save_checkpoint`` wrote
(f32, bf16, float8, int32) loads back bit-identical, and serving from
``params_from_checkpoint`` gives the same deployment and tokens as
serving from ``params_from_numpy`` on the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest_step
from repro.checkpoint import save_checkpoint
from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.models import model as jmodel
from repro_torch.checkpoint import latest_step, load_checkpoint
from repro_torch.checkpoint.ckpt import parse_keystr
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.convert import params_from_checkpoint, params_from_numpy
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
    for bad in ("", ".attr", "['a'].b", "['a']junk"):
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
