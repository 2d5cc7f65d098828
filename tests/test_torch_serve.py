"""The slice as a whole: reference weights -> the port's deployment and
serving engine, against the reference ``ServeEngine`` (CPU).

Bound on teacher-forced logits: |port - reference| <= 1e-4 * max|logit|
per step.  Both sides compute in f32 from the same weights, codes and
plans (pinned bit-identical below); what differs is summation order in
every projection (XLA's fused dot vs torch's matmul on the expanded W')
and in attention (one KV chunk vs the reference's chunked scan), plus
libm differences in exp/sin/cos/rsqrt.  Those are ~1e-7 relative per
op; two layers of them stay orders of magnitude below 1e-4, which is
tight enough that a wrong plan, code, position or mask shows at once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.deploy import PlanCache
from repro.distributed.sharding import ShardingCtx
from repro.models import model as jmodel
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.deploy import PlanCache as TPlanCache
from repro_torch.core.mdm import MODES
from repro_torch.serve import ServeEngine, sample_tokens

LOGIT_RTOL = 1e-4
MAX_SEQ = 32


def port_config(jcfg: JModel) -> ModelConfig:
    """The port's config with the reference config's field values."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


def ref_config(mode: str, spec=(16, 16, 4), d_model=32) -> JModel:
    return JModel(
        name="cim-serve-test", n_layers=2, d_model=d_model, n_heads=2,
        n_kv_heads=2, d_ff=2 * d_model, vocab_size=120,
        block_pattern=("attn",), remat="none", dtype="float32",
        attn_chunk=MAX_SEQ,
        cim=JCim(enabled=True, mode=mode, rows=spec[0], cols=spec[1],
                 n_bits=spec[2]))


def _engines(jcfg, tmp_path):
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = port_config(jcfg)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    jeng = JEngine(jcfg, jparams, max_seq=MAX_SEQ,
                   plan_cache=PlanCache(str(tmp_path)))
    teng = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ,
                       plan_cache=TPlanCache(str(tmp_path / "port")),
                       device="cpu")
    return jeng, teng


def _ref_teacher_forced(jeng, tokens, n_prompt):
    cfg, ctx = jeng.cfg, ShardingCtx()
    state = jmodel.init_decode_state(cfg, tokens.shape[0], jeng.max_seq)
    logits, state, _ = jmodel.apply_model(
        jeng.params, cfg, ctx, tokens=jnp.asarray(tokens[:, :n_prompt]),
        state=state, cim=jeng.cim)
    rows = [np.asarray(logits[:, -1])]
    for t in range(n_prompt, tokens.shape[1]):
        logits, state, _ = jmodel.apply_model(
            jeng.params, cfg, ctx, tokens=jnp.asarray(tokens[:, t:t + 1]),
            state=state, decode=True, cim=jeng.cim)
        rows.append(np.asarray(logits[:, 0]))
    return np.stack(rows, axis=1)


def _flips(a, b, logits):
    """(row, step, reference token, port token, reference top-2 gap)."""
    out = []
    for r, s in zip(*np.nonzero(a != b)):
        top = np.sort(logits[r, s])[-2:]
        out.append((int(r), int(s), int(a[r, s]), int(b[r, s]),
                    float(top[1] - top[0])))
    return out


@pytest.mark.parametrize("mode,spec,d_model", [
    ("baseline", (16, 16, 4), 32), ("reverse", (16, 16, 4), 32),
    ("sort", (16, 16, 4), 32), ("mdm", (16, 16, 4), 32),
    ("mdm", (64, 64, 8), 128),
])
def test_slice_matches_reference(mode, spec, d_model, tmp_path):
    jcfg = ref_config(mode, spec, d_model)
    jeng, teng = _engines(jcfg, tmp_path)

    # The deployment: stacked codes, positions and scales bit-identical.
    for pname, jdep in jeng.cim["slot0_attn"].items():
        tdep = teng.cim["slot0_attn"][pname]
        for f in ("codes", "pos", "scale"):
            np.testing.assert_array_equal(np.asarray(getattr(jdep, f)),
                                          getattr(tdep, f).numpy(),
                                          err_msg=f"{pname}.{f}")

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    n_new = 6
    j_tok = np.asarray(jeng.generate(jnp.asarray(prompts), n_new))
    t_tok = teng.generate(torch.from_numpy(prompts), n_new).numpy()

    seq = np.concatenate([prompts, j_tok[:, :-1]], axis=1)
    j_logits = _ref_teacher_forced(jeng, seq, prompts.shape[1])
    t_logits = teng.teacher_forced_logits(torch.from_numpy(seq),
                                          prompts.shape[1]).numpy()
    assert t_logits.shape == j_logits.shape
    V = jcfg.vocab_size          # padded columns sit at -1e9 (ulp 64)
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    assert err <= LOGIT_RTOL * np.abs(j_logits[..., :V]).max(), err
    assert (t_logits[..., V:] < -1e8).all()                  # pad mask

    flips = _flips(j_tok, t_tok, j_logits)
    assert flips == [], f"greedy flips (row, step, ref, port, gap): {flips}"


def test_clean_path_without_cim_matches_reference(tmp_path):
    jcfg = ref_config("mdm").replace(cim=JCim(enabled=False))
    jeng, teng = _engines(jcfg, tmp_path)
    assert teng.cim is None
    prompts = np.random.default_rng(2).integers(0, 120, (2, 8))
    seq = prompts.astype(np.int32)
    j_logits = _ref_teacher_forced(jeng, np.concatenate([seq, seq], 1), 8)
    t_logits = teng.teacher_forced_logits(
        torch.from_numpy(np.concatenate([seq, seq], 1)), 8).numpy()
    V = jcfg.vocab_size
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    assert err <= LOGIT_RTOL * np.abs(j_logits[..., :V]).max(), err


def test_sample_tokens():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=g)
    assert torch.equal(sample_tokens(logits),
                       logits.argmax(-1).to(torch.int32))
    a = sample_tokens(logits, 0.8, torch.Generator().manual_seed(3))
    b = sample_tokens(logits, 0.8, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert ((a >= 0) & (a < 50)).all()


def test_init_stddev_mirrors_stacked_reference_quirk():
    """The port's init std per leaf equals the reference's
    ParamSpec.stddev() on the stacked shapes, at full phi3-mini width."""
    from repro.configs.phi3_mini_38b import CONFIG as J_PHI3
    from repro.models.schema import ParamSpec as JSpec
    from repro.models.schema import model_schema as j_schema
    from repro_torch.configs.phi3_mini_38b import CONFIG
    from repro_torch.models.schema import ParamSpec, model_schema

    flat = lambda t: jax.tree_util.tree_leaves_with_path(
        t, is_leaf=lambda x: isinstance(x, (JSpec, ParamSpec)))
    j = {jax.tree_util.keystr(p): s for p, s in flat(j_schema(J_PHI3))}
    t = {jax.tree_util.keystr(p): s for p, s in flat(model_schema(CONFIG))}
    assert set(j) == set(t)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].init == j[k].init, k
        if t[k].init == "normal":
            assert t[k].stddev() == j[k].stddev(), k
    wq = t["['slot0_attn']['wq']"].stddev()
    assert abs(wq - 5.6e-4) < 1e-5                  # (32*3072*32)^-1/2
    assert t["['slot0_attn']['ffn_w_gate']"].stddev() == 32 ** -0.5


def test_init_params_draws_at_the_schema_std():
    from repro_torch.models.model import init_params

    cfg = port_config(ref_config("mdm", d_model=64))
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p["embed"].shape == (cfg.padded_vocab, 64)
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert abs(float(p["slot0_attn"]["ffn_w_up"].std()) - 2 ** -0.5) < 0.02
    assert (p["slot0_attn"]["norm"] == 1).all()


def test_params_from_numpy_rejects_mismatches():
    jcfg = ref_config("mdm")
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = port_config(jcfg)
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError):
        params_from_numpy(bad, tcfg, device="cpu")
    bad = dict(tree, slot0_attn={k: v for k, v in tree["slot0_attn"].items()
                                 if k != "wo"})
    with pytest.raises(ValueError):
        params_from_numpy(bad, tcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        ServeEngine(tcfg.replace(cim=CimConfig(enabled=True,
                                               mode="xchangr")),
                    params_from_numpy(tree, tcfg, device="cpu"),
                    device="cpu")
    assert set(MODES) == {"baseline", "reverse", "sort", "mdm"}
