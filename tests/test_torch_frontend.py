"""The stub frontends and the GELU MLP: internvl2-76b (vision stub,
SwiGLU) and musicgen-medium (audio stub, GELU) at SMOKE width, reference
weights -> the port's deployment and serving engine, against the
reference (CPU).

Bounds.  The GELU MLP: rtol 1e-5, atol 1e-6 (both sides f32; tanh and
the matmuls' summation order differ by ~1e-7 relative).  Logits: 1e-4 *
max|logit| in f32 and 3e-2 in bf16, the bounds of
tests/test_torch_serve.py and for its reasons; plans, codes, positions
and scales bit-identical; greedy tokens equal, a flip listed with its
top-2 gap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs.base import CimConfig as JCim
from repro.deploy import PlanCache
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.distributed.sharding import ShardingCtx
from repro.models import model as jmodel
from repro.models.frontend import synthetic_embeddings as j_synthetic
from repro.serve import ServeEngine as JEngine
from repro.serve.continuous import ContinuousEngine as JContinuous
from repro_torch.configs import ARCHS, ModelConfig, check_supported, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.deploy import PlanCache as TPlanCache
from repro_torch.deploy import collect_model_matrices
from repro_torch.models.frontend import synthetic_embeddings
from repro_torch.models.model import apply_model, dense_mlp, init_params
from repro_torch.models.schema import model_schema
from repro_torch.serve import ContinuousEngine, ServeEngine
from test_torch_serve import _flips, port_config

LOGIT_RTOL = 1e-4
BF16_LOGIT_RTOL = 3e-2
B, PROMPT, NEW = 2, 8, 6
MAX_SEQ = 32
FRONTEND_ARCHS = ["internvl2-76b", "musicgen-medium"]


def frontend_config(arch, dtype="float32"):
    return j_get_config(arch, smoke=True).replace(
        dtype=dtype, remat="none", cim=JCim(enabled=True, mode="mdm"))


def _tree(jcfg):
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _engines(jcfg, tmp_path):
    jparams, tree = _tree(jcfg)
    tcfg = port_config(jcfg)
    jeng = JEngine(jcfg, jparams, max_seq=MAX_SEQ,
                   plan_cache=PlanCache(str(tmp_path)))
    teng = ServeEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                       max_seq=MAX_SEQ,
                       plan_cache=TPlanCache(str(tmp_path / "port")),
                       device="cpu")
    return jeng, teng


def _embeddings(d_model, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, PROMPT, d_model)).astype(np.float32)


def _ref_teacher_forced(jeng, embeds, tokens):
    cfg, ctx = jeng.cfg, ShardingCtx()
    state = jmodel.init_decode_state(cfg, embeds.shape[0], jeng.max_seq)
    logits, state, _ = jmodel.apply_model(
        jeng.params, cfg, ctx, embeds=jnp.asarray(embeds), state=state,
        cim=jeng.cim)
    rows = [np.asarray(logits[:, -1])]
    for t in range(tokens.shape[1]):
        logits, state, _ = jmodel.apply_model(
            jeng.params, cfg, ctx, tokens=jnp.asarray(tokens[:, t:t + 1]),
            state=state, decode=True, cim=jeng.cim)
        rows.append(np.asarray(logits[:, 0]))
    return np.stack(rows, axis=1)


# ------------------------------- configs ----------------------------------

def test_archs_equal_reference():
    assert list(ARCHS) == list(J_ARCHS)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_configs_match_reference(arch):
    for smoke in (False, True):
        t, j = get_config(arch, smoke), j_get_config(arch, smoke)
        check_supported(t)
        for f in dataclasses.fields(ModelConfig):
            if f.name != "cim":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert get_config(arch).frontend in ("vision", "audio")


def test_check_supported_names_what_it_refuses():
    for bad, what in ((ModelConfig(frontend="video"), "frontend"),
                      (ModelConfig(block_pattern=("hybrid",),
                                   frontend="audio"), "frontend"),
                      (ModelConfig(block_pattern=("hybrid",),
                                   mlp_type="gelu"), "mlp_type"),
                      (ModelConfig(mlp_type="relu"), "mlp_type")):
        with pytest.raises(NotImplementedError, match=what):
            check_supported(bad)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_schema_matches_reference(arch):
    """Names, shapes, inits and init std on the stacked shapes (the
    fan-in quirk) equal the reference's, at full width; ffn_w_gate only
    under SwiGLU."""
    from repro.models.schema import ParamSpec as JSpec
    from repro.models.schema import model_schema as j_schema
    from repro_torch.models.schema import ParamSpec

    flat = lambda t: jax.tree_util.tree_leaves_with_path(
        t, is_leaf=lambda x: isinstance(x, (JSpec, ParamSpec)))
    j = {jax.tree_util.keystr(p): s
         for p, s in flat(j_schema(j_get_config(arch)))}
    t = {jax.tree_util.keystr(p): s
         for p, s in flat(model_schema(get_config(arch)))}
    assert set(j) == set(t)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].init == j[k].init, k
        if t[k].init == "normal":
            assert t[k].stddev() == j[k].stddev(), k
    gate = "['slot0_attn']['ffn_w_gate']" in t
    assert gate == (get_config(arch).mlp_type == "swiglu")


# ------------------------------ the functions -----------------------------

def test_gelu_mlp_matches_reference_and_is_the_tanh_form():
    jcfg = frontend_config("musicgen-medium")
    rng = np.random.default_rng(0)
    D, F = jcfg.d_model, jcfg.d_ff
    p = {"ffn_w_up": rng.standard_normal((D, F)).astype(np.float32),
         "ffn_w_down": (rng.standard_normal((F, D)) / F ** 0.5).astype(
             np.float32)}
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    want = np.asarray(jmodel.dense_mlp(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        ShardingCtx()))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = dense_mlp(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    h = torch.from_numpy(x) @ tp["ffn_w_up"]
    erf = (torch.nn.functional.gelu(h) @ tp["ffn_w_down"]).numpy()
    assert not np.allclose(erf, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_apply_model_from_embeddings_matches_reference(arch):
    jcfg = frontend_config(arch).replace(cim=JCim())
    jparams, tree = _tree(jcfg)
    tcfg = port_config(jcfg)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    emb = _embeddings(jcfg.d_model)
    want, _, _ = jmodel.apply_model(jparams, jcfg, ShardingCtx(),
                                    embeds=jnp.asarray(emb))
    got, _ = apply_model(tparams, tcfg, embeds=torch.from_numpy(emb))
    V = jcfg.vocab_size
    want = np.asarray(want)[..., :V]
    assert np.abs(got.numpy()[..., :V] - want).max() <= (
        LOGIT_RTOL * np.abs(want).max())
    with pytest.raises(ValueError, match="exactly one"):
        apply_model(tparams, tcfg)
    with pytest.raises(ValueError, match="exactly one"):
        apply_model(tparams, tcfg, torch.zeros((1, 2), dtype=torch.int64),
                    embeds=torch.from_numpy(emb))


def test_synthetic_embeddings():
    cfg = get_config("musicgen-medium", smoke=True)
    a = synthetic_embeddings(cfg, 3, 64, torch.Generator().manual_seed(0))
    b = synthetic_embeddings(cfg, 3, 64, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.dtype == torch.bfloat16
    assert a.shape == (3, 64, cfg.d_model)
    x = a.float()
    assert abs(float(x.mean())) < 0.05 and abs(float(x.std()) - 1) < 0.05
    f32 = synthetic_embeddings(cfg, 1, 2, torch.Generator().manual_seed(0),
                               torch.float32)
    assert f32.dtype == torch.float32
    j = j_synthetic(j_get_config("musicgen-medium", smoke=True), 3, 64,
                    jax.random.PRNGKey(0))
    assert j.shape == a.shape and str(j.dtype) == "bfloat16"


# ------------------------------ the deploy --------------------------------

@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_deploy_summary_and_banks_match_reference(arch, tmp_path):
    """The collection's matrices, names and skip reasons equal the
    reference's; every deployment's codes, pos, scale and col_pos
    bit-identical."""
    jcfg = frontend_config(arch)
    _, tree = _tree(jcfg)
    tcfg = port_config(jcfg)
    j_mats, want = j_collect(tree, jcfg)
    t_mats, got = collect_model_matrices(
        params_from_numpy(tree, tcfg, device="cpu"), tcfg)
    assert got == want and list(t_mats) == list(j_mats)
    for k in j_mats:
        np.testing.assert_array_equal(t_mats[k].numpy(), j_mats[k])
    names = {k.split("/")[1] for k in got["deployed"]}
    mlp = {"ffn_w_up", "ffn_w_down"} | (
        {"ffn_w_gate"} if jcfg.mlp_type == "swiglu" else set())
    assert names == {"wq", "wk", "wv", "wo"} | mlp
    jeng, teng = _engines(jcfg, tmp_path)
    assert set(teng.cim["slot0_attn"]) == set(jeng.cim["slot0_attn"])
    for pname, jdep in jeng.cim["slot0_attn"].items():
        tdep = teng.cim["slot0_attn"][pname]
        for f in ("codes", "pos", "scale", "col_pos"):
            a, b = getattr(jdep, f), getattr(tdep, f)
            assert (a is None) == (b is None), f"{pname}.{f}"
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=f"{pname}.{f}")


# ------------------------------ the slice ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_slice_matches_reference(arch, dtype, tmp_path):
    """Embeddings prefill, then tokens: teacher-forced logits within
    the bound, greedy tokens equal to the reference's ServeEngine on the
    same embeddings."""
    rtol = LOGIT_RTOL if dtype == "float32" else BF16_LOGIT_RTOL
    jcfg = frontend_config(arch, dtype)
    jeng, teng = _engines(jcfg, tmp_path)
    emb = _embeddings(jcfg.d_model)
    j_tok = np.asarray(jeng.generate(jnp.asarray(emb), NEW))
    t_tok = teng.generate(torch.from_numpy(emb), NEW).numpy()
    follow = j_tok[:, :-1].copy()
    j_logits = _ref_teacher_forced(jeng, emb, follow)
    t_logits = teng.teacher_forced_logits(
        torch.from_numpy(emb), PROMPT,
        decode_tokens=torch.from_numpy(follow)).float().numpy()
    assert t_logits.shape == j_logits.shape == (B, NEW, jcfg.padded_vocab)
    V = jcfg.vocab_size
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    scale = np.abs(j_logits[..., :V]).max()
    assert err <= rtol * scale, (err, err / scale)
    flips = _flips(j_tok, t_tok, j_logits)
    assert flips == [], f"greedy flips (row, step, ref, port, gap): {flips}"


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_serve_engine_refuses_the_other_prompt_kind(arch, tmp_path):
    jcfg = frontend_config(arch)
    _, teng = _engines(jcfg, tmp_path)
    tokens = torch.zeros((B, PROMPT), dtype=torch.int64)
    emb = torch.from_numpy(_embeddings(jcfg.d_model))
    with pytest.raises(ValueError, match="embeddings"):
        teng.generate(tokens, 2)
    with pytest.raises(ValueError, match="embeddings"):
        teng.generate(emb[..., :-1], 2)
    with pytest.raises(ValueError, match="decode_tokens"):
        teng.teacher_forced_logits(emb, PROMPT)
    with pytest.raises(ValueError, match="decode_tokens"):
        teng.teacher_forced_logits(emb, PROMPT - 1, decode_tokens=tokens)
    plain = ServeEngine(teng.cfg.replace(frontend=""), teng.params,
                        max_seq=MAX_SEQ, plan_cache=False, device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        plain.generate(emb, 2)
    with pytest.raises(ValueError, match="decode_tokens"):
        plain.teacher_forced_logits(tokens, 4, decode_tokens=tokens)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_continuous_engine_refuses_a_frontend(arch):
    jcfg = frontend_config(arch)
    jparams, tree = _tree(jcfg)
    with pytest.raises(ValueError, match="token frontends"):
        JContinuous(jcfg, jparams, capacity=2, max_prompt=8, max_seq=16)
    tcfg = port_config(jcfg)
    with pytest.raises(ValueError, match="token frontends"):
        ContinuousEngine(tcfg, init_params(tcfg, torch.Generator(), "cpu"),
                         capacity=2, max_prompt=8, max_seq=16,
                         plan_cache=False, device="cpu")
