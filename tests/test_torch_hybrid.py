"""The mamba and hybrid blocks and the hymba-1.5b and dense slices:
reference weights -> the port's deployment and serving engine, against
the reference (CPU, SMOKE widths).

Bounds.  The mamba functions: max|port - reference| <= 1e-5 *
max|reference| per output, the mixer bound of
tests/test_torch_recurrent.py (both sides f32; the reference's
associative scan and the port's doubling scan sum in other orders).
Teacher-forced logits: 1e-4 * max|logit| in f32 and 3e-2 in bf16, the
bounds of tests/test_torch_serve.py; plans, codes and positions
bit-identical; greedy tokens equal, a flip listed with its top-2 gap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import CimConfig as JCim
from repro.deploy import PlanCache
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.distributed.sharding import ShardingCtx
from repro.models import model as jmodel
from repro.models import recurrent as jrec
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import ModelConfig, check_supported, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.deploy import PlanCache as TPlanCache
from repro_torch.deploy import collect_model_matrices
from repro_torch.models import recurrent as trec
from repro_torch.models.model import apply_model, init_decode_state
from repro_torch.serve import ContinuousEngine, ServeEngine
from test_torch_recurrent import _both, _close, _rand
from test_torch_serve import _check_slice, _flips, port_config

LOGIT_RTOL = 1e-4
BF16_LOGIT_RTOL = 3e-2
PROMPT, NEW = 24, 16         # positions up to 39: past the SMOKE window 32
MAX_SEQ = PROMPT + NEW


def hymba_config(dtype="float32", mode="mdm", **kw):
    return j_get_config("hymba-1.5b", smoke=True).replace(
        dtype=dtype, remat="none", cim=JCim(enabled=True, mode=mode), **kw)


def mamba_params(rng, D, Di, N, K, prefix=""):
    p = {"w_in": _rand(rng, D, 2 * Di, scale=D ** -0.5),
         "conv_w": _rand(rng, K, Di, scale=0.5),
         "conv_b": _rand(rng, Di, scale=0.1),
         "w_dt": _rand(rng, Di, Di, scale=0.1),
         "b_dt": _rand(rng, Di, scale=0.5),
         "w_bc": _rand(rng, Di, 2 * N, scale=Di ** -0.5),
         "a_log": _rand(rng, Di, N, scale=0.5),
         "d_skip": _rand(rng, Di),
         "w_out": _rand(rng, Di, D, scale=Di ** -0.5)}
    return {prefix + k: v for k, v in p.items()}


# ------------------------------ the mixer --------------------------------

@pytest.mark.parametrize("c", [1, 5, 64])
def test_mamba_chunk_scan_matches_reference(c):
    rng = np.random.default_rng(c)
    a = rng.uniform(0.0, 1.0, (2, c, 6, 3)).astype(np.float32)
    b, h0 = _rand(rng, 2, c, 6, 3), _rand(rng, 2, 6, 3)
    jh, jlast = jrec.mamba_chunk_scan(*map(jnp.asarray, (a, b, h0)))
    th, tlast = trec.mamba_chunk_scan(*map(torch.from_numpy, (a, b, h0)))
    _close(th.numpy(), jh)
    _close(tlast.numpy(), jlast)


@pytest.mark.parametrize("S,with_state,chunk,prefix", [
    (37, False, 16, ""),        # padded tail, zero state
    (37, True, 16, "ssm_"),     # carried state through three chunks
    (32, True, 16, ""),         # whole chunks
    (8, True, 16, "ssm_"),      # one partial chunk
    (70, True, 64, ""),         # the configs' chunk, padded
])
def test_mamba_mixer_matches_reference(S, with_state, chunk, prefix):
    rng = np.random.default_rng(S + chunk)
    D, Di, N, K = 32, 48, 4, 4
    p = mamba_params(rng, D, Di, N, K, prefix)
    x = _rand(rng, 2, S, D)
    st = ((_rand(rng, 2, K - 1, Di), _rand(rng, 2, Di, N, scale=0.5))
          if with_state else None)
    jp, tp, (jx, jst), (tx, tst) = _both(p, x, st)
    jy, jstate = jrec.mamba_mixer(jp, jx, jst, chunk=chunk, prefix=prefix)
    ty, tstate = trec.mamba_mixer(tp, tx, tst, chunk=chunk, prefix=prefix)
    for a, b in zip((ty,) + tstate, (jy,) + jstate):
        _close(a.numpy(), b)


@pytest.mark.parametrize("prefix", ["", "ssm_"])
def test_mamba_decode_matches_reference(prefix):
    rng = np.random.default_rng(7)
    D, Di, N, K = 32, 48, 4, 4
    p = mamba_params(rng, D, Di, N, K, prefix)
    x = _rand(rng, 3, 1, D)
    st = (_rand(rng, 3, K - 1, Di), _rand(rng, 3, Di, N, scale=0.5))
    jp, tp, (jx, jst), (tx, tst) = _both(p, x, st)
    jy, jstate = jrec.mamba_decode(jp, jx, jst, prefix=prefix)
    ty, tstate = trec.mamba_decode(tp, tx, tst, prefix=prefix)
    assert ty.shape == (3, 1, D)
    for a, b in zip((ty,) + tstate, (jy,) + jstate):
        _close(a.numpy(), b)


def test_mamba_decode_continues_the_mixer():
    """A prefill of S steps, then decode steps, equals the mixer over
    the whole sequence (the conv window and the state carried)."""
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v) for k, v in
         mamba_params(rng, 32, 48, 4, 4).items()}
    x = torch.from_numpy(_rand(rng, 2, 21, 32))
    want, _ = trec.mamba_mixer(p, x, None, chunk=8)
    y, st = trec.mamba_mixer(p, x[:, :17], None, chunk=8)
    ys = [y]
    for t in range(17, 21):
        y, st = trec.mamba_decode(p, x[:, t:t + 1], st)
        ys.append(y)
    _close(torch.cat(ys, 1).numpy(), want.numpy())


# ------------------------------ schema, deploy ---------------------------

def test_hymba_schema_and_state_mirror_reference():
    """Full-width hymba-1.5b: the port's config equals the reference's
    field by field, its schema (shapes, init, std: the stacked-init
    quirk) and decode state (shapes, dtypes) the reference's."""
    from repro.models.schema import ParamSpec as JSpec
    from repro.models.schema import model_schema as j_schema
    from repro_torch.models.schema import ParamSpec, model_schema

    jcfg = j_get_config("hymba-1.5b")
    tcfg = get_config("hymba-1.5b")
    assert tcfg == port_config(jcfg)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(
        t, is_leaf=lambda x: isinstance(x, (JSpec, ParamSpec)))
    j = {jax.tree_util.keystr(p): s for p, s in flat(j_schema(jcfg))}
    t = {jax.tree_util.keystr(p): s for p, s in flat(model_schema(tcfg))}
    assert list(t) == list(j)
    for k in j:
        assert (t[k].shape, t[k].init) == (j[k].shape, j[k].init), k
        if t[k].init == "normal":
            assert t[k].stddev() == j[k].stddev(), k
    slot = "['slot0_hybrid']"
    assert t[f"{slot}['ssm_conv_w']"].stddev() == 0.5
    assert t[f"{slot}['ssm_w_in']"].stddev() == 32 ** -0.5
    assert t[f"{slot}['ffn_w_gate']"].stddev() == 32 ** -0.5

    jstate = jmodel.init_decode_state(jcfg, 4, 1056, abstract=True)
    tstate = init_decode_state(tcfg, 4, 1056, "meta")
    assert set(tstate) == set(jstate)
    for k, v in tstate["slot0_hybrid"].items():
        w = jstate["slot0_hybrid"][k]
        assert tuple(v.shape) == w.shape, k
        assert str(v.dtype).split(".")[-1] == str(w.dtype), k
    assert tuple(tstate["slot0_hybrid"]["k"].shape) == (32, 4, 1024, 5, 64)
    assert tuple(tstate["slot0_hybrid"]["ssm"].shape) == (32, 4, 1600, 16)


@pytest.mark.parametrize("pattern", [("hybrid",), ("attn", "mamba")])
def test_deploy_summary_matches_reference(pattern):
    """Deployed names and every skipped parameter's reason: a hybrid
    slot deploys attn_wq/wk/wv/wo and ffn_w_*, its ssm_* parameters
    stay digital with the reference's reason."""
    jcfg = hymba_config(block_pattern=pattern)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = port_config(jcfg)
    _, want = j_collect(tree, jcfg)
    _, got = collect_model_matrices(
        params_from_numpy(tree, tcfg, device="cpu"), tcfg)
    assert got == want
    if pattern == ("hybrid",):
        names = {k.split("/")[1] for k in got["deployed"]}
        assert names == {"attn_wq", "attn_wk", "attn_wv", "attn_wo",
                         "ffn_w_gate", "ffn_w_up", "ffn_w_down"}
        assert got["skipped"]["slot0_hybrid/ssm_w_in"] == (
            "recurrent/SSM state path (digital)")


# ------------------------------ the slice --------------------------------

def _engines(jcfg, tmp_path, max_seq=MAX_SEQ):
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = port_config(jcfg)
    jeng = JEngine(jcfg, jparams, max_seq=max_seq,
                   plan_cache=PlanCache(str(tmp_path)))
    teng = ServeEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                       max_seq=max_seq,
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


def _check_hybrid(jcfg, tmp_path, rtol):
    """Deploy summary equal, every deployment's codes, pos, scale and
    col_pos bit-identical, teacher-forced logits within ``rtol *
    max|logit|`` over a decode that wraps the ring, greedy tokens.
    Returns the flips (row, step, reference, port, top-2 gap)."""
    jeng, teng = _engines(jcfg, tmp_path)
    assert teng.deploy_report["matrices"] == jeng.deploy_report["matrices"]
    for slot, deps in jeng.cim.items():
        assert sorted(teng.cim[slot]) == sorted(deps)
        for pname, jdep in deps.items():
            tdep = teng.cim[slot][pname]
            for f in ("codes", "pos", "scale", "col_pos"):
                a, b = getattr(jdep, f), getattr(tdep, f)
                assert (a is None) == (b is None), f"{pname}.{f}"
                if a is not None:
                    np.testing.assert_array_equal(
                        np.asarray(a), b.numpy(), err_msg=f"{pname}.{f}")

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    j_tok = np.asarray(jeng.generate(jnp.asarray(prompts), NEW))
    t_tok = teng.generate(torch.from_numpy(prompts), NEW).numpy()

    seq = np.concatenate([prompts, j_tok[:, :-1]], axis=1)
    j_logits = _ref_teacher_forced(jeng, seq, PROMPT)
    t_logits = teng.teacher_forced_logits(torch.from_numpy(seq),
                                          PROMPT).float().numpy()
    assert t_logits.shape == j_logits.shape
    V = jcfg.vocab_size
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    bound = rtol * np.abs(j_logits[..., :V]).max()
    assert err <= bound, (err, err / np.abs(j_logits[..., :V]).max())

    # The port's argmax under teacher forcing against the reference's
    # tokens, so one flip does not cascade; every flip is listed, and
    # the generated tokens agree up to each row's first flip.
    flips = _flips(j_tok, t_logits.argmax(-1), j_logits)
    assert all(f[4] <= bound for f in flips), flips
    for r in range(j_tok.shape[0]):
        first = min([f[1] for f in flips if f[0] == r], default=NEW)
        np.testing.assert_array_equal(t_tok[r, :first], j_tok[r, :first])
    return flips


@pytest.mark.parametrize("mode", ["mdm", "reverse"])
def test_hymba_slice_matches_reference(mode, tmp_path):
    assert _check_hybrid(hymba_config(mode=mode), tmp_path,
                         LOGIT_RTOL) == []


def test_hymba_bf16_slice_matches_reference(tmp_path):
    """The reference's default dtype: bf16 parameters, activations, KV
    cache and conv state (the scan in f32), at the bf16 bound."""
    assert _check_hybrid(hymba_config("bfloat16"), tmp_path,
                         BF16_LOGIT_RTOL) == []


def test_attn_mamba_pattern_matches_reference(tmp_path):
    """A pattern of an attn block and a mamba block (no FFN on the
    mamba block) through both engines."""
    assert _check_hybrid(hymba_config(block_pattern=("attn", "mamba")),
                         tmp_path, LOGIT_RTOL) == []


def test_decode_past_the_window_matches_full_forward(tmp_path):
    """Decoding past the window (the ring of 32 wraps at position 32)
    gives the logits of one stateless forward over the whole sequence,
    which attends every key inside the window."""
    _, teng = _engines(hymba_config(), tmp_path)
    cfg = teng.cfg
    seq = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, MAX_SEQ)))
    got = teng.teacher_forced_logits(seq, 8)
    full, _ = apply_model(teng.params, cfg, seq, cim=teng.cim)
    want = full[:, 7:]
    V = cfg.vocab_size
    err = (got - want)[..., :V].abs().max()
    assert err <= LOGIT_RTOL * want[..., :V].abs().max(), err


def test_long_prefill_caveat_on_both_packages(tmp_path):
    """A prefill longer than the ring (40 > 32) writes only its last 32
    keys before attending, in both packages (reference
    models/model.py:150-170), so its queries older than the oldest key
    kept lose keys inside their window: layer 0's attention gives 0 at
    queries 0-7 (no key left), differs from a stateless forward's up to
    query 38 and agrees at query 39; the port's model equals the
    reference's at every position."""
    from repro.models.model import attn_apply as j_attn
    from repro_torch.models.model import attn_apply as t_attn

    jeng, teng = _engines(hymba_config(), tmp_path)
    seq = np.random.default_rng(5).integers(
        0, jeng.cfg.vocab_size, (2, MAX_SEQ)).astype(np.int32)
    ctx, V = ShardingCtx(), jeng.cfg.vocab_size
    jstate = jmodel.init_decode_state(jeng.cfg, 2, MAX_SEQ)
    j_ring, _, _ = jmodel.apply_model(jeng.params, jeng.cfg, ctx,
                                      tokens=jnp.asarray(seq), state=jstate,
                                      cim=jeng.cim)
    tstate = init_decode_state(teng.cfg, 2, MAX_SEQ, "cpu")
    t_ring, _ = apply_model(teng.params, teng.cfg, torch.from_numpy(seq),
                            state=tstate, cim=teng.cim)
    j_ring = np.asarray(j_ring)[..., :V]
    assert np.abs(t_ring.numpy()[..., :V] - j_ring).max() <= (
        LOGIT_RTOL * np.abs(j_ring).max())

    x = _rand(np.random.default_rng(6), 2, MAX_SEQ, jeng.cfg.d_model)
    jp = {k: v[0] for k, v in jeng.params["slot0_hybrid"].items()}
    tp = {k: v[0] for k, v in teng.params["slot0_hybrid"].items()}
    pos = np.arange(MAX_SEQ, dtype=np.int32)
    j1 = lambda c: np.asarray(j_attn(jp, jnp.asarray(x), jeng.cfg, ctx,
                                     jnp.asarray(pos), c,
                                     prefix="attn_")[0])
    t1 = lambda c: t_attn(tp, torch.from_numpy(x), teng.cfg,
                          torch.from_numpy(pos), c, prefix="attn_").numpy()
    jc = {k: v[0] for k, v in jmodel.init_decode_state(
        jeng.cfg, 2, MAX_SEQ)["slot0_hybrid"].items() if k in ("k", "v",
                                                                "kpos")}
    tc = {k: v[0] for k, v in init_decode_state(
        teng.cfg, 2, MAX_SEQ, "cpu")["slot0_hybrid"].items()}
    for ring, full in ((j1(jc), j1(None)), (t1(tc), t1(None))):
        scale = np.abs(full).max()
        assert (ring[:, :8] == 0).all()
        lost = np.abs(ring - full).max(axis=(0, 2))
        assert (lost[:MAX_SEQ - 1] > 1e-3 * scale).all(), lost
        assert lost[-1] <= 1e-5 * scale, lost
    np.testing.assert_allclose(t1(tc), j1(jc), rtol=1e-5, atol=1e-6)


def test_continuous_engine_refuses_hymba():
    cfg = get_config("hymba-1.5b", smoke=True).replace(dtype="float32")
    from repro_torch.models.model import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="attn"):
        ContinuousEngine(cfg, params, capacity=2, max_prompt=8,
                         max_seq=16, plan_cache=False, device="cpu")


# ------------------------------ the dense configs ------------------------

@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "internlm2-20b",
                                  "qwen2.5-32b"])
def test_dense_smoke_configs_match_reference(arch, tmp_path):
    """Each config and its SMOKE equal the reference's field for field;
    the SMOKE slice through _check_slice (plans, codes and pos
    bit-identical, f32 logits within 1e-4, greedy tokens equal)."""
    for smoke in (False, True):
        t, j = get_config(arch, smoke), j_get_config(arch, smoke)
        check_supported(t)
        for f in dataclasses.fields(ModelConfig):
            if f.name != "cim":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
    jcfg = j_get_config(arch, smoke=True).replace(
        dtype="float32", remat="none", cim=JCim(enabled=True, mode="mdm"))
    _check_slice(jcfg, tmp_path)
