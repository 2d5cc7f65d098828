"""The slice as a whole: reference weights -> the port's deployment and
serving engine, against the reference ``ServeEngine`` (CPU).

Bound on teacher-forced logits in f32: |port - reference| <= 1e-4 *
max|logit| per step.  Both sides compute in f32 from the same weights, codes and
plans (pinned bit-identical below); what differs is summation order in
every projection (XLA's fused dot vs torch's matmul on the expanded W')
and in attention (one KV chunk vs the reference's chunked scan), plus
libm differences in exp/sin/cos/rsqrt.  Those are ~1e-7 relative per
op; two layers of them stay orders of magnitude below 1e-4, which is
tight enough that a wrong plan, code, position or mask shows at once.

In bf16 (``cfg.dtype="bfloat16"``, the reference's default) the bound is
3e-2 * max|logit|.  Both sides hold activations, weights and KV cache
in bf16 and accumulate in f32, but round to bf16 at other places: the
reference's jnp attention rounds scores and probabilities to bf16
where the port's attention works in f32 and rounds its output once,
and the two matmul libraries round their bf16 products differently.
bf16 keeps 8 significant bits (2^-8 = 3.9e-3 a rounding); measured
1.1e-2 and 1.2e-2 at d_model 128 and 32, against 7e-2 to 1e-1 between
the reference's own bf16 and f32 runs of the same model.  Greedy
tokens must still be equal.
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
BF16_LOGIT_RTOL = 3e-2
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


def _check_slice(jcfg, tmp_path, rtol=LOGIT_RTOL, n_new=6):
    """Deployment bit-identical (codes, pos, scale, col_pos), teacher-
    forced logits within ``rtol * max|logit|``, greedy tokens equal
    (a flip is reported with its top-2 gap).  Returns the worst logit
    error relative to max|logit|."""
    jeng, teng = _engines(jcfg, tmp_path)

    for pname, jdep in jeng.cim["slot0_attn"].items():
        tdep = teng.cim["slot0_attn"][pname]
        for f in ("codes", "pos", "scale", "col_pos"):
            a, b = getattr(jdep, f), getattr(tdep, f)
            assert (a is None) == (b is None), f"{pname}.{f}"
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=f"{pname}.{f}")

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    j_tok = np.asarray(jeng.generate(jnp.asarray(prompts), n_new))
    t_tok = teng.generate(torch.from_numpy(prompts), n_new).numpy()

    seq = np.concatenate([prompts, j_tok[:, :-1]], axis=1)
    j_logits = _ref_teacher_forced(jeng, seq, prompts.shape[1])
    t_logits = teng.teacher_forced_logits(torch.from_numpy(seq),
                                          prompts.shape[1]).float().numpy()
    assert t_logits.shape == j_logits.shape
    V = jcfg.vocab_size          # padded columns sit at -1e9 (ulp 64)
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    scale = np.abs(j_logits[..., :V]).max()
    assert err <= rtol * scale, (err, err / scale)
    assert (t_logits[..., V:] < -1e8).all()                  # pad mask

    flips = _flips(j_tok, t_tok, j_logits)
    assert flips == [], f"greedy flips (row, step, ref, port, gap): {flips}"
    return err / scale


@pytest.mark.parametrize("mode,spec,d_model", [
    ("baseline", (16, 16, 4), 32), ("reverse", (16, 16, 4), 32),
    ("sort", (16, 16, 4), 32), ("mdm", (16, 16, 4), 32),
    ("mdm", (64, 64, 8), 128),
])
def test_slice_matches_reference(mode, spec, d_model, tmp_path):
    _check_slice(ref_config(mode, spec, d_model), tmp_path)


@pytest.mark.parametrize("mode", ["fault_aware", "significance_weighted",
                                  "xchangr", "xchangr_fault_aware",
                                  "spare_line"])
def test_named_pipelines_serve_as_the_reference(mode, tmp_path):
    """The other named pipelines on ideal devices: the fault passes
    reduce to MDM rows, the column passes permute bitlines (col_pos
    bit-identical) and ``cim_mvm`` serves the permuted deployment."""
    _check_slice(ref_config(mode, (16, 64, 8), 64), tmp_path)


@pytest.mark.parametrize("spec,d_model", [((16, 16, 4), 32),
                                          ((64, 64, 8), 128)])
def test_bf16_slice_matches_reference(spec, d_model, tmp_path):
    """The reference's default dtype: bf16 params, activations and KV
    cache through the port's kernels' bf16 forms, against the
    reference's bf16 ServeEngine."""
    jcfg = ref_config("mdm", spec, d_model).replace(dtype="bfloat16")
    _check_slice(jcfg, tmp_path, rtol=BF16_LOGIT_RTOL)


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


def test_params_from_numpy_rejects_mismatches(tmp_path):
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
    # Once refused, the X-CHANGR pipeline now serves, as the reference.
    _check_slice(ref_config("xchangr"), tmp_path)
    assert set(MODES) == {"baseline", "reverse", "sort", "mdm"}
