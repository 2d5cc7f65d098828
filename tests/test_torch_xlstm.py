"""The xlstm-1.3b slice as a whole: reference weights -> the port's
deployment and serving engine, against the reference ``ServeEngine``
(CPU, a narrow xlstm with the published block pattern).

Bound on teacher-forced logits: |port - reference| <= 1e-4 * max|logit|
over all steps, the bound of the dense slice (tests/test_torch_serve.py).
Both sides compute in f32 from the same weights; what differs is
summation order in every projection, the mLSTM's chunk sums and the
sLSTM recurrence, and libm's exp/tanh/log-sigmoid: ~1e-6 of the scale
per mixer (tests/test_torch_recurrent.py), orders of magnitude below the
bound over four layers, which a wrong gate, decay, state or plan misses
at once.  Greedy tokens must agree; a flip is reported with its top-2
gap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.phi3_mini_38b import CONFIG as J_PHI3
from repro.configs.xlstm_13b import CONFIG as J_XLSTM
from repro.configs.xlstm_13b import SMOKE as J_XLSTM_SMOKE
from repro.deploy import PlanCache
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.distributed.sharding import ShardingCtx
from repro.models import model as jmodel
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import CimConfig, ModelConfig, check_supported
from repro_torch.configs.xlstm_13b import CONFIG as T_XLSTM
from repro_torch.convert import params_from_numpy
from repro_torch.deploy import PlanCache as TPlanCache
from repro_torch.deploy import collect_model_matrices
from repro_torch.models.model import init_decode_state, init_params
from repro_torch.serve import ServeEngine

LOGIT_RTOL = 1e-4
BF16_LOGIT_RTOL = 3e-2       # the bf16 bound of tests/test_torch_serve.py
PROMPT, NEW = 24, 6          # prompt longer than mlstm_chunk = 16


def port_config(jcfg) -> ModelConfig:
    """The port's config with the reference config's field values."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


def xlstm_config(mode="mdm", spec=(64, 64, 8), enabled=True):
    return J_XLSTM_SMOKE.replace(
        n_layers=4, mlstm_chunk=16, dtype="float32", remat="none",
        cim=JCim(enabled=enabled, mode=mode, rows=spec[0], cols=spec[1],
                 n_bits=spec[2]))


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


@pytest.mark.parametrize("mode,spec", [("mdm", (64, 64, 8)),
                                       ("reverse", (16, 16, 4))])
def test_xlstm_slice_matches_reference(mode, spec, tmp_path):
    assert _check_xlstm(xlstm_config(mode, spec), tmp_path, LOGIT_RTOL) == []


def test_xlstm_bf16_slice_matches_reference(tmp_path):
    """The reference's default dtype: bf16 parameters and activations,
    the sLSTM scan's bf16 form (gx and R bf16, the state f32), at the
    bf16 bound of the dense slice (tests/test_torch_serve.py).  One flip
    is known and listed: row 0, step 2, where the reference's bf16
    logits tie exactly (top-2 gap 0.0) and the two roundings pick
    different tokens."""
    flips = _check_xlstm(xlstm_config().replace(dtype="bfloat16"), tmp_path,
                         BF16_LOGIT_RTOL)
    assert [f[:2] for f in flips] == [(0, 2)], flips


def _check_xlstm(jcfg, tmp_path, rtol):
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = port_config(jcfg)
    jeng = JEngine(jcfg, jparams, max_seq=PROMPT + NEW,
                   plan_cache=PlanCache(str(tmp_path)))
    teng = ServeEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                       max_seq=PROMPT + NEW,
                       plan_cache=TPlanCache(str(tmp_path / "port")),
                       device="cpu")

    # Deploy: the same summary, skip reasons included, and the mLSTM
    # q/k/v deployments bit-identical.
    assert teng.deploy_report["matrices"] == jeng.deploy_report["matrices"]
    assert sorted(teng.cim["slot0_mlstm"]) == ["wk", "wq", "wv"]
    assert teng.cim["slot1_slstm"] == {}
    for pname, jdep in jeng.cim["slot0_mlstm"].items():
        tdep = teng.cim["slot0_mlstm"][pname]
        for f in ("codes", "pos", "scale"):
            np.testing.assert_array_equal(np.asarray(getattr(jdep, f)),
                                          getattr(tdep, f).numpy(),
                                          err_msg=f"{pname}.{f}")

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    j_tok = np.asarray(jeng.generate(jnp.asarray(prompts), NEW))
    t_tok = teng.generate(torch.from_numpy(prompts), NEW).numpy()

    seq = np.concatenate([prompts, j_tok[:, :-1]], axis=1)
    j_logits = _ref_teacher_forced(jeng, seq, PROMPT)
    t_logits = teng.teacher_forced_logits(torch.from_numpy(seq),
                                          PROMPT).numpy()
    assert t_logits.shape == j_logits.shape
    V = jcfg.vocab_size
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    bound = rtol * np.abs(j_logits[..., :V]).max()
    assert err <= bound, err

    # Greedy: the port's argmax under teacher forcing against the
    # reference's tokens (so one flip does not cascade).  Every flip is
    # listed; one passes only where the reference's top-2 gap lies
    # inside the logits' bound (a near-tie the two roundings split).
    # The generated tokens agree up to each row's first flip.
    flips = _flips(j_tok, t_logits.argmax(-1), j_logits)
    assert all(f[4] <= bound for f in flips), \
        f"greedy flips (row, step, ref, port, gap) beyond {bound}: {flips}"
    for r in range(j_tok.shape[0]):
        first = min([f[1] for f in flips if f[0] == r], default=NEW)
        np.testing.assert_array_equal(t_tok[r, :first], j_tok[r, :first])
    return flips


@pytest.mark.parametrize("name", ["phi3", "xlstm"])
def test_deploy_summary_matches_reference(name):
    """Deployed names and every skipped parameter's reason, as the
    reference records them (at narrow widths: the names do not depend
    on them)."""
    if name == "phi3":
        jcfg = J_PHI3.replace(n_layers=2, d_model=32, n_heads=2,
                              n_kv_heads=2, d_ff=64, vocab_size=128,
                              dtype="float32")
    else:
        jcfg = xlstm_config()
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = port_config(jcfg)
    _, want = j_collect(tree, jcfg)
    _, got = collect_model_matrices(
        params_from_numpy(tree, tcfg, device="cpu"), tcfg)
    assert got == want
    if name == "xlstm":
        assert got["skipped"]["slot1_slstm/r_gates"] == (
            "no crossbar mapping for this parameter")
        assert got["skipped"]["slot0_mlstm/norm"] == "norm/bias (digital)"


def test_xlstm_schema_and_state_mirror_reference():
    """Full-width xlstm-1.3b: the port's schema (shapes, init, std) and
    decode-state shapes equal the reference's."""
    from repro.models.schema import ParamSpec as JSpec
    from repro.models.schema import model_schema as j_schema
    from repro_torch.models.schema import ParamSpec, model_schema

    jcfg = J_XLSTM.replace(dtype="float32")
    tcfg = T_XLSTM.replace(dtype="float32")
    assert tcfg == port_config(jcfg)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(
        t, is_leaf=lambda x: isinstance(x, (JSpec, ParamSpec)))
    j = {jax.tree_util.keystr(p): s for p, s in flat(j_schema(jcfg))}
    t = {jax.tree_util.keystr(p): s for p, s in flat(model_schema(tcfg))}
    assert set(j) == set(t)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].init == j[k].init, k
        if t[k].init == "normal":
            assert t[k].stddev() == j[k].stddev(), k
    n = sum(int(np.prod(s.shape)) for s in t.values())
    assert n == 2_623_047_872
    # The stacked-init quirk: (R * Di * H)^-1/2 for the mLSTM q.
    assert t["['slot0_mlstm']['wq']"].stddev() == (24 * 4096 * 4) ** -0.5

    jstate = jmodel.init_decode_state(jcfg, 4, 8, abstract=True)
    tstate = init_decode_state(tcfg.replace(n_layers=2), 4, 8, "meta")
    for slot in ("slot0_mlstm", "slot1_slstm"):
        for k, v in tstate[slot].items():
            assert v.shape[1:] == jstate[slot][k].shape[1:], (slot, k)
            assert v.dtype == torch.float32
    assert tuple(tstate["slot0_mlstm"]["S"].shape) == (1, 4, 4, 1024, 1024)


def test_supported_patterns():
    check_supported(T_XLSTM)
    for bad in (T_XLSTM.replace(block_pattern=("mamba",), mlp_type="gelu"),
                T_XLSTM.replace(block_pattern=("hybrid",),
                                mlp_type="swiglu", n_experts=4,
                                n_experts_per_token=2),
                T_XLSTM.replace(mlp_type="swiglu"),
                ModelConfig(family="moe")):
        with pytest.raises(NotImplementedError):
            check_supported(bad)


def test_init_params_xlstm_draws_at_the_schema_std():
    cfg = port_config(xlstm_config())
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(p) == {"embed", "final_norm", "lm_head", "slot0_mlstm",
                      "slot1_slstm"}
    assert p["slot1_slstm"]["r_gates"].shape == (2, 2, 32, 128)
    assert abs(float(p["slot1_slstm"]["r_gates"].std()) - 0.02) < 2e-3
    assert (p["slot0_mlstm"]["b_if"] == 0).all()
