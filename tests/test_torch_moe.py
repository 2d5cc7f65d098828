"""MoE serving: the port's ``models/moe.py``, ``ExpertPartition`` /
``mdm_expert``, expert-bank deployment and q/k/v biases, against the
reference on the CPU.

Inputs are made with numpy seeds; weights cross through
``repro_torch.convert``.  Bounds:

- plans, codes, ``pos`` and scales of every expert bank: bit-identical;
- ``moe_ffn`` / ``moe_ffn_grouped`` in f32: rtol 1e-5 + atol 1e-6 *
  max(1, max|y|) (the products' and the combine's summation orders
  differ: XLA's dot against torch's matmul on the expanded W'; ~1e-7
  relative to the terms summed, so an element that cancels terms of
  the output's size differs by ~1e-7 of that size, not of its own); the
  aux loss within 1e-6;
- teacher-forced logits in f32: 1e-4 * max|logit| (the bound of
  ``tests/test_torch_serve.py``), greedy tokens equal;
- bf16, call by call: one ``moe_ffn`` of the same bf16 inputs and
  weights within 3e-2 * max|y| (the bf16 bound of
  ``tests/test_torch_serve.py``) on every token whose top-K choice
  agrees; a token whose choice flips is listed with its top-K gap,
  which must lie within bf16's rounding of the router logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.configs.mixtral_8x7b import SMOKE as J_MIXTRAL
from repro.configs.qwen2_moe_a27b import SMOKE as J_QWEN
from repro.deploy import PlanCache as JPlanCache
from repro.deploy import collect_model_matrices as j_collect
from repro.deploy import deploy_model_params as j_deploy_params
from repro.deploy.planner import plan_matrices as j_plan_matrices
from repro.distributed.sharding import ShardingCtx
from repro.kernels.cim_mvm.ops import deploy as j_deploy
from repro.mapping import named_pipelines as j_named
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import ServeEngine as JServe
from repro_torch.configs import CimConfig, ModelConfig, check_supported
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.deploy import PlanCache
from repro_torch.deploy import collect_model_matrices, deploy_model_params
from repro_torch.deploy import plan_matrices, spec_from_config
from repro_torch.kernels.cim_mvm.ops import cim_mvm, cim_mvm_grouped, deploy
from repro_torch.kernels.cim_mvm.ref import cim_mvm_grouped_plain, cim_mvm_plain
from repro_torch.mapping import DensePartition, ExpertPartition
from repro_torch.mapping import resolve_pipeline
from repro_torch.models import moe
from repro_torch.models.model import PLAIN, attn_apply
from repro_torch.nonideal import NonidealModel
from repro_torch.serve import ContinuousEngine, ServeEngine

RTOL, ATOL = 1e-5, 1e-6
LOGIT_RTOL = 1e-4
BF16_RTOL = 3e-2
MAX_SEQ = 32
SPEC = (16, 16, 4)


def port_config(jcfg: JModel) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


def moe_config(n_shared=2, dispatch="global", cf=1.25, mode="mdm_expert",
               dtype="float32", spec=SPEC) -> JModel:
    return JModel(
        name="moe-port-test", family="moe", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=120,
        block_pattern=("attn",), remat="none", dtype=dtype, attn_chunk=32,
        qkv_bias=True, n_experts=4, n_experts_per_token=2,
        n_shared_experts=n_shared, moe_d_ff=48, capacity_factor=cf,
        moe_dispatch=dispatch,
        cim=JCim(enabled=True, mode=mode, rows=spec[0], cols=spec[1],
                 n_bits=spec[2]))


def smoke(jcfg: JModel, dtype="float32", spec=SPEC) -> JModel:
    """A SMOKE config in ``dtype`` on ``mdm_expert`` crossbars."""
    return jcfg.replace(dtype=dtype, remat="none", cim=JCim(
        enabled=True, mode="mdm_expert", rows=spec[0], cols=spec[1],
        n_bits=spec[2]))


def _params(jcfg: JModel, seed: int = 0, biases: bool = True):
    """(reference params, the port's copy on the CPU): the reference's
    init, with random q/k/v biases (its init leaves them zero, and a
    dropped bias would then pass)."""
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if biases and jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        slot = dict(tree["slot0_attn"])
        for b in ("bq", "bk", "bv"):
            slot[b] = (0.5 * rng.standard_normal(slot[b].shape)).astype(
                slot[b].dtype)
        tree = dict(tree, slot0_attn=slot)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, params_from_numpy(tree, port_config(jcfg), device="cpu")


def assert_close(got, want):
    """rtol 1e-5 + atol 1e-6 on the output's scale (module docstring)."""
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _layer(tree: dict, r: int) -> dict:
    return {k: v[r] for k, v in tree.items()}


def _jlayer(cim: dict, r: int) -> dict:
    return {k: jax.tree_util.tree_map(lambda a: a[r], d)
            for k, d in cim.items()}


# ------------------------------- configs ----------------------------------


def test_configs_and_support():
    for arch in ("qwen2-moe-a2.7b", "mixtral-8x7b", "phi3-mini-3.8b",
                 "xlstm-1.3b"):
        for smoke_ in (False, True):
            cfg = get_config(arch, smoke_)
            check_supported(cfg)
    q = get_config("qwen2-moe-a2.7b")
    assert (q.n_experts, q.n_experts_per_token, q.moe_d_ff, q.d_ff,
            q.qkv_bias) == (60, 4, 1408, 5632, True)
    for j, t in ((J_QWEN, get_config("qwen2-moe-a2.7b", True)),
                 (J_MIXTRAL, get_config("mixtral-8x7b", True))):
        for f in dataclasses.fields(ModelConfig):
            if f.name != "cim":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
    with pytest.raises(KeyError):
        get_config("hymba-1.5b")
    for bad in (ModelConfig(family="moe"),
                ModelConfig(n_experts=4, n_experts_per_token=5),
                ModelConfig(n_experts=4, n_experts_per_token=2,
                            moe_dispatch="nope"),
                ModelConfig(block_pattern=("mlstm", "slstm"),
                            mlp_type="none", qkv_bias=True)):
        with pytest.raises(NotImplementedError):
            check_supported(bad)


def test_schema_matches_reference():
    from repro.models.schema import ParamSpec as JSpec
    from repro.models.schema import model_schema as j_schema
    from repro_torch.models.schema import ParamSpec, model_schema

    for jcfg in (J_QWEN, J_MIXTRAL):
        flat = lambda t: jax.tree_util.tree_leaves_with_path(
            t, is_leaf=lambda x: isinstance(x, (JSpec, ParamSpec)))
        j = {jax.tree_util.keystr(p): s for p, s in flat(j_schema(jcfg))}
        t = {jax.tree_util.keystr(p): s
             for p, s in flat(model_schema(port_config(jcfg)))}
        assert set(j) == set(t)
        for k in j:
            assert t[k].shape == j[k].shape and t[k].init == j[k].init, k
            if t[k].init == "normal":
                assert t[k].stddev() == j[k].stddev(), k


# --------------------------- partition, pipeline --------------------------


def test_expert_partition_split_and_pipeline_identity():
    from repro.mapping import ExpertPartition as JExpert

    w = np.random.default_rng(0).standard_normal((3, 8, 5)).astype(np.float32)
    jparts = JExpert().split("s/ffn_we_up/0", w)
    tparts = ExpertPartition().split("s/ffn_we_up/0", torch.from_numpy(w))
    assert [n for n, _ in tparts] == [n for n, _ in jparts] \
        == ["s/ffn_we_up/0/e0", "s/ffn_we_up/0/e1", "s/ffn_we_up/0/e2"]
    for (_, a), (_, b) in zip(jparts, tparts):
        np.testing.assert_array_equal(a, b.numpy())
    m = torch.zeros(4, 6)
    assert ExpertPartition().split("m", m)[0][0] == "m"
    assert ExpertPartition().split("x", torch.zeros(2, 2, 2, 2)) is None
    assert DensePartition().split("w", torch.zeros(3, 8, 5)) is None
    jp, tp = j_named()["mdm_expert"], resolve_pipeline("mdm_expert")
    assert tp.fingerprint() == jp.fingerprint()
    assert "part=expert" in tp.fingerprint()
    assert tp.cache_token() == jp.cache_token() == "mdm"
    assert tp.spec() == jp.spec()


@pytest.mark.parametrize("mode", ["mdm", "mdm_expert"])
def test_collect_model_matrices_matches_reference(mode):
    """Names, order, values and skip reasons (the targets of the
    reference's collection-summary test)."""
    jcfg = moe_config(n_shared=0).replace(
        family="dense", cim=JCim(enabled=True, mode="mdm", rows=16,
                                 cols=16, n_bits=4))
    jp, tp = _params(jcfg)
    jmats, jsum = j_collect(jp, jcfg, j_named()[mode])
    tmats, tsum = collect_model_matrices(tp, port_config(jcfg), mode)
    assert list(tmats) == list(jmats)
    for name in jmats:
        np.testing.assert_array_equal(tmats[name].numpy(), jmats[name])
    assert tsum["skipped"] == jsum["skipped"]
    assert tsum["deployed"] == jsum["deployed"]
    E, reps = jcfg.n_experts, jcfg.pattern_repeats
    if mode == "mdm_expert":
        assert tsum["n_deployed"] == reps * (4 + 3 * E)
        assert "slot0_attn/ffn_we_gate/0/e0" in tmats
        assert tuple(tmats["slot0_attn/ffn_we_down/0/e1"].shape) == (48, 32)
        assert not any("ffn_we" in k for k in tsum["skipped"])
    else:
        assert any("expert" in v for v in tsum["skipped"].values())


@pytest.mark.parametrize("jsmoke", [J_QWEN, J_MIXTRAL],
                         ids=["qwen2-moe", "mixtral"])
def test_expert_plans_codes_and_pos_bit_identical(jsmoke):
    """Every matrix of both SMOKE configs under ``mdm_expert`` at the
    default 64x64x8 crossbar: plans, and the deployed codes, pos and
    scales stacked over (repeat, expert)."""
    jcfg = jsmoke.replace(dtype="float32", remat="none",
                          cim=JCim(enabled=True, mode="mdm_expert"))
    tcfg = port_config(jcfg)
    jp, tp = _params(jcfg)
    jmats, _ = j_collect(jp, jcfg)
    tmats, _ = collect_model_matrices(tp, tcfg)
    spec = spec_from_config(tcfg)
    jplans, _ = j_plan_matrices(jmats, spec_from_jax(jcfg), "mdm_expert")
    tplans, _ = plan_matrices(tmats, spec, "mdm_expert")
    assert list(tplans) == list(jplans)
    for name, jplan in jplans.items():
        for f in ("row_perm", "row_position", "nf_before", "nf_after",
                  "scale"):
            np.testing.assert_array_equal(
                getattr(tplans[name], f).numpy(),
                np.asarray(getattr(jplan, f)), err_msg=f"{name}.{f}")
    jcim, _ = j_deploy_params(jp, jcfg)
    tcim, rep = deploy_model_params(tp, tcfg, device="cpu")
    assert rep["matrices"]["n_deployed"] == len(jmats)
    E = jcfg.n_experts
    for pname, jdep in jcim["slot0_attn"].items():
        tdep = tcim["slot0_attn"][pname]
        if pname.startswith("ffn_we"):
            assert tuple(tdep.codes.shape[:2]) == (jcfg.n_layers, E)
            assert tuple(tdep.scale.shape) == (jcfg.n_layers, E)
        for f in ("codes", "pos", "scale"):
            np.testing.assert_array_equal(
                getattr(tdep, f).numpy(), np.asarray(getattr(jdep, f)),
                err_msg=f"{pname}.{f}")


def spec_from_jax(jcfg: JModel):
    from repro.deploy import spec_from_config as j_spec

    return j_spec(jcfg)


def test_expert_plan_cache_entries_read_both_ways(tmp_path):
    jcfg = smoke(J_QWEN)
    tcfg = port_config(jcfg)
    jp, tp = _params(jcfg)
    n = len(collect_model_matrices(tp, tcfg)[0])
    # The reference writes, the port reads ...
    j_deploy_params(jp, jcfg, cache=JPlanCache(str(tmp_path / "a")))
    _, rep = deploy_model_params(tp, tcfg, PlanCache(str(tmp_path / "a")),
                                 device="cpu")
    assert rep["cache_hits"] == n and rep["cache_misses"] == 0
    # ... and the other way round.
    deploy_model_params(tp, tcfg, PlanCache(str(tmp_path / "b")),
                        device="cpu")
    _, jrep = j_deploy_params(jp, jcfg, cache=JPlanCache(str(tmp_path / "b")))
    assert jrep["cache_hits"] == n and jrep["cache_misses"] == 0


def test_expert_banks_refuse_imperfect_devices():
    jcfg = smoke(J_QWEN)
    _, tp = _params(jcfg)
    with pytest.raises(NotImplementedError, match="later slice"):
        deploy_model_params(tp, port_config(jcfg), device="cpu",
                            nonideal=NonidealModel(p_stuck_off=0.01))
    with pytest.raises(NotImplementedError, match="later slice"):
        ServeEngine(port_config(jcfg), tp, max_seq=16, plan_cache=False,
                    nonideal=NonidealModel(sigma_read=0.01), device="cpu")


# ------------------------------ moe_ffn -----------------------------------


def _ffn_case(jcfg, seed=0, B=2, S=16, tie=False):
    """Layer 0's params on both sides, a (B, S, D) input from numpy, and
    both sides' layer-0 deployments (ffn banks under ``mdm_expert``)."""
    jp, tp = _params(jcfg, seed)
    if tie:
        # Experts 0, 2 and 3 route alike: top-K must take the lower
        # index first, as jax.lax.top_k does.
        tree = jax.tree_util.tree_map(np.asarray, jp)
        slot = dict(tree["slot0_attn"])
        r = slot["ffn_router"].copy()
        r[..., 2] = r[..., 0]
        r[..., 3] = r[..., 0]
        slot["ffn_router"] = r
        tree = dict(tree, slot0_attn=slot)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        tp = params_from_numpy(tree, port_config(jcfg), device="cpu")
    x = np.random.default_rng(seed + 7).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jp, tp, x


def _run_ffn(jcfg, jp, tp, x, deployed):
    tcfg = port_config(jcfg)
    jl, tl = _layer(jp["slot0_attn"], 0), _layer(tp["slot0_attn"], 0)
    jc = tc = None
    if deployed:
        jcim, _ = j_deploy_params(jp, jcfg)
        tcim, _ = deploy_model_params(tp, tcfg, device="cpu")
        jc, tc = _jlayer(jcim["slot0_attn"], 0), {
            k: d.layer(0) for k, d in tcim["slot0_attn"].items()}
    dt = jnp.dtype(jcfg.dtype)
    jy, jaux = jmoe.moe_ffn(jl, jnp.asarray(x, dt), jcfg, ShardingCtx(),
                            cim=jc)
    tx = torch.from_numpy(x).to(getattr(torch, jcfg.dtype))
    ty, taux = moe.moe_ffn(tl, tx, tcfg, PLAIN.grouped, cim=tc)
    return (np.asarray(jy, np.float32), float(jaux),
            ty.float().numpy(), float(taux))


@pytest.mark.parametrize("deployed", [False, True], ids=["digital", "cim"])
@pytest.mark.parametrize("dispatch,cf,B,S", [
    ("global", 1.25, 2, 16),
    ("global", 0.25, 2, 128),          # cap 128 < 512 assignments: drops
    ("grouped", 1.25, 2, 16),
    ("grouped", 0.25, 2, 16),          # per-group cap 8 < 32: drops
])
def test_moe_ffn_matches_reference(dispatch, cf, B, S, deployed):
    jcfg = moe_config(dispatch=dispatch, cf=cf)
    jp, tp, x = _ffn_case(jcfg, B=B, S=S)
    jy, jaux, ty, taux = _run_ffn(jcfg, jp, tp, x, deployed)
    assert_close(ty, jy)
    assert abs(taux - jaux) <= 1e-6
    if cf < 1:                          # the case does drop assignments
        tl = _layer(tp["slot0_attn"], 0)
        xt = torch.from_numpy(x).reshape(-1, jcfg.d_model)
        logits = xt @ tl["ffn_router"]
        _, _, idx = moe._route(logits, jcfg.n_experts_per_token)
        per = idx.reshape(B, -1) if dispatch == "grouped" else idx[None]
        counts = torch.stack([torch.bincount(p.reshape(-1), minlength=4)
                              for p in per])
        cap = 128 if dispatch == "global" else 8
        assert (counts > cap).any()


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_moe_ffn_ties_take_the_lower_expert(dispatch):
    jcfg = moe_config(dispatch=dispatch)
    jp, tp, x = _ffn_case(jcfg, tie=True)
    tl = _layer(tp["slot0_attn"], 0)
    xt = torch.from_numpy(x).reshape(-1, jcfg.d_model)
    probs, _, idx = moe._route((xt @ tl["ffn_router"]).float(), 2)
    tied = probs[:, 0] == probs[:, 2]
    assert tied.all()
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for deployed in (False, True):
        jy, jaux, ty, taux = _run_ffn(jcfg, jp, tp, x, deployed)
        assert_close(ty, jy)
        assert abs(taux - jaux) <= 1e-6


def test_moe_ffn_bf16_call_by_call():
    jcfg = moe_config(dtype="bfloat16")
    jp, tp, x = _ffn_case(jcfg, B=2, S=16)
    jy, _, ty, _ = _run_ffn(jcfg, jp, tp, x, deployed=True)
    # The routing both sides saw: the reference's bf16 router logits.
    tl = _layer(tp["slot0_attn"], 0)
    xb = torch.from_numpy(x).to(torch.bfloat16).reshape(-1, jcfg.d_model)
    tlog = (xb @ tl["ffn_router"]).float()
    jl = _layer(jp["slot0_attn"], 0)
    jlog = np.asarray((jnp.asarray(x, jnp.bfloat16).reshape(-1, 32)
                       @ jl["ffn_router"]).astype(jnp.float32))
    K = jcfg.n_experts_per_token
    tprobs, _, tidx = moe._route(tlog, K)
    jprobs, _, jidx = moe._route(torch.from_numpy(jlog), K)
    flips = []
    for t in torch.nonzero((tidx.sort(-1).values
                            != jidx.sort(-1).values).any(-1)).reshape(-1):
        p = jprobs[t].sort(descending=True).values
        flips.append((int(t), float(p[K - 1] - p[K])))
    # A flip needs a top-K gap inside bf16's rounding of the logits.
    assert all(g <= 2 ** -7 for _, g in flips), flips
    ok = np.ones(jy.shape[0] * jy.shape[1], bool)
    ok[[t for t, _ in flips]] = False
    jy2, ty2 = jy.reshape(-1, 32)[ok], ty.reshape(-1, 32)[ok]
    err = np.abs(ty2 - jy2).max()
    assert err <= BF16_RTOL * np.abs(jy2).max(), (err, flips)


def test_expert_mm_demotes_only_degraded_expert():
    """Mirror of the reference's test_expert_mm_demotes_only_degraded_
    expert: expert 0 degraded serves x @ w in f32, expert 1 its
    crossbars."""
    spec = CrossbarSpec(16, 16, 4)
    rng = np.random.default_rng(0)
    ws = [(0.2 * rng.standard_normal((32, 4))).astype(np.float32)
          for _ in range(2)]
    deps = []
    for e, we in enumerate(ws):
        d, _ = deploy(torch.from_numpy(we), spec, "mdm")
        deps.append(dataclasses.replace(
            d, degraded=torch.tensor(5 if e == 0 else 0, dtype=torch.int32)))
    stacked = dataclasses.replace(deps[0], **{
        f: torch.stack([getattr(d, f) for d in deps])
        for f in ("codes", "pos", "scale", "degraded")})
    xe = rng.standard_normal((2, 3, 32)).astype(np.float32)
    x = torch.from_numpy(xe.reshape(6, 32))
    e_s = torch.tensor([0, 0, 0, 1, 1, 1])
    r = torch.tensor([0, 1, 2, 0, 1, 2])
    disp = moe._dispatch(e_s, r, torch.ones(6, dtype=torch.bool),
                         torch.tensor([3, 3]), 3)
    w = torch.from_numpy(np.stack(ws))
    y = moe._expert_mm(x, w, stacked, disp, PLAIN.grouped)
    np.testing.assert_allclose(y[:3].numpy(), (x[:3] @ w[0]).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(y[3:].numpy(),
                               cim_mvm(x[3:], deps[1], device="cpu").numpy(),
                               rtol=1e-6)
    # The reference's own demotion on the same deployments.
    jdeps = []
    for e, we in enumerate(ws):
        d, _ = j_deploy(jnp.asarray(we), spec_jax(spec), "mdm")
        jdeps.append(dataclasses.replace(d, degraded=jnp.int32(
            5 if e == 0 else 0)))
    jdep = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jdeps)
    jy = np.asarray(jmoe._expert_mm(jnp.asarray(xe), jnp.asarray(w.numpy()),
                                    jdep, 0))
    assert_close(y.numpy(), jy.reshape(6, 4))


def spec_jax(spec: CrossbarSpec):
    from repro.core.tiling import CrossbarSpec as JSpec

    return JSpec(rows=spec.rows, cols=spec.cols, n_bits=spec.n_bits)


# ---------------------------- qkv biases -----------------------------------


@pytest.mark.parametrize("deployed", [False, True], ids=["digital", "cim"])
def test_attention_with_qkv_biases_matches_reference(deployed):
    jcfg = moe_config()
    jp, tp = _params(jcfg)
    jl, tl = _layer(jp["slot0_attn"], 0), _layer(tp["slot0_attn"], 0)
    assert float(np.abs(np.asarray(jl["bq"])).min()) > 0
    x = np.random.default_rng(3).standard_normal((2, 8, 32)).astype(
        np.float32)
    jc = tc = None
    if deployed:
        jcim, _ = j_deploy_params(jp, jcfg)
        tcim, _ = deploy_model_params(tp, port_config(jcfg), device="cpu")
        jc = _jlayer(jcim["slot0_attn"], 0)
        tc = {k: d.layer(0) for k, d in tcim["slot0_attn"].items()}
    pos = np.arange(8, dtype=np.int32)
    jy, _ = jmodel.attn_apply(jl, jnp.asarray(x), jcfg, ShardingCtx(),
                              jnp.asarray(pos), None, cim=jc)
    ty = attn_apply(tl, torch.from_numpy(x), port_config(jcfg),
                    torch.from_numpy(pos), None, cim=tc, ops=PLAIN)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    # The biases matter: without them the output moves.
    nob = dict(tl, bq=torch.zeros_like(tl["bq"]))
    ty0 = attn_apply(nob, torch.from_numpy(x), port_config(jcfg),
                     torch.from_numpy(pos), None, cim=tc, ops=PLAIN)
    assert float((ty0 - ty).abs().max()) > 1e-3


# ------------------------------ the slice ----------------------------------


def _ref_teacher_forced(jeng, tokens, n_prompt):
    cfg, ctx = jeng.cfg, ShardingCtx()
    state = jmodel.init_decode_state(cfg, tokens.shape[0], jeng.max_seq)
    logits, state, _ = jmodel.apply_model(
        jeng.params, cfg, ctx, tokens=jnp.asarray(tokens[:, :n_prompt]),
        state=state, cim=jeng.cim)
    rows = [np.asarray(logits[:, -1], np.float32)]
    for t in range(n_prompt, tokens.shape[1]):
        logits, state, _ = jmodel.apply_model(
            jeng.params, cfg, ctx, tokens=jnp.asarray(tokens[:, t:t + 1]),
            state=state, decode=True, cim=jeng.cim)
        rows.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(rows, axis=1)


@pytest.mark.parametrize("jsmoke,spec", [
    (J_QWEN, SPEC), (J_MIXTRAL, SPEC), (J_QWEN, (64, 64, 8))],
    ids=["qwen2-moe", "mixtral", "qwen2-moe-64x64x8"])
def test_moe_slice_matches_reference(jsmoke, spec, tmp_path):
    """Both SMOKE configs served through ``mdm_expert`` in f32: expert
    banks deployed bit-identically, teacher-forced logits within 1e-4 *
    max|logit|, greedy tokens equal."""
    jcfg = smoke(jsmoke, spec=spec)
    tcfg = port_config(jcfg)
    jp, tp = _params(jcfg)
    jeng = JServe(jcfg, jp, max_seq=MAX_SEQ,
                  plan_cache=JPlanCache(str(tmp_path / "ref")))
    teng = ServeEngine(tcfg, tp, max_seq=MAX_SEQ, plan_cache=PlanCache(
        str(tmp_path / "port")), device="cpu")
    assert teng.deploy_report["matrices"]["n_deployed"] == \
        jeng.deploy_report["matrices"]["n_deployed"]
    for pname, jdep in jeng.cim["slot0_attn"].items():
        for f in ("codes", "pos", "scale"):
            np.testing.assert_array_equal(
                getattr(teng.cim["slot0_attn"][pname], f).numpy(),
                np.asarray(getattr(jdep, f)), err_msg=f"{pname}.{f}")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    n_new = 6
    j_tok = np.asarray(jeng.generate(jnp.asarray(prompts), n_new))
    t_tok = teng.generate(torch.from_numpy(prompts), n_new).numpy()
    seq = np.concatenate([prompts, j_tok[:, :-1]], axis=1)
    j_logits = _ref_teacher_forced(jeng, seq, prompts.shape[1])
    t_logits = teng.teacher_forced_logits(torch.from_numpy(seq),
                                          prompts.shape[1]).numpy()
    V = jcfg.vocab_size
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    scale = np.abs(j_logits[..., :V]).max()
    assert err <= LOGIT_RTOL * scale, (err, err / scale)
    np.testing.assert_array_equal(t_tok, j_tok)


def test_moe_without_crossbars_matches_reference():
    jcfg = smoke(J_QWEN).replace(cim=JCim(enabled=False))
    tcfg = port_config(jcfg)
    jp, tp = _params(jcfg)
    jeng = JServe(jcfg, jp, max_seq=MAX_SEQ)
    teng = ServeEngine(tcfg, tp, max_seq=MAX_SEQ, device="cpu")
    assert teng.cim is None
    seq = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(np.int32)
    j_logits = _ref_teacher_forced(jeng, seq, 8)
    t_logits = teng.teacher_forced_logits(torch.from_numpy(seq), 8).numpy()
    V = jcfg.vocab_size
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    assert err <= LOGIT_RTOL * np.abs(j_logits[..., :V]).max(), err


def test_continuous_engine_greedy_on_qwen2_moe_smoke(tmp_path):
    """Capacity-2 continuous decode on qwen2-moe SMOKE == the port's and
    the reference's ServeEngine, and the reference's ContinuousEngine,
    token for token (no assignment is dropped at this size, so a token's
    experts do not depend on its batchmates)."""
    jcfg = smoke(J_QWEN)
    tcfg = port_config(jcfg)
    jp, tp = _params(jcfg)
    prompts = np.random.RandomState(5).randint(0, 256, (2, 8)).astype(
        np.int32)
    n = 6
    jcache = JPlanCache(str(tmp_path / "ref"))
    jserve = JServe(jcfg, jp, max_seq=64, plan_cache=jcache)
    jcont = JContinuous(jcfg, jp, capacity=2, max_seq=64, max_prompt=16,
                        plan_cache=jcache)
    tserve = ServeEngine(tcfg, tp, max_seq=64, plan_cache=PlanCache(
        str(tmp_path / "port")), device="cpu")
    tcont = ContinuousEngine(tcfg, tp, capacity=2, max_seq=64,
                             max_prompt=16, plan_cache=PlanCache(
                                 str(tmp_path / "port")), device="cpu")
    jrids = [jcont.submit(p, max_tokens=n) for p in prompts]
    trids = [tcont.submit(p, max_tokens=n) for p in prompts]
    jout, tout = jcont.run(), tcont.run()
    for i, p in enumerate(prompts):
        ref = list(np.asarray(jserve.generate(jnp.asarray(p[None]), n))[0])
        assert tserve.generate(torch.from_numpy(p[None]), n)[0].tolist() \
            == ref
        assert jout[jrids[i]] == ref
        assert tout[trids[i]] == ref, f"request {i}"


# ------------------------- the grouped cim_mvm form -------------------------


def _bank(E, I, N, spec, seed):
    deps = [deploy(torch.from_numpy(
        (0.3 * np.random.default_rng(seed + e).standard_normal((I, N)))
        .astype(np.float32)), spec, "mdm")[0] for e in range(E)]
    return deps, dataclasses.replace(deps[0], **{
        f: torch.stack([getattr(d, f) for d in deps])
        for f in ("codes", "pos", "scale")})


@pytest.mark.parametrize("counts,cap", [
    ([3, 0, 5, 1, 0], None),           # ragged, two experts empty
    ([0, 0, 4, 0, 0], None),
    ([6, 2, 0, 7, 1], 4),              # rows past cap dropped
    ([0, 0, 0, 0, 0], None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_plain_is_a_loop_of_cim_mvm_plain(counts, cap, dtype):
    spec = CrossbarSpec(16, 16, 4)
    deps, bank = _bank(5, 40, 24, spec, 0)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32)
    A = int(offsets[-1]) + 2                       # two rows no one owns
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (A, 40)).astype(np.float32)).to(dtype)
    y = cim_mvm_grouped_plain(x, bank, offsets, cap)
    want = torch.zeros(A, 24)
    for e, d in enumerate(deps):
        a = int(offsets[e])
        b = int(offsets[e + 1]) if cap is None else min(int(offsets[e + 1]),
                                                        a + cap)
        if b > a:
            want[a:b] = cim_mvm_plain(x[a:b], d)
    assert torch.equal(y, want)
    assert torch.equal(cim_mvm_grouped(x, bank, offsets, cap, device="cpu"),
                       want)


def test_grouped_form_refuses_what_it_cannot_read():
    spec = CrossbarSpec(16, 16, 4)
    _, bank = _bank(2, 16, 8, spec, 1)
    offsets = torch.tensor([0, 1, 2], dtype=torch.int32)
    x = torch.zeros(2, 16)
    with pytest.raises(NotImplementedError, match="folded grouped"):
        cim_mvm_grouped(x, dataclasses.replace(
            bank, gain=torch.ones_like(bank.codes, dtype=torch.float32)),
            offsets, device="cpu")
    with pytest.raises(ValueError):
        cim_mvm_grouped(x, bank, offsets.to(torch.int64), device="cpu")
    with pytest.raises(ValueError):
        cim_mvm_grouped(torch.zeros(2, 15), bank, offsets, device="cpu")
