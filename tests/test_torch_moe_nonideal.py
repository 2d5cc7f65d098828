"""MoE on imperfect devices: expert banks deployed with stuck cells,
variation, drift, spare lines and read noise, against the reference on
the CPU.

JAX's PRNG streams cannot be reproduced in torch, so parity moves the
reference's sampled cells across (``deploy_model_params(cells=...)``,
as ``tests/test_torch_nonideal.py`` does) and holds the read noise to
statistics.  Bounds (those of ``tests/test_torch_nonideal.py`` and
``tests/test_torch_moe.py`` for the same functions):

* every expert's codes, ``pos``, ``col_pos``, ``degraded`` and
  ``noise_tag``: exact; its gain rtol 1e-6; the report's degraded
  matrices, their count and the stuck cells equal; each served expert's
  fold bit for bit against its plain version;
* ``moe_ffn`` / ``moe_ffn_grouped`` without read noise: rtol 1e-5 +
  atol 1e-6 * max(1, max|y|);
* the slice: teacher-forced logits within 1e-4 * max|logit|, greedy
  tokens equal (``ServeEngine`` and ``ContinuousEngine``);
* read noise: the per-row std of ``y_noisy - y_clean`` over 64 reads
  within 5% of ``sigma_read * agg * scale * ||x_r||`` for the port's
  grouped path and the reference's ``jax.vmap(cim_mvm)`` alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.configs.qwen2_moe_a27b import SMOKE as J_QWEN
from repro.core.tiling import CrossbarSpec as JSpec
from repro.deploy import deploy_model_params as j_deploy_params
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.distributed.sharding import ShardingCtx
from repro.kernels.cim_mvm.ops import deploy as j_deploy
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.nonideal import models as jni
from repro.nonideal.inject import sample_deployment_cells as j_sample_cells
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import ServeEngine as JServe
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.deploy import PlanCache, deploy_model_params
from repro_torch.kernels.cim_mvm import ops
from repro_torch.kernels.cim_mvm.ops import cim_mvm_grouped, deploy
from repro_torch.kernels.cim_mvm.ref import folded_weights
from repro_torch.models import moe
from repro_torch.models.model import PLAIN
from repro_torch.nonideal import NonidealModel
from repro_torch.serve import ContinuousEngine, ServeEngine

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
LOGIT_RTOL = 1e-4
MAX_SEQ = 32
SPEC = (16, 16, 4)
SPARE = "part=expert,row=spare_line,col=spare_line"
# Every device term of the reference's NonidealModel; line opens at a
# rate that demotes some experts and spares others (asserted).
DEVICES = dict(p_stuck_off=0.02, p_stuck_on=0.005, sigma_program=0.05,
               sigma_corr=0.05, drift_nu=0.05, drift_time=10.0,
               sigma_relax=0.05, p_open_wordline=0.002,
               p_open_bitline=0.002)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's CPU ops on one intra-op thread, as in
    tests/test_torch_nonideal.py (a multi-threaded torch op beside
    jaxlib was seen to leave part of its output unwritten)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jcfg: JModel) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


def moe_config(dispatch="global") -> JModel:
    """tests/test_torch_moe.py's narrow MoE: 2 layers, 4 experts top-2."""
    return JModel(
        name="moe-port-test", family="moe", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=120,
        block_pattern=("attn",), remat="none", dtype="float32",
        attn_chunk=32, qkv_bias=True, n_experts=4, n_experts_per_token=2,
        n_shared_experts=2, moe_d_ff=48, capacity_factor=1.25,
        moe_dispatch=dispatch,
        cim=JCim(enabled=True, mode="mdm_expert", rows=SPEC[0],
                 cols=SPEC[1], n_bits=SPEC[2]))


def qwen_smoke() -> JModel:
    return J_QWEN.replace(dtype="float32", remat="none", cim=JCim(
        enabled=True, mode="mdm_expert", rows=SPEC[0], cols=SPEC[1],
        n_bits=SPEC[2]))


CONFIGS = {"qwen2-moe": qwen_smoke, "moe": moe_config}


def _params(jcfg: JModel):
    """The reference's init (seed 0), its numpy tree and the port's copy."""
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tree, params_from_numpy(tree, port_config(jcfg), CPU)


def _reference_cells(tree, jcfg, jm, pipeline, key=0):
    """The cells the reference's deploy draws (its own call, its key)."""
    mats, _ = j_collect(tree, jcfg, pipeline)
    spec = JSpec(jcfg.cim.rows, jcfg.cim.cols, jcfg.cim.n_bits,
                 jcfg.cim.r, jcfg.cim.r_on, jcfg.cim.r_off)
    grids = {name: spec.grid(*w.shape) for name, w in mats.items()}
    return j_sample_cells(jax.random.PRNGKey(key), grids, spec, jm)


def _deploy_both(jcfg, kw, pipeline, fault_aware=True):
    """Both sides' deploys of one config onto the same devices: the
    reference's own draw and the port fed those cells."""
    jm, tm = jni.NonidealModel(**kw), NonidealModel(**kw)
    jp, tree, tp = _params(jcfg)
    jcim, jrep = j_deploy_params(jp, jcfg, nonideal=jm, nonideal_key=0,
                                 fault_aware=fault_aware, pipeline=pipeline)
    tcim, trep = deploy_model_params(
        tp, port_config(jcfg), device=CPU, nonideal=tm,
        fault_aware=fault_aware, pipeline=pipeline,
        cells=_reference_cells(tree, jcfg, jm, pipeline))
    return jp, tp, jcim, jrep, tcim, trep


def _layer_deps(cim: dict, r: int) -> dict:
    return {k: d.layer(r) for k, d in cim["slot0_attn"].items()}


def _demoted(rep: dict, r: int) -> tuple[int, int]:
    """(demoted, served) experts of repeat r's three banks."""
    names = [n for n in rep["matrices"]["deployed"]
             if "/e" in n and n.split("/")[2] == str(r)]
    bad = sum(1 for n in names if n in rep["degraded"])
    return bad, len(names) - bad


# ------------------------------- injection --------------------------------


@pytest.mark.parametrize("fault_aware", [True, False],
                         ids=["fault_aware", "fault_blind"])
@pytest.mark.parametrize("pipeline", ["mdm_expert", SPARE],
                         ids=["mdm_expert", "spare_line"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_expert_injection_matches_reference(config, pipeline, fault_aware):
    """Every expert of every bank from the reference's cells: codes,
    pos, col_pos, degraded and noise_tag exact, gain within 1e-6; the
    report's degraded, n_degraded and stuck_cells equal; every served
    expert folded (bit for bit its plain fold), a demoted one's fold
    zero; the banks' device tags their noise tags."""
    kw = dict(DEVICES, sigma_read=0.01)
    _, _, jcim, jrep, tcim, trep = _deploy_both(CONFIGS[config](), kw,
                                                pipeline, fault_aware)
    for k in ("degraded", "n_degraded", "stuck_cells", "nonideal",
              "fault_aware"):
        assert trep[k] == jrep[k], k
    banks = 0
    for pname, jdep in jcim["slot0_attn"].items():
        tdep = tcim["slot0_attn"][pname]
        for f in ("codes", "pos", "col_pos", "degraded", "noise_tag"):
            a, b = getattr(jdep, f), getattr(tdep, f)
            assert (a is None) == (b is None), (pname, f)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=f"{pname}.{f}")
        np.testing.assert_allclose(tdep.gain.numpy(), np.asarray(jdep.gain),
                                   rtol=1e-6, err_msg=pname)
        assert tdep.sigma_read == jdep.sigma_read
        if not pname.startswith("ffn_we"):
            continue
        banks += 1
        assert torch.equal(tdep.device_tags, tdep.noise_tag)
        R, E = tdep.codes.shape[:2]
        if tdep.folded is None:              # every expert demoted
            assert bool((tdep.degraded != 0).all()), pname
            continue
        for r in range(R):
            for e in range(E):
                view = tdep.layer(r).layer(e)
                want = (torch.zeros_like(view.folded) if int(view.degraded)
                        else folded_weights(view))
                assert torch.equal(view.folded, want), (pname, r, e)
    assert banks == 3
    assert trep["n_degraded"] > 0 and sum(_demoted(trep, 0)) > 0


def test_expert_noise_tags_are_the_traversal_index():
    """The reference's SMOKE tags: expert k of repeat r of a bank is its
    matrix's index in the traversal (attention first, then the banks)."""
    _, _, jcim, _, tcim, _ = _deploy_both(
        qwen_smoke(), dict(sigma_read=0.01, sigma_program=0.05),
        "mdm_expert")
    gate = tcim["slot0_attn"]["ffn_we_gate"]
    assert gate.noise_tag.tolist() == [list(range(8, 16)),
                                       list(range(16, 24))]
    np.testing.assert_array_equal(
        np.asarray(jcim["slot0_attn"]["ffn_we_gate"].noise_tag),
        gate.noise_tag.numpy())


# -------------------------------- moe_ffn ---------------------------------


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_moe_ffn_on_imperfect_devices_matches_reference(dispatch):
    """Layer 0's ``moe_ffn`` on banks with demoted and served experts
    (both present), no read noise: the port's plain path and its
    grouped wrapper against the reference's at the f32 bound."""
    jcfg = moe_config(dispatch)
    jp, tp, jcim, jrep, tcim, trep = _deploy_both(jcfg, DEVICES, SPARE)
    bad, good = _demoted(trep, 0)
    assert bad > 0 and good > 0, (bad, good)
    x = np.random.default_rng(7).standard_normal((2, 16, 32)).astype(
        np.float32)
    jl = {k: v[0] for k, v in jp["slot0_attn"].items()}
    jc = {k: jax.tree_util.tree_map(lambda a: a[0], d)
          for k, d in jcim["slot0_attn"].items()}
    jy, _ = jmoe.moe_ffn(jl, jnp.asarray(x), jcfg, ShardingCtx(), cim=jc)
    tl = {k: v[0] for k, v in tp["slot0_attn"].items()}
    tcfg = port_config(jcfg)
    want = np.asarray(jy)
    wrapper = lambda xs, d, off, cap, seed=None: cim_mvm_grouped(
        xs, d, off, cap, seed, device=CPU)
    for grouped in (PLAIN.grouped, wrapper):
        ty, _ = moe.moe_ffn(tl, torch.from_numpy(x), tcfg, grouped,
                            cim=_layer_deps(tcim, 0))
        np.testing.assert_allclose(
            ty.numpy(), want, rtol=RTOL,
            atol=ATOL * max(1.0, float(np.abs(want).max())))


def test_all_demoted_bank_is_served_digitally():
    """A bank whose every expert is demoted never reaches the grouped
    form (its fold may not exist) and serves x @ w in f32."""
    spec = CrossbarSpec(*SPEC)
    rng = np.random.default_rng(1)
    ws = torch.from_numpy((0.2 * rng.standard_normal((2, 32, 8))).astype(
        np.float32))
    deps = [deploy(w, spec, "mdm")[0] for w in ws]
    bank = dataclasses.replace(deps[0], **{
        f: torch.stack([getattr(d, f) for d in deps])
        for f in ("codes", "pos", "scale")},
        gain=torch.ones((2,) + deps[0].codes.shape),
        degraded=torch.tensor([3, 1], dtype=torch.int32))
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    disp = moe._dispatch(torch.tensor([0, 0, 1, 1]),
                         torch.tensor([0, 1, 0, 1]),
                         torch.ones(4, dtype=torch.bool),
                         torch.tensor([2, 2]), 2)

    def never(*a):
        raise AssertionError("the grouped form read an all-demoted bank")

    y = moe._expert_mm(x, ws, bank, disp, never)
    np.testing.assert_allclose(y[:2].numpy(), (x[:2] @ ws[0]).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(y[2:].numpy(), (x[2:] @ ws[1]).numpy(),
                               rtol=1e-6)


# ------------------------------- the slice --------------------------------


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


def test_nonideal_moe_slice_matches_reference(tmp_path):
    """SMOKE qwen2-moe served on imperfect devices under ``part=expert,
    row=spare_line, col=spare_line``, the reference's cells moved
    across, no read noise: ``ServeEngine``'s teacher-forced logits
    within 1e-4 * max|logit| and greedy tokens equal to the reference's
    ``ServeEngine``; ``ContinuousEngine``'s greedy tokens equal to the
    reference's ``ContinuousEngine``."""
    jcfg = qwen_smoke()
    tcfg = port_config(jcfg)
    jm, tm = jni.NonidealModel(**DEVICES), NonidealModel(**DEVICES)
    jp, tree, tp = _params(jcfg)
    kw = dict(nonideal_seed=0, pipeline=SPARE)
    jeng = JServe(jcfg, jp, max_seq=MAX_SEQ, nonideal=jm, **kw)
    tcim, trep = deploy_model_params(
        tp, tcfg, device=CPU, nonideal=tm, pipeline=SPARE,
        cells=_reference_cells(tree, jcfg, jm, SPARE))
    for k in ("n_degraded", "degraded", "stuck_cells"):
        assert trep[k] == jeng.deploy_report[k], k
    assert 0 < trep["n_degraded"] < trep["n_matrices"]
    teng = ServeEngine(tcfg, tp, max_seq=MAX_SEQ, plan_cache=False,
                       device=CPU)
    teng.cim, teng.deploy_report = tcim, trep
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

    jcont = JContinuous(jcfg, jp, capacity=2, max_seq=64, max_prompt=16,
                        nonideal=jm, **kw)
    tcont = ContinuousEngine(tcfg, tp, capacity=2, max_seq=64,
                             max_prompt=16, plan_cache=PlanCache(
                                 str(tmp_path)), nonideal=tm, cim=tcim,
                             **kw, device=CPU)
    jrids = [jcont.submit(p, max_tokens=n_new) for p in prompts]
    trids = [tcont.submit(p, max_tokens=n_new) for p in prompts]
    jout, tout = jcont.run(), tcont.run()
    for i in range(len(prompts)):
        assert tout[trids[i]] == jout[jrids[i]], f"request {i}"
        assert tout[trids[i]] == list(j_tok[i])


# ------------------------------ read noise --------------------------------


def _noisy_banks(sigma=0.05, n=256, E=2):
    """E experts of the same (n, n) weights, tags 5, 6, ...: the port's
    stacked bank (folded) and the reference's."""
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((n, n)) * 0.1).astype(np.float32)
    tdeps, jdeps = [], []
    for e in range(E):
        td, _ = deploy(torch.from_numpy(w), CrossbarSpec(64, 64, 8))
        jd, _ = j_deploy(jnp.asarray(w), JSpec(64, 64, 8))
        tdeps.append(ops.fold(dataclasses.replace(
            td, sigma_read=sigma,
            noise_tag=torch.tensor(5 + e, dtype=torch.int32))))
        jdeps.append(dataclasses.replace(jd, sigma_read=sigma,
                                         noise_tag=jnp.int32(5 + e)))
    bank = dataclasses.replace(tdeps[0], **{
        f: torch.stack([getattr(d, f) for d in tdeps])
        for f in ("codes", "pos", "scale", "noise_tag")})
    bank.folded = torch.stack([d.folded for d in tdeps])
    jbank = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jdeps)
    x = rng.standard_normal((E, 4, n)).astype(np.float32)
    return bank, jbank, np.stack([w] * E), x


def test_grouped_read_noise_is_deterministic_and_per_expert():
    """One seed reads one W_eff (bit-identical); another seed another;
    two experts of the same weights draw independent noise (their
    noises' correlation within 5 standard errors of 0)."""
    bank, _, _, x = _noisy_banks()
    xt = torch.from_numpy(x.reshape(8, -1))
    off = torch.tensor([0, 4, 8], dtype=torch.int32)
    read = lambda s: cim_mvm_grouped(xt, bank, off, 4, s, device=CPU)
    y = read(7)
    assert torch.equal(y, read(7))
    assert not torch.equal(y, read(8))
    clean = read(None)
    d = (y - clean).reshape(2, 4, -1)
    assert float(d.abs().max()) > 1e-3 * float(clean.abs().max())
    a, b = d[0].reshape(-1), d[1].reshape(-1)
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    assert abs(corr) <= 5 / a.numel() ** 0.5, corr


def test_grouped_read_noise_statistics_match_model_and_reference():
    """The per-row std of the grouped read's noise over 64 reads within
    5% of sigma_read * agg * scale * ||x_r|| for the port and for the
    reference's ``jax.vmap(cim_mvm)`` over the same experts."""
    bank, jbank, w, x = _noisy_banks()
    K, sigma = 8, 0.05
    agg = ((1 - 4.0 ** -K) / 3) ** 0.5
    want = sigma * agg * float(bank.scale[0]) * np.linalg.norm(
        x.reshape(8, -1), axis=1)
    xt = torch.from_numpy(x.reshape(8, -1))
    off = torch.tensor([0, 4, 8], dtype=torch.int32)
    read = lambda s: cim_mvm_grouped(xt, bank, off, 4, s, device=CPU).numpy()
    clean = read(None)
    d = np.stack([read(s) - clean for s in range(64)])      # (reads, 8, N)
    jread = lambda key: np.asarray(jmoe._expert_mm(
        jnp.asarray(x), jnp.asarray(w), jbank, 0, read_key=key)).reshape(8, -1)
    j_clean = jread(None)
    jd = np.stack([jread(jax.random.PRNGKey(s)) - j_clean
                   for s in range(64)])
    for name, dd in (("port", d), ("reference", jd)):
        std = np.sqrt((dd ** 2).mean(axis=(0, 2)))           # a row
        assert np.all(np.abs(std / want - 1) <= 0.05), (name, std / want)
        assert np.all(np.abs(dd.mean(axis=(0, 2))) <= 5 * want / 128), name


@pytest.mark.parametrize("E,cap,I,N,n_pad,A", [
    (60, 16, 2048, 1408, 1408, 17), (60, 128, 1408, 2048, 2048, 2049),
    (6, 4, 200, 72, 72, 46), (8, 1, 64, 30, 32, 3)])
def test_grouped_folded_geometry(E, cap, I, N, n_pad, A):
    """The grouped folded form's launch, pure Python: grid (ceil(N /
    128), ceil(cap / 32), min(E, A)) of 32-row by 128-column blocks,
    rows of ld = n_pad rounded up to 8 floats, a 32 x 32 slab of x and a
    32 x 128 slab of W_eff in shared memory."""
    for bf16 in (False, True):
        for noise in (False, True):
            g = ops.grouped_folded_geometry(E, cap, I, N, n_pad, bf16,
                                            noise, A)
            assert g.form == ops.FORM_GROUPED_FOLDED
            assert (g.gx, g.gy, g.gz) == (-(-N // 128), -(-cap // 32),
                                          min(E, A))
            assert g.ld == -(-n_pad // 8) * 8 == ops.folded_ld(n_pad)
            assert (g.M, g.I, g.N, g.experts) == (cap, I, N, E)
            assert (g.xbf16, g.noise) == (int(bf16), int(noise))
            assert g.smem == 4 * 32 * (32 + 128)
            assert len(g.array) == 28
