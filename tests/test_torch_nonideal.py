"""Imperfect devices on the serving path: the port against the reference
(CPU).

JAX's PRNG streams cannot be reproduced in torch, so parity moves the
reference's sampled cells across (``deploy_model_params(cells=...)``)
and holds the samplers and the read noise to statistics.  Bounds:

* plans, packaged codes, ``pos``, ``col_pos``, ``degraded`` counts, plan
  keys and cache entries: exact (integer work, and f32 penalty sums of
  exact values computed in the reference's order);
* ``gain``: rtol 1e-6 (a sum of K = 8 f32 products, summed in another
  order than numpy's);
* ``cim_mvm`` with gain and ``col_pos``: the reference's three-way
  bound rtol 1e-5 + atol 1e-6 (tests/test_cim_dispatch.py);
* sampler statistics: rates within 5 standard errors of the model and
  of each other; the spread of ln gamma within 3% of the model's; the
  correlated field's lag-1 autocorrelation within 0.01 of the
  reference's (both estimated over 1 M cells);
* read noise: the per-output std of ``y_noisy - y_clean`` over 64 reads
  within 5% of ``sigma_read * agg * scale * ||x_r||`` (the variance
  estimate pools 64 x 256 draws a row, a relative error of ~1%), and
  the reference's XLA read noise passes the same statistic;
* the whole slice: the f32 bound of tests/test_torch_serve.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.hymba_15b import SMOKE as J_HYMBA_SMOKE
from repro.configs.phi3_mini_38b import SMOKE as J_SMOKE
from repro.configs.xlstm_13b import SMOKE as J_XLSTM_SMOKE
from repro.core.mdm import plan_from_masks as j_plan_from_masks
from repro.core.tiling import CrossbarSpec as JSpec
from repro.deploy import PlanCache as JPlanCache
from repro.deploy.cache import manifest_key as j_manifest_key
from repro.deploy.cache import plan_key as j_plan_key
from repro.deploy.cache import weight_fingerprint as j_fingerprint
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.deploy.engine import deploy_model_params as j_deploy_model
from repro.distributed.sharding import ShardingCtx
from repro.kernels.cim_mvm.ops import cim_mvm as j_cim_mvm
from repro.kernels.cim_mvm.ops import deploy as j_deploy
from repro.mapping import resolve_pipeline as j_resolve
from repro.models import model as jmodel
from repro.nonideal import models as jni
from repro.nonideal.inject import sample_deployment_cells as j_sample_cells
from repro.nonideal.weights import nonideal_weights as j_nonideal_weights
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.mdm import plan_from_masks
from repro_torch.core.noise import noisy_weights
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.deploy import PlanCache, deploy_model_params
from repro_torch.deploy.cache import manifest_key, plan_key, weight_fingerprint
from repro_torch.kernels.cim_mvm.ops import cim_mvm, deploy
from repro_torch.kernels.cim_mvm.ref import deployment_weights
from repro_torch.mapping import named_pipelines, resolve_pipeline
from repro_torch.nonideal import models as tni
from repro_torch.nonideal.inject import sample_deployment_cells
from repro_torch.nonideal.weights import nonideal_weights
from repro_torch.serve import ServeEngine

CPU = "cpu"
LOGIT_RTOL = 1e-4            # the f32 bound of tests/test_torch_serve.py
MAX_SEQ = 32


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's CPU ops on one intra-op thread.  With jaxlib working in
    the same process, a multi-threaded torch op of >= 32768 elements
    (torch's grain size) was seen to leave one thread's eighth of its
    output unwritten, about one process in six: the "all" injection
    case then showed an 8-row block of a gain without its relaxation
    factor.  One thread made it deterministic in 16 of 16 processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


SMOKES = {"phi3": J_SMOKE, "hymba": J_HYMBA_SMOKE, "xlstm": J_XLSTM_SMOKE}


def _smoke(spec=(64, 64, 8), arch="phi3", enabled=True):
    """The reference's SMOKE of ``arch`` (phi3: 2 layers of ("attn",);
    hymba: 2 of ("hybrid",); xlstm: ("mlstm", "slstm") x 2; d_model 64)
    in f32 with CIM enabled."""
    return SMOKES[arch].replace(
        dtype="float32", remat="none", attn_chunk=MAX_SEQ,
        cim=JCim(enabled=enabled, mode="mdm", rows=spec[0], cols=spec[1],
                 n_bits=spec[2]))


def _model_pair(**kw):
    return jni.NonidealModel(**kw), tni.NonidealModel(**kw)


# ------------------------------- bf16 keys --------------------------------

def test_bf16_weight_fingerprint_matches_reference():
    """A bf16 tensor hashes as its int16 view under the dtype name
    'bfloat16': the digest the reference's ``weight_fingerprint`` would
    take of the same ml_dtypes array (shape and dtype-name header, then
    the raw bytes).  The reference's function itself raises on such an
    array (numpy exports no buffer of ml_dtypes' bf16), and its deploy
    hashes the f32 widening of each matrix instead; the port's planner
    does the same, so a bf16 model's plan and manifest keys equal the
    reference's."""
    import hashlib

    from repro_torch.deploy import collect_model_matrices, fingerprint_matrices

    w = np.random.default_rng(0).standard_normal((48, 40)).astype(np.float32)
    jw = np.asarray(jnp.asarray(w, jnp.bfloat16))
    tw = torch.from_numpy(w).to(torch.bfloat16)
    assert np.array_equal(jw.view(np.uint16),
                          tw.view(torch.int16).numpy().view(np.uint16))
    h = hashlib.blake2b(digest_size=32)
    h.update(repr((jw.shape, str(jw.dtype))).encode())
    h.update(jw.view(np.uint16).tobytes())
    fp = weight_fingerprint(tw)
    assert fp == h.hexdigest()
    assert fp != weight_fingerprint(tw.float())
    with pytest.raises(ValueError):
        j_fingerprint(jw)

    jcfg = _smoke().replace(dtype="bfloat16")
    tcfg = _port_cfg(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jcfg, jax.random.PRNGKey(0)))
    spec = CrossbarSpec()
    jmats, _ = j_collect(tree, jcfg, "mdm")
    want = {n: j_plan_key(j_fingerprint(m), JSpec(), "mdm")
            for n, m in jmats.items()}
    tmats, _ = collect_model_matrices(params_from_numpy(tree, tcfg, CPU),
                                      tcfg)
    assert next(iter(tmats.values())).dtype == torch.bfloat16
    got = fingerprint_matrices(tmats, spec, "mdm")
    assert got == want
    assert manifest_key(got) == j_manifest_key(want)


# ------------------------------- samplers ---------------------------------

SHAPE = (4096, 16, 16)        # 4,096 tiles, 1 M cells


def _rate(codes, code):
    return float((np.asarray(codes) == code).mean())


def test_stuck_and_open_rates_match_reference():
    jm, tm = _model_pair(p_stuck_off=0.02, p_stuck_on=0.01,
                         p_open_wordline=0.05, p_open_bitline=0.03)
    j = np.asarray(jni.sample_cell_state(jax.random.PRNGKey(1), SHAPE,
                                         jm).stuck)
    t = tni.sample_cell_state(1, SHAPE, tm, read=False,
                              device="cpu").stuck.numpy()
    T, R, C = SHAPE
    for codes in (j, t):
        open_ = codes == tni.OPEN
        wl = open_.all(-1).mean()              # a whole row open
        bl = open_.all(-2).mean()              # a whole column open
        for rate, p, n in ((wl, 0.05, T * R), (bl, 0.03, T * C)):
            assert abs(rate - p) <= 5 * (p * (1 - p) / n) ** 0.5, (rate, p)
    # Stuck rates off the open lines, against each other and the model.
    for code, p in ((tni.STUCK_OFF, 0.02), (tni.STUCK_ON, 0.01)):
        live = lambda c: c[c != tni.OPEN]
        rj, rt = _rate(live(j), code), _rate(live(t), code)
        se = (p * (1 - p) / live(t).size) ** 0.5
        assert abs(rt - p) <= 5 * se and abs(rj - p) <= 5 * se
        assert abs(rt - rj) <= 7 * se


@pytest.mark.parametrize("term", ["program", "corr"])
def test_log_gain_moments_match_reference(term):
    kw = ({"sigma_program": 0.1} if term == "program"
          else {"sigma_corr": 0.08, "corr_length": 4.0})
    jm, tm = _model_pair(**kw)
    j = np.log(np.asarray(jni.sample_cell_state(jax.random.PRNGKey(2),
                                                SHAPE, jm).gamma))
    t = np.log(tni.sample_cell_state(2, SHAPE, tm, read=False,
                                   device="cpu")
               .gamma.numpy())
    sigma = next(iter(kw.values()))
    for g in (j, t):
        assert abs(g.std() / sigma - 1) <= 0.03, g.std()
        assert abs(g.mean()) <= 5 * sigma / np.sqrt(SHAPE[0])
    assert abs(t.std() / j.std() - 1) <= 0.03


def test_corr_field_lag1_autocorrelation_matches_reference():
    j = np.asarray(jni.sample_corr_field(jax.random.PRNGKey(3), SHAPE, 4.0))
    t = tni.sample_corr_field(3, SHAPE, 4.0, device="cpu").numpy()
    lag1 = lambda f: float(np.mean(f[..., 1:] * f[..., :-1])
                           / np.mean(f * f))
    assert abs(lag1(t) - lag1(j)) <= 0.01, (lag1(t), lag1(j))
    assert lag1(t) > 0.9                          # smooth at length 4
    assert abs(t.std() - 1) <= 0.02


def test_sampler_terms_do_not_reshuffle_each_other():
    """The composition contract: a term's draw is the same whatever the
    other terms' rates."""
    a = tni.sample_cell_state(5, (8, 16, 16), tni.NonidealModel(
        p_stuck_off=0.1, sigma_program=0.1), device="cpu")
    b = tni.sample_cell_state(5, (8, 16, 16), tni.NonidealModel(
        p_stuck_off=0.1, sigma_program=0.3, sigma_read=0.2), device="cpu")
    assert torch.equal(a.stuck, b.stuck)
    assert torch.allclose(torch.log(a.gamma) * 3, torch.log(b.gamma),
                          rtol=1e-5, atol=1e-6)


# --------------------------------- plans ----------------------------------

def _population(spec, seed, n_tiles=(3, 5)):
    """Masks with per-column densities (LSB planes dense, MSB sparse,
    some all-zero spare rows), and the reference's fault map for them."""
    rng = np.random.default_rng(seed)
    ti, tn = n_tiles
    dens = rng.uniform(0.02, 0.6, spec[1])
    masks = (rng.random((ti, tn) + spec[:2]) < dens).astype(np.uint8)
    masks[..., -3:, :] = 0                           # spare rows
    jm = jni.NonidealModel(p_stuck_off=0.03, p_stuck_on=0.01,
                           p_open_wordline=0.05, p_open_bitline=0.05)
    stuck = np.array(jni.sample_cell_state(
        jax.random.PRNGKey(seed), masks.shape, jm).stuck)
    return masks, stuck


@pytest.mark.parametrize("mode", ["fault_aware", "spare_line",
                                  "significance_weighted", "xchangr",
                                  "xchangr_fault_aware", "mdm", "sort"])
@pytest.mark.parametrize("spec", [(16, 64, 8), (64, 64, 8)])
def test_plans_under_reference_fault_maps_are_bit_identical(mode, spec):
    masks, stuck = _population(spec, hash((mode, spec)) % 1000)
    scale = np.float32(0.5)
    want = j_plan_from_masks(jnp.asarray(masks), jnp.float32(scale),
                             JSpec(*spec), mode, jnp.asarray(stuck))
    got = plan_from_masks(torch.from_numpy(masks), torch.tensor(scale),
                          CrossbarSpec(*spec), mode, torch.from_numpy(stuck))
    for f in ("row_perm", "row_position", "col_perm", "col_position",
              "nf_before", "nf_after"):
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f)
    assert bool(want.reversed_dataflow) == got.reversed_dataflow


def test_pipelines_fingerprints_and_tokens_match_reference():
    from repro.mapping import named_pipelines as j_named

    j = j_named()
    for name, pipe in named_pipelines().items():
        assert pipe.fingerprint() == j[name].fingerprint(), name
        assert pipe.cache_token() == j[name].cache_token(), name
        assert pipe.spec() == j[name].spec(), name
    for spec in ("df=reversed,row=spare_line,col=xchangr",
                 "df=conventional,row=fault_aware"):
        assert resolve_pipeline(spec).cache_token() == \
            j_resolve(spec).cache_token()
    assert resolve_pipeline("mdm", True).rows == \
        resolve_pipeline("fault_aware").rows
    assert set(named_pipelines()) == set(j)


# --------------------------------- cache ----------------------------------

def test_fault_keys_and_column_entries_cross_both_ways(tmp_path):
    masks, stuck = _population((16, 64, 8), 7)
    scale = np.float32(0.25)
    jplan = j_plan_from_masks(jnp.asarray(masks), jnp.float32(scale),
                              JSpec(16, 64, 8), "spare_line",
                              jnp.asarray(stuck))
    tplan = plan_from_masks(torch.from_numpy(masks), torch.tensor(scale),
                            CrossbarSpec(16, 64, 8), "spare_line",
                            torch.from_numpy(stuck))
    w = np.random.default_rng(1).standard_normal((48, 40)).astype(np.float32)
    token = resolve_pipeline("spare_line").cache_token()
    key = plan_key(weight_fingerprint(torch.from_numpy(w)),
                   CrossbarSpec(16, 64, 8), token,
                   weight_fingerprint(torch.from_numpy(stuck)))
    assert key == j_plan_key(j_fingerprint(w), JSpec(16, 64, 8), token,
                             j_fingerprint(stuck))
    jc, tc = JPlanCache(str(tmp_path / "j")), PlanCache(str(tmp_path / "t"))
    jc.put(key, jplan)
    tc.put(key, tplan)
    for a, b in ((JPlanCache(str(tmp_path / "t")).get(key), tplan),
                 (PlanCache(str(tmp_path / "j")).get(key), tplan)):
        for f in ("row_perm", "row_position", "col_perm", "col_position",
                  "nf_before", "nf_after"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(), err_msg=f)
    with open(tc._path(key), "rb") as f:
        assert f.read()[0] & 2                     # the column flag


# ------------------------------- injection --------------------------------

SCENARIOS = {
    "stuck": ({"p_stuck_off": 0.05, "p_stuck_on": 0.02}, "mdm"),
    "variation": ({"sigma_program": 0.1}, "mdm"),
    "drift_corr": ({"drift_nu": 0.05, "drift_time": 10.0,
                    "sigma_corr": 0.05, "sigma_program": 0.03}, "mdm"),
    "opens": ({"p_open_wordline": 0.03, "p_open_bitline": 0.03},
              "spare_line"),
    "all": ({"p_stuck_off": 0.02, "p_stuck_on": 0.005, "sigma_program": 0.05,
             "sigma_corr": 0.05, "drift_nu": 0.05, "drift_time": 10.0,
             "sigma_relax": 0.05, "p_open_wordline": 0.02,
             "p_open_bitline": 0.02, "sigma_read": 0.01}, "spare_line"),
}


def _reference_cells(tree, jcfg, jm, pipeline, key=0):
    """The cells the reference's deploy draws (its own call, its key)."""
    mats, _ = j_collect(tree, jcfg, pipeline)
    spec = JSpec(jcfg.cim.rows, jcfg.cim.cols, jcfg.cim.n_bits,
                 jcfg.cim.r, jcfg.cim.r_on, jcfg.cim.r_off)
    grids = {name: spec.grid(*w.shape) for name, w in mats.items()}
    return j_sample_cells(jax.random.PRNGKey(key), grids, spec, jm)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_injection_matches_reference(scenario):
    """From the reference's sampled cells: packaged codes, pos, col_pos
    and degraded counts bit-identical, gain within 1e-6, the deploy
    report's degraded list and stuck-cell count equal."""
    kw, pipeline = SCENARIOS[scenario]
    jm, tm = _model_pair(**kw)
    jcfg = _smoke((16, 64, 8))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jcim, jrep = j_deploy_model(tree, jcfg, nonideal=jm, nonideal_key=0,
                                pipeline=pipeline)
    cells = _reference_cells(tree, jcfg, jm, pipeline)
    tcfg = _port_cfg(jcfg)
    tcim, trep = deploy_model_params(params_from_numpy(tree, tcfg, CPU),
                                     tcfg, device=CPU, nonideal=tm,
                                     pipeline=pipeline, cells=cells)
    for pname, jdep in jcim["slot0_attn"].items():
        tdep = tcim["slot0_attn"][pname]
        for f in ("codes", "pos", "col_pos", "degraded", "noise_tag"):
            a, b = getattr(jdep, f), getattr(tdep, f)
            assert (a is None) == (b is None), (pname, f)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=f"{pname}.{f}")
        assert (jdep.gain is None) == (tdep.gain is None)
        if jdep.gain is not None:
            np.testing.assert_allclose(tdep.gain.numpy(),
                                       np.asarray(jdep.gain), rtol=1e-6)
        assert tdep.sigma_read == jdep.sigma_read
    for k in ("degraded", "n_degraded", "stuck_cells", "nonideal",
              "fault_aware"):
        assert trep[k] == jrep[k], k
    if scenario == "opens":             # spares ran out: demotions
        assert trep["n_degraded"] > 0


def test_port_draws_are_per_matrix_and_deterministic():
    """The port's own draw: a function of (seed, traversal index, model)
    alone, so one matrix's cells do not change with the others'."""
    spec = CrossbarSpec(16, 64, 8)
    m = tni.NonidealModel(p_stuck_off=0.05, sigma_program=0.1)
    a = sample_deployment_cells(3, {"x": (2, 3), "y": (1, 2)}, spec, m,
                                "cpu")
    b = sample_deployment_cells(3, {"x": (2, 3), "z": (4, 4)}, spec, m,
                                "cpu")
    assert torch.equal(a["x"].stuck, b["x"].stuck)
    assert torch.equal(a["x"].gamma, b["x"].gamma)
    c = sample_deployment_cells(4, {"x": (2, 3)}, spec, m, "cpu")
    assert not torch.equal(a["x"].gamma, c["x"].gamma)
    assert a["y"].relax is None


def test_timed_deploy_reports_stage_seconds_and_changes_nothing():
    """``timed=True`` adds the seconds of each deploy stage to the report
    and gives the same deployments as the untimed deploy."""
    kw, pipeline = SCENARIOS["all"]
    tm = tni.NonidealModel(**kw)
    jcfg = _smoke((16, 64, 8))
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = _port_cfg(jcfg)
    params = params_from_numpy(tree, tcfg, CPU)
    run = lambda timed: deploy_model_params(
        params, tcfg, device=CPU, nonideal=tm, nonideal_key=3,
        pipeline=pipeline, timed=timed)
    (a, ra), (b, rb) = run(False), run(True)
    assert "seconds" not in ra
    assert set(rb["seconds"]) == {"sample", "plan", "inject", "package"}
    assert all(s >= 0.0 for s in rb["seconds"].values())
    for pname, da in a["slot0_attn"].items():
        db = b["slot0_attn"][pname]
        for f in ("codes", "pos", "scale", "gain", "col_pos", "degraded",
                  "folded"):
            x, y = getattr(da, f), getattr(db, f)
            assert (x is None) == (y is None) and (
                x is None or torch.equal(x, y)), (pname, f)


@pytest.mark.parametrize("opens", [0.0, 0.02])
def test_deploy_folds_every_served_matrix(opens):
    """A whole-model deploy on imperfect devices (the "all" scenario,
    line opens at ``opens``: none, or every matrix degraded) folds each
    served (non-degraded) repeat of a stacked deployment once: its
    ``layer(r)`` view's ``folded`` is the fold of that repeat bit for
    bit, a degraded repeat's stays zero, and a slot with no served
    repeat has none."""
    from repro_torch.kernels.cim_mvm.ops import needs_fold
    from repro_torch.kernels.cim_mvm.ref import folded_weights

    kw, pipeline = SCENARIOS["all"]
    kw = dict(kw, p_open_wordline=opens, p_open_bitline=opens)
    jcfg = _smoke((16, 64, 8))
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = _port_cfg(jcfg)
    cim, rep = deploy_model_params(
        params_from_numpy(tree, tcfg, CPU), tcfg, device=CPU,
        nonideal=tni.NonidealModel(**kw), nonideal_key=3, pipeline=pipeline)
    served = 0
    for slot in cim.values():
        for dep in slot.values():
            assert needs_fold(dep)
            for r in range(dep.codes.shape[0]):
                view = dep.layer(r)
                if view.degraded is not None and int(view.degraded):
                    assert dep.folded is None or not view.folded.any()
                    continue
                served += 1
                assert torch.equal(view.folded, folded_weights(view))
    assert served == rep["n_matrices"] - rep["n_degraded"]
    assert served == (rep["n_matrices"] if opens == 0.0 else 0)


def test_nonideal_weights_match_reference():
    """The exact Eq-17 evaluator under the reference's stuck and gamma
    fields, with fault-aware planning."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    spec = (16, 64, 8)
    jm = jni.NonidealModel(p_stuck_off=0.05, p_stuck_on=0.02,
                           sigma_program=0.1, drift_nu=0.05, drift_time=5.0)
    ti, tn = JSpec(*spec).grid(40, 24)
    cs = jni.sample_cell_state(jax.random.PRNGKey(1),
                               (ti, tn) + spec[:2], jm)
    for mode in ("mdm", "spare_line"):
        want, _ = j_nonideal_weights(jnp.asarray(w), JSpec(*spec), mode,
                                     stuck=cs.stuck, gamma=cs.gamma,
                                     model=jm, fault_aware=True)
        got, _ = nonideal_weights(
            torch.from_numpy(w), CrossbarSpec(*spec), mode,
            stuck=torch.from_numpy(np.array(cs.stuck)),
            gamma=torch.from_numpy(np.array(cs.gamma)),
            model=tni.NonidealModel(p_stuck_off=0.05, p_stuck_on=0.02,
                                    sigma_program=0.1, drift_nu=0.05,
                                    drift_time=5.0), fault_aware=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    got, _ = noisy_weights(torch.from_numpy(w), CrossbarSpec(*spec),
                           "xchangr")
    from repro.core.noise import noisy_weights as j_noisy_weights
    want, _ = j_noisy_weights(jnp.asarray(w), JSpec(*spec), "xchangr")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


# ------------------------------ read noise --------------------------------

def _noisy_pair(sigma=0.05, n=256):
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((n, n)) * 0.1).astype(np.float32)
    tdep, _ = deploy(torch.from_numpy(w), CrossbarSpec(64, 64, 8))
    jdep, _ = j_deploy(jnp.asarray(w), JSpec(64, 64, 8))
    tdep = dataclasses.replace(tdep, sigma_read=sigma,
                               noise_tag=torch.tensor(5, dtype=torch.int32))
    jdep = dataclasses.replace(jdep, sigma_read=sigma,
                               noise_tag=jnp.int32(5))
    x = rng.standard_normal((4, n)).astype(np.float32)
    return tdep, jdep, x


def test_read_noise_is_deterministic_and_independent_of_m():
    tdep, _, x = _noisy_pair()
    xt = torch.from_numpy(x)
    y = cim_mvm(xt, tdep, read_seed=7, device=CPU)
    assert torch.equal(y, cim_mvm(xt, tdep, read_seed=7, device=CPU))
    assert not torch.equal(y, cim_mvm(xt, tdep, read_seed=8, device=CPU))
    assert torch.equal(deployment_weights(tdep, 7),
                       deployment_weights(tdep, 7))
    # Every row of a batch sees the same W' in one read: a row at M = 1
    # equals its row at M = 8 up to the product's summation order, which
    # the CPU's matmul picks by M (the cim_mvm bound, 1e-5 * max|y|);
    # the noise moves y by far more than that.
    x8 = torch.cat([xt, xt])
    y8 = cim_mvm(x8, tdep, read_seed=7, device=CPU)
    clean = cim_mvm(xt, dataclasses.replace(tdep, sigma_read=0.0),
                    device=CPU)
    tol = 1e-5 * float(y8.abs().max())
    assert float((y - clean).abs().max()) > 100 * tol
    for r in range(4):
        y1 = cim_mvm(xt[r:r + 1], tdep, read_seed=7, device=CPU)[0]
        assert float((y1 - y8[r]).abs().max()) <= tol
        assert float((y1 - y8[r + 4]).abs().max()) <= tol
    assert torch.equal(cim_mvm(xt, tdep, device=CPU), clean)  # no seed


def test_read_noise_statistics_match_model_and_reference():
    tdep, jdep, x = _noisy_pair()
    K, sigma = 8, 0.05
    agg = ((1 - 4.0 ** -K) / 3) ** 0.5
    want = sigma * agg * float(tdep.scale) * np.linalg.norm(x, axis=1)
    xt = torch.from_numpy(x)
    clean = cim_mvm(xt, dataclasses.replace(tdep, sigma_read=0.0),
                    device=CPU).numpy()
    d = np.stack([cim_mvm(xt, tdep, read_seed=s, device=CPU).numpy() - clean
                  for s in range(64)])                  # (reads, M, N)
    j_clean = np.asarray(j_cim_mvm(jnp.asarray(x), jdep, impl="xla"))
    jd = np.stack([np.asarray(j_cim_mvm(jnp.asarray(x), jdep,
                                        read_key=jax.random.PRNGKey(s),
                                        impl="xla")) - j_clean
                   for s in range(64)])
    for name, dd in (("port", d), ("reference", jd)):
        std = np.sqrt((dd ** 2).mean(axis=(0, 2)))          # a row
        assert np.all(np.abs(std / want - 1) <= 0.05), (name, std / want)
        assert np.all(np.abs(dd.mean(axis=(0, 2))) <= 5 * want / 128), name


# ------------------------------ the slice ---------------------------------

_SLICE_DEVICES = dict(p_stuck_off=0.02, sigma_program=0.05,
                      p_open_wordline=0.05)


def _slice_pair(tmp_path, arch, kw=_SLICE_DEVICES):
    """The reference's engine on imperfect devices under ``spare_line``
    and the port's, deployed from the reference's cells."""
    jm, tm = _model_pair(**kw)
    jcfg = _smoke(arch=arch)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jeng = JEngine(jcfg, jparams, max_seq=MAX_SEQ,
                   plan_cache=JPlanCache(str(tmp_path / "j")), nonideal=jm,
                   nonideal_seed=0, pipeline="spare_line")
    tcfg = _port_cfg(jcfg)
    tparams = params_from_numpy(tree, tcfg, CPU)
    teng = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ,
                       plan_cache=PlanCache(str(tmp_path / "t")),
                       device=CPU)
    teng.cim, teng.deploy_report = deploy_model_params(
        tparams, tcfg, device=CPU, nonideal=tm, pipeline="spare_line",
        cells=_reference_cells(tree, jcfg, jm, "spare_line"))
    return jeng, teng, tree


def _j_teacher_forced(jeng, seq, n_prompt, cim):
    cfg, ctx = jeng.cfg, ShardingCtx()
    state = jmodel.init_decode_state(cfg, seq.shape[0], MAX_SEQ)
    logits, state, _ = jmodel.apply_model(
        jeng.params, cfg, ctx, tokens=jnp.asarray(seq[:, :n_prompt]),
        state=state, cim=cim)
    rows = [np.asarray(logits[:, -1])]
    for t in range(n_prompt, seq.shape[1]):
        logits, state, _ = jmodel.apply_model(
            jeng.params, cfg, ctx, tokens=jnp.asarray(seq[:, t:t + 1]),
            state=state, decode=True, cim=cim)
        rows.append(np.asarray(logits[:, 0]))
    return np.stack(rows, axis=1)


@pytest.mark.parametrize("arch", list(SMOKES))
def test_nonideal_slice_matches_reference(tmp_path, arch):
    """SMOKE phi3, hymba and xlstm on imperfect devices under
    ``spare_line``, the reference's cells moved across, no read noise:
    the deploy report's degraded matrices and stuck cells equal,
    teacher-forced logits within the f32 bound, greedy tokens equal."""
    jeng, teng, _ = _slice_pair(tmp_path, arch)
    for k in ("n_degraded", "degraded", "stuck_cells"):
        assert teng.deploy_report[k] == jeng.deploy_report[k], k
    assert teng.deploy_report["n_matrices"] == \
        jeng.deploy_report["n_matrices"] > 0

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jeng.cfg.vocab_size, (2, 8)).astype(np.int32)
    j_tok = np.asarray(jeng.generate(jnp.asarray(prompts), 6))
    t_tok = teng.generate(torch.from_numpy(prompts), 6).numpy()
    seq = np.concatenate([prompts, j_tok[:, :-1]], axis=1)
    j_logits = _j_teacher_forced(jeng, seq, 8, jeng.cim)
    t_logits = teng.teacher_forced_logits(torch.from_numpy(seq), 8).numpy()
    V = jeng.cfg.vocab_size
    err = np.abs(t_logits[..., :V] - j_logits[..., :V]).max()
    assert err <= LOGIT_RTOL * np.abs(j_logits[..., :V]).max(), err
    np.testing.assert_array_equal(t_tok, j_tok)


def test_xlstm_imperfect_devices_serve_the_digital_logits(tmp_path):
    """The xLSTM caveat on both packages: its only deployed matrices are
    the mLSTM q/k/v, which are served digitally, so its logits on
    imperfect devices are the ideal digital logits bit for bit."""
    jeng, teng, tree = _slice_pair(tmp_path, "xlstm", dict(
        _SLICE_DEVICES, sigma_read=0.05, drift_nu=0.1, drift_time=10.0))
    assert {n.split("/")[1] for n in jeng.deploy_report["matrices"][
        "deployed"]} == {"wq", "wk", "wv"}
    seq = np.random.default_rng(2).integers(
        0, jeng.cfg.vocab_size, (2, 12)).astype(np.int32)
    j_digital = _j_teacher_forced(jeng, seq, 8, None)
    np.testing.assert_array_equal(
        _j_teacher_forced(jeng, seq, 8, jeng.cim), j_digital)
    tcfg = _port_cfg(_smoke(arch="xlstm", enabled=False))
    digital = ServeEngine(tcfg, params_from_numpy(tree, tcfg, CPU),
                          max_seq=MAX_SEQ, plan_cache=False, device=CPU)
    assert digital.cim is None
    t_digital = digital.teacher_forced_logits(torch.from_numpy(seq), 8)
    assert torch.equal(teng.teacher_forced_logits(torch.from_numpy(seq), 8),
                       t_digital)


def test_engine_read_seeds_repeat_per_generate_call(tmp_path):
    """With read noise armed, two generate calls with one seed give the
    same tokens, and the teacher-forced logits of one seed repeat."""
    jcfg = _smoke((16, 64, 8))
    tcfg = _port_cfg(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jcfg, jax.random.PRNGKey(0)))
    eng = ServeEngine(tcfg, params_from_numpy(tree, tcfg, CPU),
                      max_seq=MAX_SEQ, plan_cache=PlanCache(str(tmp_path)),
                      nonideal=tni.NonidealModel(sigma_read=0.05),
                      nonideal_seed=2, device=CPU)
    assert eng.read_noise
    p = torch.from_numpy(np.arange(8, dtype=np.int64)[None] % 200)
    assert torch.equal(eng.generate(p, 5, seed=1), eng.generate(p, 5, seed=1))
    a = eng.teacher_forced_logits(torch.cat([p, p], 1), 8, seed=3)
    b = eng.teacher_forced_logits(torch.cat([p, p], 1), 8, seed=3)
    c = eng.teacher_forced_logits(torch.cat([p, p], 1), 8, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
