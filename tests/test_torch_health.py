"""The port's serving health (detector, probes, remediation ladder, both
engines' ``advance`` / ``check_health``) against the reference (CPU).

At the reference's own test size (``tests/test_health.py``: 2 layers,
d_model 32, 16x16x4 tiles) and with the reference's cell draws taken
across (its deploy's cells into the port's deploy, its lifetimes' cell
fields into the port's refreshes, ``repro_torch.convert``):

- detector trips and clears on the same observations of the same
  streams; ``probe_vectors``, ``probe_error`` and ``estimate_recal``
  bit-identical;
- probe reads (the batched form's plain version over padded ragged and
  stacked groups, and per matrix) within the reference's three-way
  bound, rtol 1e-5 + atol 1e-6;
- the escalation ladder: the same (matrix, event) history and counters
  on ``ServeEngine`` and ``ContinuousEngine``, every gain within rtol
  1e-6;
- the engine contracts: ``age_per_token``, ``health=`` without a
  non-ideal model, demotion to ``x @ w``, atomic swaps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.configs.hymba_15b import SMOKE as J_HYMBA_SMOKE
from repro.configs.xlstm_13b import SMOKE as J_XLSTM_SMOKE
from repro.core.tiling import CrossbarSpec as JSpec
from repro.deploy import PlanCache as JPlanCache
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.health import DetectorConfig as JDetectorConfig
from repro.health import DriftDetector as JDetector
from repro.health import HealthConfig as JHealthConfig
from repro.health import HealthController as JController
from repro.health import monitor as jmon
from repro.kernels.cim_mvm.ops import cim_mvm as j_cim_mvm
from repro.models import model as jmodel
from repro.nonideal import NonidealModel as JNonideal
from repro.nonideal.inject import sample_deployment_cells as j_sample_cells
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import ServeEngine as JServe
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.convert import (
    detector_config_from_reference,
    health_config_from_reference,
    params_from_numpy,
    take_reference_draws,
)
from repro_torch.deploy import (
    DEMOTED_RUNTIME,
    PlanCache,
    deploy_model_params,
)
from repro_torch.health import (
    DetectorConfig,
    DriftDetector,
    HealthConfig,
    HealthController,
    estimate_recal,
    probe_error,
    probe_vectors,
)
from repro_torch.kernels.cim_mvm.ops import cim_mvm, cim_mvm_batched
from repro_torch.models.model import KERNELS, _cim_matmul
from repro_torch.nonideal import NonidealModel
from repro_torch.serve import Bank, ContinuousEngine, ServeEngine
from repro_torch.serve import engine as engine_mod

CPU = "cpu"
VOCAB = 128
READ_RTOL, READ_ATOL = 1e-5, 1e-6     # the reference's three-way bound
GAIN_RTOL = 1e-6
_AGING = dict(drift_nu=0.1, sigma_relax=0.08, sigma_program=0.03)
SMOKES = {"hybrid": J_HYMBA_SMOKE, "xlstm": J_XLSTM_SMOKE}
LIFETIMES = {"attn": 14, "hybrid": 14, "xlstm": 3}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's CPU ops on one intra-op thread, as
    ``tests/test_torch_nonideal.py`` runs them beside jaxlib."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------ detector ----------------------------------

def _stream(kind: str, seed: int, n: int = 60) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = 0.05 + 0.002 * rng.standard_normal(n)
    if kind == "step":
        base[30:] += 0.02
    elif kind == "ramp":
        base += np.linspace(0.0, 0.03, n)
    elif kind == "threshold":           # a level at the trip threshold
        base[20:] = 0.05 + 0.0125
    return base


@pytest.mark.parametrize("kind", ["stationary", "step", "ramp", "threshold"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_trips_and_clears_like_reference(kind, seed):
    """Same stream, same configuration: the same trip state after every
    observation and the same state dict, a rearm mid-stream included."""
    kw = dict(warmup=5, z_trip=6.0, z_clear=2.0, ewma_alpha=0.4)
    jd, td = JDetector(JDetectorConfig(**kw)), DriftDetector(
        DetectorConfig(**kw))
    for i, e in enumerate(_stream(kind, seed)):
        assert td.update(e) == jd.update(e), i
        if i == 40:
            jd.rearm()
            td.rearm()
        assert td.state() == jd.state(), i
    assert (td.n_trips, td.n_clears) == (jd.n_trips, jd.n_clears)


def test_detector_config_validation_and_conversion():
    with pytest.raises(ValueError):
        DetectorConfig(z_trip=2.0, z_clear=2.0)
    with pytest.raises(ValueError):
        DetectorConfig(warmup=1)
    with pytest.raises(ValueError):
        HealthConfig(n_probes=0)
    with pytest.raises(ValueError):
        HealthConfig(max_reprograms=-1)
    j = JHealthConfig(n_probes=8, probe_seed=3, max_reprograms=2,
                      age_per_token=0.5, recal_limit=7.0,
                      detector=JDetectorConfig(warmup=3, z_trip=6.0))
    t = health_config_from_reference(j)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert detector_config_from_reference(j.detector) == t.detector


# ------------------------------ monitor -----------------------------------

@pytest.mark.parametrize("tag", [0, 5, 1234])
def test_probe_vectors_and_residual_fits_bit_identical(tag):
    j, t = JHealthConfig(n_probes=8, probe_seed=5), HealthConfig(
        n_probes=8, probe_seed=5)
    p = probe_vectors(t, tag, 40)
    np.testing.assert_array_equal(p, jmon.probe_vectors(j, tag, 40))
    rng = np.random.default_rng(tag)
    y_ref = rng.standard_normal((8, 6)).astype(np.float32)
    y_cim = (y_ref * rng.uniform(0.5, 2.0, 6)).astype(np.float32)
    y_cim[:, 2] = 0.0                    # a dead column keeps 1
    np.testing.assert_array_equal(estimate_recal(y_cim, y_ref, 20.0),
                                  jmon.estimate_recal(y_cim, y_ref, 20.0))
    assert probe_error(y_cim, y_ref) == jmon.probe_error(y_cim, y_ref)


# ------------------------------ the engines -------------------------------

def _jcfg(pattern: str = "attn") -> JModel:
    """The reference test's ("attn",) model, or the SMOKE hymba
    (("hybrid",)) or xlstm (("mlstm", "slstm")) at its tiles."""
    cim = JCim(enabled=True, mode="mdm", rows=16, cols=16, n_bits=4)
    if pattern != "attn":
        return SMOKES[pattern].replace(dtype="float32", remat="none",
                                       cim=cim)
    return JModel(
        name="cim-health-test", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=2, d_ff=64, vocab_size=VOCAB, block_pattern=("attn",),
        remat="none", dtype="float32", attn_chunk=32, cim=cim)


def _tcfg(jcfg: JModel) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


def _jhealth(max_reprograms=1, age_per_token=0.0) -> JHealthConfig:
    """The reference test's ``_health``."""
    return JHealthConfig(
        n_probes=8, max_reprograms=max_reprograms,
        age_per_token=age_per_token,
        detector=JDetectorConfig(warmup=3, z_trip=6.0, z_clear=2.0))


def _tree(jcfg):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _reference_cells(tree, jcfg, jm, key):
    mats, _ = j_collect(tree, jcfg, jcfg.cim.mode)
    spec = JSpec(jcfg.cim.rows, jcfg.cim.cols, jcfg.cim.n_bits,
                 jcfg.cim.r, jcfg.cim.r_on, jcfg.cim.r_off)
    grids = {name: spec.grid(*w.shape) for name, w in mats.items()}
    return j_sample_cells(jax.random.PRNGKey(key), grids, spec, jm)


def _pair(tmp_path, tier="serve", jh=None, seed=3, model=_AGING,
          pattern="attn"):
    """A reference engine and the port's, the port's bank deployed from
    the reference's cells and its lifetimes reading the reference's
    draws."""
    jh = jh or _jhealth()
    jcfg = _jcfg(pattern)
    jp, tree = _tree(jcfg)
    jm, tm = JNonideal(**model), NonidealModel(**model)
    th = health_config_from_reference(jh)
    tcfg = _tcfg(jcfg)
    tparams = params_from_numpy(tree, tcfg, CPU)
    if tier == "serve":
        jeng = JServe(jcfg, jp, max_seq=64,
                      plan_cache=JPlanCache(str(tmp_path / "j")),
                      nonideal=jm, nonideal_seed=seed, health=jh)
        teng = ServeEngine(tcfg, tparams, max_seq=64,
                           plan_cache=PlanCache(str(tmp_path / "t")),
                           nonideal=tm, nonideal_seed=seed, health=th,
                           device=CPU)
    else:
        jeng = JContinuous(jcfg, jp, capacity=2, max_seq=64, max_prompt=16,
                           plan_cache=JPlanCache(str(tmp_path / "j")),
                           nonideal=jm, nonideal_seed=seed, health=jh)
        teng = ContinuousEngine(tcfg, tparams, capacity=2, max_seq=64,
                                max_prompt=16,
                                plan_cache=PlanCache(str(tmp_path / "t")),
                                nonideal=tm, nonideal_seed=seed, health=th,
                                device=CPU)
    lifetime: dict = {}
    cim, _ = deploy_model_params(
        tparams, tcfg, device=CPU, nonideal=tm, nonideal_key=seed,
        cells=_reference_cells(tree, jcfg, jm, seed), lifetime=lifetime)
    take_reference_draws(lifetime, jeng.lifetime)
    if tier == "serve":
        teng.cim = cim
    else:
        teng.banks = {0: Bank(0, tparams, cim)}
    teng.lifetime, teng.health = lifetime, HealthController(lifetime, th)
    return jeng, teng


def _held(jeng, teng, step: str) -> None:
    """Same counters and events, same ladder state, gains within 1e-6."""
    jr, tr = jeng.health.report(), teng.health.report()
    assert tr.counters == jr.counters, step
    assert [(e["round"], e["matrix"], e["event"]) for e in tr.events] == \
        [(e["round"], e["matrix"], e["event"]) for e in jr.events], step
    for name, jlt in jeng.lifetime.items():
        tlt = teng.lifetime[name]
        assert (tlt.age, tlt.rung, tlt.reprograms, tlt.demoted) == \
            (jlt.age, jlt.rung, jlt.reprograms, jlt.demoted), (step, name)
        if not jlt.demoted:
            np.testing.assert_allclose(tlt.dep.gain.numpy(),
                                       np.asarray(jlt.dep.gain),
                                       rtol=GAIN_RTOL, err_msg=name)
        else:
            assert int(tlt.dep.degraded) == DEMOTED_RUNTIME
        np.testing.assert_allclose(tr.matrices[name]["last_err"] or 0.0,
                                   jr.matrices[name]["last_err"] or 0.0,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("tier,pattern", [
    pytest.param("serve", "attn", id="serve"),
    pytest.param("continuous", "attn", id="continuous"),
    pytest.param("serve", "hybrid", id="serve-hybrid"),
    pytest.param("serve", "xlstm", id="serve-xlstm")])
def test_escalation_ladder_matches_reference(tmp_path, tier, pattern):
    """The reference test's full arc, both packages in lockstep: warm-up
    (no trips), advance 1e4 -> recalibrate, 1e8 -> reprogram (clock
    reset), 1e4 -> recalibrate, 1e8 -> demote; every step held, greedy
    tokens after the demotion equal.  Also on SMOKE hymba (14 lifetimes:
    attention and MLP of each hybrid layer) and SMOKE xlstm, whose 3
    lifetimes (the mLSTM q/k/v) are served digitally: there every
    demotion leaves the tokens as they were."""
    jeng, teng = _pair(tmp_path, tier, pattern=pattern)
    n = len(teng.lifetime)
    assert n == len(jeng.lifetime) == LIFETIMES[pattern]
    p = np.random.default_rng(1).integers(0, VOCAB, (2, 8))
    fresh = teng.generate(torch.from_numpy(p), 3).numpy() \
        if tier == "serve" else None
    for r in range(4):
        jeng.check_health()
        teng.check_health()
        _held(jeng, teng, f"warm-up {r}")
    assert teng.health_report.counters["trips"] == 0
    for dt, want in ((1e4, "recalibrations"), (1e8, "reprograms"),
                     (1e4, "recalibrations"), (1e8, "demotions")):
        jeng.advance(dt)
        teng.advance(dt)
        _held(jeng, teng, f"advance {dt}")
        jeng.check_health()
        rep = teng.check_health()
        _held(jeng, teng, f"round after {dt}")
        assert rep.counters[want] >= n
    assert all(m["demoted"] for m in rep.matrices.values())
    assert rep.flaps == 0
    if tier == "serve":
        out = teng.generate(torch.from_numpy(p), 3).numpy()
        np.testing.assert_array_equal(
            out, np.asarray(jeng.generate(jnp.asarray(p, jnp.int32), 3)))
        if pattern == "xlstm":
            np.testing.assert_array_equal(out, fresh)
    else:                                  # every heal landed as an epoch
        assert teng.serving_epoch > 0 and list(teng.banks) == [
            teng.serving_epoch]


@pytest.mark.parametrize("pattern", ["hybrid", "xlstm"])
def test_continuous_health_refuses_recurrent_patterns(tmp_path, pattern):
    """``ContinuousEngine(health=)`` refuses the recurrent patterns, as
    it does without health: its padded prefill would feed pad tokens to
    the state."""
    jcfg = _jcfg(pattern)
    _, tree = _tree(jcfg)
    tcfg = _tcfg(jcfg)
    with pytest.raises(NotImplementedError, match="attn"):
        ContinuousEngine(tcfg, params_from_numpy(tree, tcfg, CPU),
                         capacity=2, max_seq=64, max_prompt=16,
                         plan_cache=PlanCache(str(tmp_path)),
                         nonideal=NonidealModel(**_AGING), nonideal_seed=3,
                         health=health_config_from_reference(_jhealth()),
                         device=CPU)


def test_recalibration_restores_probe_error(tmp_path):
    """The reference's pure-drift case on the port alone: one rung pulls
    the tripped probe error back near the healthy baseline, no re-trip."""
    jcfg = _jcfg()
    _, tree = _tree(jcfg)
    tcfg = _tcfg(jcfg)
    eng = ServeEngine(tcfg, params_from_numpy(tree, tcfg, CPU), max_seq=64,
                      plan_cache=PlanCache(str(tmp_path)),
                      nonideal=NonidealModel(drift_nu=0.1,
                                             sigma_program=0.03),
                      nonideal_seed=3,
                      health=health_config_from_reference(_jhealth()),
                      device=CPU)
    for _ in range(4):
        eng.check_health()
    base = {n: m.last_err for n, m in eng.health.monitors.items()}
    eng.advance(1e4)
    eng.check_health()
    rep = eng.check_health()
    assert rep.counters["trips"] == len(eng.lifetime)
    for name, m in eng.health.monitors.items():
        assert m.last_err < 1.1 * base[name] + 0.02
    assert rep.flaps == 0


def _port_engine(tmp_path, health, model=_AGING, seed=3):
    jcfg = _jcfg()
    _, tree = _tree(jcfg)
    tcfg = _tcfg(jcfg)
    return ServeEngine(tcfg, params_from_numpy(tree, tcfg, CPU), max_seq=64,
                       plan_cache=PlanCache(str(tmp_path)),
                       nonideal=None if model is None
                       else NonidealModel(**model),
                       nonideal_seed=seed, health=health, device=CPU)


def test_age_per_token_advances_clock_via_generate(tmp_path):
    eng = _port_engine(tmp_path, health_config_from_reference(
        _jhealth(age_per_token=2.0)))
    ages0 = {n: lt.age for n, lt in eng.lifetime.items()}
    eng.generate(torch.zeros((1, 4), dtype=torch.int64), 3)
    for n, lt in eng.lifetime.items():
        assert lt.age == ages0[n] + 6.0 and not lt.stale


@pytest.mark.parametrize("tier", ["serve", "continuous"])
def test_health_requires_nonideal_model(tmp_path, tier):
    """health= without a non-ideal model arms nothing, as the
    reference's ``test_health_requires_nonideal_model``."""
    jcfg = _jcfg()
    _, tree = _tree(jcfg)
    tcfg = _tcfg(jcfg)
    params = params_from_numpy(tree, tcfg, CPU)
    cls = ServeEngine if tier == "serve" else ContinuousEngine
    for model in (None, NonidealModel()):
        eng = cls(tcfg, params, plan_cache=PlanCache(str(tmp_path)),
                  nonideal=model, health=HealthConfig(), device=CPU)
        assert eng.health is None and eng.lifetime == {}
        assert eng.check_health() is None and eng.health_report is None
        eng.advance(10.0)                  # no-op, must not raise


def test_demotion_sentinel_serves_digital_fallback(tmp_path):
    """A runtime-demoted matrix is served as x @ w exactly, a live one
    through the crossbar; after the ladder's demote every forward is
    digital (no cim_mvm call)."""
    eng = _port_engine(tmp_path, health_config_from_reference(_jhealth()))
    a, b = list(eng.lifetime.values())[:2]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, a.dep.in_dim)).astype(np.float32))
    demoted = a.demote()
    torch.testing.assert_close(_cim_matmul(x, a.w, demoted, KERNELS),
                               x @ a.w, rtol=0, atol=0)
    assert not torch.allclose(_cim_matmul(x, b.w, b.dep, KERNELS), x @ b.w,
                              rtol=1e-7)
    eng._swap({("slot0_attn", a.name.split("/")[1])})
    assert int(eng.cim["slot0_attn"][a.name.split("/")[1]].degraded[a.rep]) \
        == DEMOTED_RUNTIME


def test_swap_is_atomic_one_group_at_a_time(tmp_path, monkeypatch):
    """advance() replaces the tree group by group with fresh dicts: the
    old tree, its sub-dicts and its deployments are untouched (a
    generate holding it keeps its bank), unchanged tensors are shared,
    and same-seed engines aged alike generate bit-identical tokens."""
    eng = _port_engine(tmp_path, health_config_from_reference(_jhealth()))
    old = eng.cim
    subs = {k: dict(v) for k, v in old.items()}
    folded = {(s, p): d.folded.clone() for s, sub in old.items()
              for p, d in sub.items()}
    seen = []
    real = engine_mod.restack_group

    def spy(lifetimes, slot, pname, clock):
        seen.append(eng.cim)               # the tree this group lands on
        return real(lifetimes, slot, pname, clock)

    monkeypatch.setattr(engine_mod, "restack_group", spy)
    eng.advance(1e4)
    assert eng.cim is not old and len(seen) == 7 and seen[0] is old
    assert len({id(t) for t in seen + [eng.cim]}) == 8   # a tree a group
    for s, sub in old.items():
        assert all(sub[p] is subs[s][p] for p in sub)
        for p, d in sub.items():
            assert torch.equal(d.folded, folded[(s, p)])
            new = eng.cim[s][p]
            assert new is not d and new.codes is d.codes
            assert not torch.equal(new.folded, d.folded)
    p = torch.from_numpy(np.random.default_rng(1).integers(0, VOCAB, (2, 8)))
    out = eng.generate(p, 4)
    twin = _port_engine(tmp_path, health_config_from_reference(_jhealth()))
    twin.advance(1e4)
    assert torch.equal(out, twin.generate(p, 4))


# ------------------------------ probe reads -------------------------------

def _ragged(shapes, model_kw, tmp_seed=5):
    """The reference's ``_ragged_lifetimes`` and the port's lifetimes
    built from the same cells (one ragged (slot, pname) group)."""
    from repro.deploy.engine import package_deployment_host as j_package
    from repro.deploy.lifetime import MatrixLifetime as JLifetime
    from repro.deploy.planner import plan_matrices as j_plan
    from repro_torch.core.tiling import CrossbarSpec
    from repro_torch.deploy import MatrixLifetime, package_deployment_host
    from repro_torch.deploy.planner import plan_matrices
    from repro_torch.nonideal.inject import cells_on

    jm, tm = JNonideal(**model_kw), NonidealModel(**model_kw)
    jspec = JSpec(rows=16, cols=16, n_bits=4)
    spec = CrossbarSpec(rows=16, cols=16, n_bits=4)
    rs = np.random.RandomState(0)
    mats = {f"s/p/0/{i}": rs.randn(*sh).astype(np.float32) * 0.1
            for i, sh in enumerate(shapes)}
    key = jax.random.PRNGKey(tmp_seed)
    cells = j_sample_cells(key, {n: jspec.grid(*w.shape)
                                 for n, w in mats.items()}, jspec, jm)
    jplans, _ = j_plan(mats, jspec, "mdm")
    tmats = {n: torch.from_numpy(w) for n, w in mats.items()}
    tplans, _ = plan_matrices(tmats, spec, "mdm")
    jl, tl = {}, {}
    for i, (name, w) in enumerate(mats.items()):
        cap: dict = {}
        plan = jplans[name]
        dep = j_package(w, jspec, "mdm", 0.02, plan, cells=cells[name],
                        nonideal=jm, noise_tag=i, capture=cap)
        jl[name] = JLifetime(
            name=name, noise_tag=i, spec=jspec, model=jm, eta=0.02, w=w,
            row_position=np.asarray(plan.row_position),
            reversed_df=bool(plan.reversed_dataflow), col_position=None,
            stuck_phys=cells[name].stuck, codes=cap["codes"],
            stuck_log=cap["stuck_log"], gamma_log=cap["gamma_log"],
            relax_log=cap["relax_log"], dep=dep,
            key=jax.random.fold_in(key, i), age=float(jm.drift_time))
        tdep = package_deployment_host(
            tmats[name], spec, "mdm", 0.02, tplans[name],
            cells=cells_on(cells[name], CPU), nonideal=tm, noise_tag=i,
            capture=True)
        tl[name] = MatrixLifetime(name=name, noise_tag=i, spec=spec,
                                  model=tm, eta=0.02, key=tmp_seed,
                                  w=tmats[name], dep=tdep,
                                  age=float(tm.drift_time))
    return jl, tl


@pytest.mark.parametrize("shapes", [[(24, 12), (16, 8), (24, 8)],
                                    [(24, 12), (24, 12), (24, 12)]],
                         ids=["ragged", "stackable"])
def test_probe_reads_match_reference_batched_and_sequential(shapes):
    """A ragged group through the padded batched read and a uniform one
    through the stacked batched read: one batched call each, every
    member within the three-way bound of the reference's vmapped read
    and of its sequential reads; a probe round then trips nothing."""
    from repro_torch.health import controller as tc

    jl, tl = _ragged(shapes, _AGING)
    jc = JController(jl, _jhealth())
    tc_ = HealthController(tl, health_config_from_reference(_jhealth()))
    jres = jc._probe_reads(list(jl.items()), None)
    calls = {"batched": 0, "single": 0}
    real_b, real_s = tc.cim_mvm_batched, tc.cim_mvm

    def count(kind, fn):
        def inner(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return inner

    tc.cim_mvm_batched = count("batched", real_b)
    tc.cim_mvm = count("single", real_s)
    try:
        tres = tc_._probe_reads(list(tl.items()), None)
    finally:
        tc.cim_mvm_batched, tc.cim_mvm = real_b, real_s
    assert calls == {"batched": 1, "single": 0}
    for name, jlt in jl.items():
        seq = np.asarray(j_cim_mvm(jc.monitors[name].probes_dev, jlt.dep))
        for want in (jres[name], seq):
            np.testing.assert_allclose(tres[name], want, rtol=READ_RTOL,
                                       atol=READ_ATOL, err_msg=name)
    for _ in range(4):
        tc_.probe()
    assert tc_.report().counters["trips"] == 0


def test_probe_reads_meta_conflict_fall_back_to_sequential():
    """A member with another eta cannot share a padded stack: per-matrix
    reads, each within the bound of the reference's."""
    jl, tl = _ragged([(24, 12), (16, 8)], dict(drift_nu=0.1,
                                               sigma_program=0.03))
    for lts in (jl, tl):
        lt0 = lts["s/p/0/0"]
        lt0.dep = dataclasses.replace(lt0.dep, eta=lt0.dep.eta * 2)
    tc_ = HealthController(tl, health_config_from_reference(_jhealth()))
    assert tc_._padded_probe_reads(list(tl.items()), None) is None
    res = tc_._probe_reads(list(tl.items()), None)
    jc = JController(jl, _jhealth())
    for name, jlt in jl.items():
        np.testing.assert_allclose(
            res[name], np.asarray(j_cim_mvm(jc.monitors[name].probes_dev,
                                            jlt.dep)),
            rtol=READ_RTOL, atol=READ_ATOL, err_msg=name)


def test_batched_plain_matches_reference_vmap():
    """The batched form's plain version over a stacked group (members
    out of order, a subset) against the reference's ``jax.vmap(cim_mvm)``
    over the same stacked deployments."""
    from repro_torch.deploy.lifetime import stack_deployments

    jl, tl = _ragged([(24, 12)] * 3, _AGING)
    names = list(jl)
    jdeps = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *[jl[n].dep for n in names])
    x = np.random.default_rng(2).standard_normal((3, 5, 24)).astype(
        np.float32)
    want = np.asarray(jax.vmap(lambda p, d: j_cim_mvm(p, d))(
        jnp.asarray(x), jdeps))
    stacked = stack_deployments([tl[n].dep for n in names])
    got = cim_mvm_batched(torch.from_numpy(x), stacked, device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=READ_RTOL, atol=READ_ATOL)
    sub = cim_mvm_batched(torch.from_numpy(x[[2, 0]]), stacked,
                          members=[2, 0], device=CPU).numpy()
    np.testing.assert_array_equal(sub, got[[2, 0]])
    one = cim_mvm(torch.from_numpy(x[1]), stacked.layer(1), device=CPU)
    np.testing.assert_array_equal(got[1], one.numpy())


def _continuous(tmp_path, health, model=_AGING, seed=3):
    jcfg = _jcfg()
    _, tree = _tree(jcfg)
    tcfg = _tcfg(jcfg)
    params = params_from_numpy(tree, tcfg, CPU)
    return ContinuousEngine(tcfg, params, capacity=2, max_seq=64,
                            max_prompt=16,
                            plan_cache=PlanCache(str(tmp_path)),
                            nonideal=NonidealModel(**model),
                            nonideal_seed=seed, health=health, device=CPU)


def test_continuous_heal_swap_mid_load_keeps_in_flight_sequences(tmp_path):
    """The reference's ``test_hot_swap_mid_load_atomicity[heal]``: an
    aging restack under load lands as new epochs (one a group), the
    sequences in flight keep their admission bank bit for bit, one
    decode signature throughout, and the pinned bank is dropped when
    they finish; a later admission reads the healed bank."""
    health = health_config_from_reference(_jhealth())
    prompts = np.random.default_rng(9).integers(0, VOCAB, (2, 8))

    def fly(eng):
        rids = [eng.submit(prompts[i], max_tokens=6, temperature=0.5 * i,
                           seed=60 + i) for i in range(2)]
        eng.step()
        return rids

    ref = _continuous(tmp_path / "a", health)
    ref_out = [ref.run()[r] for r in fly(ref)]
    eng = _continuous(tmp_path / "b", health)
    rids = fly(eng)
    eng.advance(10.0)
    assert eng.serving_epoch == 7 and sorted(eng.banks) == [0, 7]
    eng.run()
    assert [eng.results[r] for r in rids] == ref_out
    assert eng.traces["decode"] == 1 and list(eng.banks) == [7]
    healed = eng.banks[7].cim
    for lt in eng.lifetime.values():
        slot, pname, _ = lt.name.split("/")
        assert lt.bank is healed[slot][pname]


def test_continuous_redeploy_captures_fresh_lifetime(tmp_path):
    """``begin_redeploy(..., health=)``: the new bank comes with its own
    lifetime state and controller (the engine's health by default, none
    when ``health=None``)."""
    eng = _continuous(tmp_path, health_config_from_reference(_jhealth()))
    eng.check_health()
    old = eng.health
    params = eng.banks[0].params
    eng.begin_redeploy(params).join()
    eng.step()
    assert eng.health is not old and eng.health.rounds == 0
    assert all(lt.bank is eng.banks[eng.serving_epoch].cim[
        lt.name.split("/")[0]][lt.name.split("/")[1]]
        for lt in eng.lifetime.values())
    eng.begin_redeploy(params, health=None).join()
    eng.step()
    assert eng.health is None and eng.lifetime == {}
