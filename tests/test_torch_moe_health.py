"""Lifetime state and self-healing on MoE expert banks against the
reference (CPU).

SMOKE qwen2-moe-a2.7b (2 layers, 8 experts top-4) under ``mdm_expert``
on 16x16x4 crossbars, aging devices (``tests/test_torch_health.py``'s
``_AGING``) and the reference health test's configuration
(``_jhealth()``).  As in ``tests/test_torch_health.py`` the reference's
cells are taken across into the port's deploy and its lifetimes' cell
fields into the port's refreshes (``repro_torch.convert``).  Bounds:

- the capture: the reference's names, in its order (56, 48 experts);
- the nested restack (``restack_group`` on ``slot/pname/r/e{k}``):
  every member's gain, and its fold against the reference's W' * gain,
  rtol 1e-5 + atol 1e-6;
- an expert group's probe read (one batched call over the bank's flat
  view) within the same bound of the reference's vmapped read without
  read noise, and bit for bit the port's own per-member ``cim_mvm``
  with it;
- the escalation arc: the same (round, matrix, event) history and
  counters, ladder state, gains rtol 1e-6 and probe errors rtol 1e-4
  (``tests/test_torch_health.py::_held``) on ``ServeEngine`` against
  the reference's and on ``ContinuousEngine`` against the port's
  ``ServeEngine``; greedy tokens equal after the reprogram step.

After a health demotion the port serves an expert digitally (its
``degraded != 0``, the dense path's test); the reference's expert path
tests ``degraded > 0`` and reads it through ``cim_mvm``.  Both are
pinned here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.qwen2_moe_a27b import SMOKE as J_QWEN
from repro.core.tiling import CrossbarSpec as JSpec
from repro.deploy import PlanCache as JPlanCache
from repro.deploy import restack_group as j_restack
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.health import DetectorConfig as JDetectorConfig
from repro.health import HealthConfig as JHealthConfig
from repro.kernels.cim_mvm.ops import cim_mvm as j_cim_mvm
from repro.kernels.cim_mvm.xla import cim_effective_weights
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.nonideal import NonidealModel as JNonideal
from repro.nonideal.inject import sample_deployment_cells as j_sample_cells
from repro.serve import ServeEngine as JServe
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.convert import (
    health_config_from_reference,
    params_from_numpy,
    take_reference_draws,
)
from repro_torch.deploy import lifetime as tl
from repro_torch.deploy import (
    DEMOTED_RUNTIME,
    PlanCache,
    deploy_model_params,
    restack_group,
)
from repro_torch.health import HealthController
from repro_torch.health import controller as tcontroller
from repro_torch.kernels.cim_mvm.ops import cim_mvm
from repro_torch.kernels.cim_mvm.ref import cim_mvm_grouped_plain
from repro_torch.models import moe
from repro_torch.nonideal import NonidealModel
from repro_torch.serve import ContinuousEngine, ServeEngine

CPU = "cpu"
SEED = 3
READ_RTOL, READ_ATOL = 1e-5, 1e-6     # the reference's three-way bound
GAIN_RTOL = 1e-6
ERR_RTOL = 1e-4
_AGING = dict(drift_nu=0.1, sigma_relax=0.08, sigma_program=0.03)
EXPERTS = ("ffn_we_gate", "ffn_we_up", "ffn_we_down")
ARC = ((1e4, "recalibrations"), (1e8, "reprograms"),
       (1e4, "recalibrations"), (1e8, "demotions"))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's CPU ops on one intra-op thread beside jaxlib, as in
    ``tests/test_torch_health.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return J_QWEN.replace(dtype="float32", remat="none", cim=JCim(
        enabled=True, mode="mdm_expert", rows=16, cols=16, n_bits=4))


def _tcfg(jcfg) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


def _jhealth() -> JHealthConfig:
    """The reference health test's ``_health``."""
    return JHealthConfig(n_probes=8, max_reprograms=1,
                         detector=JDetectorConfig(warmup=3, z_trip=6.0,
                                                  z_clear=2.0))


def _tree(jcfg):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _reference_cells(tree, jcfg, jm):
    mats, _ = j_collect(tree, jcfg, jcfg.cim.mode)
    spec = JSpec(jcfg.cim.rows, jcfg.cim.cols, jcfg.cim.n_bits,
                 jcfg.cim.r, jcfg.cim.r_on, jcfg.cim.r_off)
    grids = {name: spec.grid(*w.shape) for name, w in mats.items()}
    return j_sample_cells(jax.random.PRNGKey(SEED), grids, spec, jm)


def _pair(tmp_path):
    """The reference's ``ServeEngine(health=)`` and the port's, the
    port's bank deployed from the reference's cells and its lifetimes
    reading the reference's draws."""
    jcfg = _jcfg()
    jp, tree = _tree(jcfg)
    jm, tm = JNonideal(**_AGING), NonidealModel(**_AGING)
    th = health_config_from_reference(_jhealth())
    tcfg = _tcfg(jcfg)
    tparams = params_from_numpy(tree, tcfg, CPU)
    jeng = JServe(jcfg, jp, max_seq=64,
                  plan_cache=JPlanCache(str(tmp_path / "j")), nonideal=jm,
                  nonideal_seed=SEED, health=_jhealth())
    teng = ServeEngine(tcfg, tparams, max_seq=64, plan_cache=False,
                       nonideal=tm, nonideal_seed=SEED, health=th,
                       device=CPU)
    lifetime: dict = {}
    teng.cim, _ = deploy_model_params(
        tparams, tcfg, device=CPU, nonideal=tm, nonideal_key=SEED,
        cells=_reference_cells(tree, jcfg, jm), lifetime=lifetime)
    take_reference_draws(lifetime, jeng.lifetime)
    teng.lifetime, teng.health = lifetime, HealthController(lifetime, th)
    return jeng, teng


def _held(jeng, teng, step: str) -> None:
    """``tests/test_torch_health.py::_held``: same counters, events and
    ladder state, gains within 1e-6, probe errors within 1e-4."""
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
                                   rtol=ERR_RTOL, err_msg=name)


def _layer(bank, r: int):
    """Repeat r of a reference stacked bank (numpy leaves)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[r], bank)


def test_capture_names_match_reference(tmp_path):
    """One lifetime a matrix, the reference's names in its order: 8
    attention projections and 48 experts at SMOKE, each expert at its
    (repeat, expert) of the bank with the reference's tag and age."""
    jeng, teng = _pair(tmp_path)
    assert list(teng.lifetime) == list(jeng.lifetime)
    assert len(teng.lifetime) == 56
    experts = [n for n in teng.lifetime if n.split("/")[1] in EXPERTS]
    assert len(experts) == 48
    for name, jlt in jeng.lifetime.items():
        lt = teng.lifetime[name]
        slot, pname, *idx = name.split("/")
        want = (int(idx[0]),) + tuple(int(e[1:]) for e in idx[1:])
        assert lt.rep == want and lt.bank is teng.cim[slot][pname]
        assert (lt.noise_tag, lt.age) == (jlt.noise_tag, jlt.age)
        np.testing.assert_array_equal(lt.dep.codes.abs().numpy(), jlt.codes)


def test_nested_restack_matches_reference(tmp_path):
    """Every member stale (an advance), two experts demoted: the port's
    restack of each expert group against the reference's, member by
    member; the old bank untouched, the codes shared, one fold a
    refreshed member, the demoted members' ``degraded`` the sentinel."""
    jeng, teng = _pair(tmp_path)
    for jlt in jeng.lifetime.values():
        jlt.advance(1e3)
        jlt.refresh()                  # the reference's controller does
    for lt in teng.lifetime.values():
        lt.advance(1e3)                # marks it stale
    for name in ("slot0_attn/ffn_we_up/1/e3", "slot0_attn/ffn_we_up/0/e0"):
        jeng.lifetime[name].demote()
        teng.lifetime[name].demote()
    folds = []
    real_fold = tl.fold_weights

    def count(dep):
        folds.append(dep)
        return real_fold(dep)

    tl.fold_weights = count
    try:
        for pname in EXPERTS:
            old = teng.cim["slot0_attn"][pname]
            gain0 = old.gain.clone()
            new = restack_group(teng.lifetime, "slot0_attn", pname)
            jnew = j_restack(jeng.lifetime, "slot0_attn", pname)
            assert torch.equal(old.gain, gain0) and new.codes is old.codes
            assert new.gain.shape == (2, 8) + old.gain.shape[2:]
            for r in range(2):
                jl = _layer(jnew, r)
                for e in range(8):
                    name = f"slot0_attn/{pname}/{r}/e{e}"
                    lt = teng.lifetime[name]
                    assert lt.bank is new and lt.dep is new.member((r, e))
                    if lt.demoted:
                        assert int(new.degraded[r, e]) == DEMOTED_RUNTIME
                        continue
                    assert int(new.degraded[r, e]) == 0
                    jd = jax.tree_util.tree_map(lambda a: a[e], jl)
                    np.testing.assert_allclose(
                        new.gain[r, e].numpy(), np.asarray(jd.gain),
                        rtol=READ_RTOL, atol=READ_ATOL, err_msg=name)
                    w = np.asarray(cim_effective_weights(
                        jd.codes, jd.pos, jd.scale, n_bits=jd.n_bits,
                        wpt=jd.wpt, cols=jd.cols, eta=jd.eta,
                        reversed_df=jd.reversed_df,
                        col_pos=jd.col_pos)) * np.asarray(jd.gain)
                    n_pad = w.shape[1]
                    np.testing.assert_allclose(
                        new.folded[r, e, :, :n_pad].numpy(), w,
                        rtol=READ_RTOL, atol=READ_ATOL, err_msg=name)
    finally:
        tl.fold_weights = real_fold
    assert len(folds) == 3 * 16 - 2      # the two demoted experts


def test_mixed_layout_group_raises(tmp_path):
    """A group whose members mix the dense and the expert layout (or
    point into another bank) is refused."""
    _, teng = _pair(tmp_path)
    lts = teng.lifetime
    lt = lts["slot0_attn/ffn_we_gate/0/e1"]
    lts["slot0_attn/ffn_we_gate/0"] = dataclasses.replace(
        lt, name="slot0_attn/ffn_we_gate/0", rep=(0,))
    with pytest.raises(ValueError, match="one served stacked deployment"):
        restack_group(lts, "slot0_attn", "ffn_we_gate")


def _count_reads(monkeypatch):
    calls = {"batched": 0, "single": 0}

    def wrap(kind, fn):
        def inner(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return inner

    monkeypatch.setattr(tcontroller, "cim_mvm_batched",
                        wrap("batched", tcontroller.cim_mvm_batched))
    monkeypatch.setattr(tcontroller, "cim_mvm",
                        wrap("single", tcontroller.cim_mvm))
    return calls


def test_expert_group_probe_reads_match_reference(tmp_path, monkeypatch):
    """A probe round is 7 batched calls (4 attention groups, 3 expert
    groups of 16 members through the bank's flat view), every member
    within the three-way bound of the reference's vmapped read; the
    members read in place, member r * E + e of the flat view."""
    jeng, teng = _pair(tmp_path)
    live = list(teng.lifetime.items())
    jres = jeng.health._probe_reads(list(jeng.lifetime.items()), None)
    calls = _count_reads(monkeypatch)
    tres = teng.health._probe_reads(live, None)
    assert calls == {"batched": 7, "single": 0}
    for name, y in tres.items():
        np.testing.assert_allclose(y, jres[name], rtol=READ_RTOL,
                                   atol=READ_ATOL, err_msg=name)
    bank = teng.cim["slot0_attn"]["ffn_we_down"]
    flat = bank.flat()
    assert flat.folded.data_ptr() == bank.folded.data_ptr()
    assert flat.codes.shape[0] == 16
    lt = teng.lifetime["slot0_attn/ffn_we_down/1/e5"]
    assert lt.flat_index == 13
    assert torch.equal(flat.layer(13).folded, lt.dep.folded)


def test_expert_group_noisy_probe_reads_bit_for_bit(tmp_path):
    """With read noise, each expert group's one batched read equals the
    port's own ``cim_mvm`` of every member (its noise tag, the round's
    seed) bit for bit; demoted members are left out of the read."""
    jcfg = _jcfg()
    _, tree = _tree(jcfg)
    tcfg = _tcfg(jcfg)
    eng = ServeEngine(tcfg, params_from_numpy(tree, tcfg, CPU), max_seq=64,
                      plan_cache=False,
                      nonideal=NonidealModel(**_AGING, sigma_read=0.02),
                      nonideal_seed=SEED,
                      health=health_config_from_reference(_jhealth()),
                      device=CPU)
    eng.lifetime["slot0_attn/ffn_we_gate/1/e2"].demote()
    eng._swap({("slot0_attn", "ffn_we_gate")})
    live = [(n, lt) for n, lt in eng.lifetime.items() if not lt.demoted]
    res = eng.health._probe_reads(live, 1234)
    assert len(res) == 55
    for name, lt in live:
        probes = eng.health.monitors[name].probes_dev
        want = cim_mvm(probes, lt.dep, 1234, device=CPU).numpy()
        np.testing.assert_array_equal(res[name], want, err_msg=name)
    clean = eng.health._probe_reads(live, None)
    assert not np.array_equal(clean[live[-1][0]], res[live[-1][0]])


def test_escalation_arc_matches_reference(tmp_path):
    """The reference test's arc on ``ServeEngine`` in lockstep with the
    reference's: four warm-up rounds (no trips), then advance 1e4 ->
    every matrix recalibrated, 1e8 -> reprogrammed (clock reset), 1e4 ->
    recalibrated, 1e8 -> demoted; every step held.  Greedy tokens equal
    the reference's after the reprogram step."""
    jeng, teng = _pair(tmp_path)
    n = len(teng.lifetime)
    for r in range(4):
        jeng.check_health()
        teng.check_health()
        _held(jeng, teng, f"warm-up {r}")
    assert teng.health_report.counters["trips"] == 0
    p = np.random.default_rng(1).integers(0, 256, (2, 8))
    for dt, want in ARC:
        jeng.advance(dt)
        teng.advance(dt)
        _held(jeng, teng, f"advance {dt}")
        jeng.check_health()
        rep = teng.check_health()
        _held(jeng, teng, f"round after {dt}")
        assert rep.counters[want] >= n
        if want == "reprograms":
            out = teng.generate(torch.from_numpy(p), 3).numpy()
            np.testing.assert_array_equal(
                out, np.asarray(jeng.generate(jnp.asarray(p, jnp.int32), 3)))
    assert all(m["demoted"] for m in rep.matrices.values())
    assert rep.flaps == 0
    for pname in EXPERTS:
        assert (teng.cim["slot0_attn"][pname].degraded
                == DEMOTED_RUNTIME).all()


def _port_engine(cls, tmp_path, model=_AGING, **kw):
    jcfg = _jcfg()
    _, tree = _tree(jcfg)
    tcfg = _tcfg(jcfg)
    return cls(tcfg, params_from_numpy(tree, tcfg, CPU), max_seq=64,
               plan_cache=PlanCache(str(tmp_path)),
               nonideal=NonidealModel(**model), nonideal_seed=SEED,
               health=health_config_from_reference(_jhealth()), device=CPU,
               **kw)


def test_continuous_arc_matches_serve_engine(tmp_path):
    """The arc on ``ContinuousEngine`` against the port's
    ``ServeEngine`` with the same seed: identical histories, counters
    and ladder state, probe errors within 1e-4, every heal landed as an
    epoch."""
    seng = _port_engine(ServeEngine, tmp_path / "s")
    ceng = _port_engine(ContinuousEngine, tmp_path / "c", capacity=2,
                        max_prompt=16)
    steps = [0] * 4 + [dt for dt, _ in ARC]
    for dt in steps:
        for e in (seng, ceng):
            if dt:
                e.advance(dt)
            e.check_health()
        _held(seng, ceng, f"step {dt}")
    assert ceng.health_report.counters["demotions"] == len(ceng.lifetime)
    assert ceng.serving_epoch > 0 and list(ceng.banks) == [
        ceng.serving_epoch]


def _disp(n_rows: int, E: int, seed: int = 4):
    """A dispatch of ``n_rows`` assignments over E experts, a few
    dropped (cap 3)."""
    rng = np.random.default_rng(seed)
    e = torch.from_numpy(np.sort(rng.integers(0, E, n_rows)))
    counts = torch.bincount(e, minlength=E)
    start = torch.cumsum(counts, 0) - counts
    r = torch.arange(n_rows) - start[e]
    keep = r < 3
    return moe._dispatch(e, r, keep, torch.clamp(counts, max=3), 3)


def test_demoted_experts_served_digitally(tmp_path):
    """After the ladder demotes two experts of a bank, the port serves
    their rows as f32 ``x @ w`` exactly and reads every other kept row
    through the grouped form, which is handed no row of a demoted
    expert."""
    eng = _port_engine(ServeEngine, tmp_path)
    for name in ("slot0_attn/ffn_we_up/1/e2", "slot0_attn/ffn_we_up/1/e6"):
        eng.lifetime[name].demote()
    eng._swap({("slot0_attn", "ffn_we_up")})
    dep = eng.cim["slot0_attn"]["ffn_we_up"].layer(1)
    assert dep.degraded.tolist() == [0, 0, -1, 0, 0, 0, -1, 0]
    w = eng.params["slot0_attn"]["ffn_we_up"][1]
    disp = _disp(40, 8)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (40, w.shape[1])).astype(np.float32))
    seen = []

    def grouped(xc, d, offsets, cap, seed):
        seen.append(offsets.tolist())
        return cim_mvm_grouped_plain(xc, d, offsets, cap, seed)

    y = moe._expert_mm(x, w, dep, disp, grouped)
    off = seen[0]
    assert off[3] == off[2] and off[7] == off[6]      # no demoted rows
    for e in range(8):
        rows = (disp.keep & (disp.e == e)).nonzero().reshape(-1)
        if e in (2, 6):
            torch.testing.assert_close(y[rows], (x @ w[e])[rows], rtol=0,
                                       atol=0)
        else:
            want = cim_mvm(x[rows], dep.layer(e), device=CPU)
            torch.testing.assert_close(y[rows], want, rtol=0, atol=0)
    assert not disp.keep.all() and (y[~disp.keep] == 0).all()


def test_reference_reads_health_demoted_expert_on_crossbar(tmp_path):
    """The reference's quirk, pinned: its expert path demotes on
    ``degraded > 0`` (src/repro/models/moe.py:55), so an expert the
    health ladder demoted (-1) is still read through ``cim_mvm`` at its
    last gain, where the port reads ``x @ w``."""
    jeng, _ = _pair(tmp_path)
    name = "slot0_attn/ffn_we_up/1/e2"
    jeng.lifetime[name].demote()
    jeng._swap({("slot0_attn", "ffn_we_up")})
    bank = _layer(jeng.cim["slot0_attn"]["ffn_we_up"], 1)
    assert int(bank.degraded[2]) == DEMOTED_RUNTIME
    w = np.asarray(jeng.params["slot0_attn"]["ffn_we_up"][1])
    xe = np.random.default_rng(6).standard_normal(
        (8, 4, w.shape[1])).astype(np.float32)
    y = np.asarray(jmoe._expert_mm(jnp.asarray(xe), jnp.asarray(w),
                                   jax.tree_util.tree_map(jnp.asarray, bank),
                                   0))
    d2 = jax.tree_util.tree_map(lambda a: a[2], bank)
    np.testing.assert_allclose(y[2], np.asarray(j_cim_mvm(xe[2], d2)),
                               rtol=READ_RTOL, atol=READ_ATOL)
    assert not np.allclose(y[2], xe[2] @ w[2], rtol=1e-4, atol=1e-5)


def test_continuous_heal_swap_mid_load_keeps_in_flight_sequences(tmp_path):
    """An aging restack under load on MoE: every group (4 attention, 3
    expert) lands as an epoch, the sequences in flight keep their
    admission bank bit for bit, the pinned bank is dropped when they
    finish and every lifetime points into the healed bank."""
    prompts = np.random.default_rng(9).integers(0, 256, (2, 8))

    def fly(eng):
        rids = [eng.submit(prompts[i], max_tokens=5, temperature=0.5 * i,
                           seed=60 + i) for i in range(2)]
        eng.step()
        return rids

    kw = dict(capacity=2, max_prompt=16)
    ref = _port_engine(ContinuousEngine, tmp_path / "a", **kw)
    ref_out = [ref.run()[r] for r in fly(ref)]
    eng = _port_engine(ContinuousEngine, tmp_path / "b", **kw)
    rids = fly(eng)
    eng.advance(10.0)
    assert eng.serving_epoch == 7 and sorted(eng.banks) == [0, 7]
    eng.run()
    assert [eng.results[r] for r in rids] == ref_out
    assert list(eng.banks) == [7]
    healed = eng.banks[7].cim
    for lt in eng.lifetime.values():
        slot, pname = lt.name.split("/")[:2]
        assert lt.bank is healed[slot][pname]
        assert lt.dep is healed[slot][pname].member(lt.rep)
