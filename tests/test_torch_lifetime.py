"""The port's lifetime state (``repro_torch.deploy.lifetime``, the
deploy's capture, the reprogram draw) against the reference (CPU).

- ``aged_gain_host`` over an age grid from the reference's logical cell
  fields: rtol 1e-6;
- the capture from the reference's cells: post-stuck codes, noise tags,
  ages and gains as the reference's lifetimes hold them;
- re-drawing instead of holding: a refresh at the deploy's age from the
  port's own draws rebuilds the deployed gain and fold bit for bit;
- the reprogram draw: a function of (key, index, n) with the stuck map
  pinned;
- ``restack_group``: one fold a refreshed member, bit-identical to the
  fold's plain version, nothing of the old stack mutated; recalibration
  refolds bit-identically;
- ``pad_host_deployment``: padded reads equal unpadded ones, read noise
  included (the port's noise is a function of (seed, tag, i, n)).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CimConfig as JCim
from repro.configs.base import ModelConfig as JModel
from repro.core.tiling import CrossbarSpec as JSpec
from repro.deploy import PlanCache as JPlanCache
from repro.deploy.engine import collect_model_matrices as j_collect
from repro.health import HealthConfig as JHealthConfig
from repro.models import model as jmodel
from repro.nonideal import NonidealModel as JNonideal
from repro.nonideal.inject import aged_gain_host as j_aged_gain
from repro.nonideal.inject import sample_deployment_cells as j_sample_cells
from repro.serve import ServeEngine as JServe
from repro_torch.configs import CimConfig, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.deploy import (
    DEMOTED_RUNTIME,
    deploy_model_params,
    group_key,
    pad_host_deployment,
    restack_group,
)
from repro_torch.deploy.lifetime import stack_deployments
from repro_torch.kernels.cim_mvm.ops import cim_mvm, cim_mvm_batched
from repro_torch.kernels.cim_mvm.ref import folded_weights
from repro_torch.nonideal import NonidealModel
from repro_torch.nonideal.inject import (
    aged_gain_host,
    matrix_stuck,
    reprogram_cells,
)

CPU = "cpu"
GAIN_RTOL = 1e-6
MODELS = {
    "aging": dict(drift_nu=0.1, sigma_relax=0.08, sigma_program=0.03),
    "faults": dict(p_stuck_off=0.02, p_stuck_on=0.01, sigma_program=0.05,
                   sigma_corr=0.05, drift_nu=0.05, drift_time=10.0,
                   sigma_relax=0.08),
    "read": dict(drift_nu=0.05, sigma_relax=0.05, sigma_read=0.02),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg() -> JModel:
    return JModel(
        name="cim-health-test", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=2, d_ff=64, vocab_size=128, block_pattern=("attn",),
        remat="none", dtype="float32", attn_chunk=32,
        cim=JCim(enabled=True, mode="mdm", rows=16, cols=16, n_bits=4))


def _tcfg(jcfg: JModel) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "cim"}
    return ModelConfig(**kw, cim=CimConfig(**dataclasses.asdict(jcfg.cim)))


def _setup(model_kw, seed=3):
    jcfg = _jcfg()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = _tcfg(jcfg)
    return jcfg, jp, tree, tcfg, params_from_numpy(tree, tcfg, CPU)


def _reference_cells(tree, jcfg, jm, key):
    mats, _ = j_collect(tree, jcfg, jcfg.cim.mode)
    spec = JSpec(jcfg.cim.rows, jcfg.cim.cols, jcfg.cim.n_bits)
    grids = {name: spec.grid(*w.shape) for name, w in mats.items()}
    return j_sample_cells(jax.random.PRNGKey(key), grids, spec, jm)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """name -> the reference's health-armed ``ServeEngine`` on that
    model (seed 3), deployed once for the module."""
    engines: dict = {}

    def get(name):
        if name not in engines:
            jcfg, jp, _, _, _ = _setup(MODELS[name])
            engines[name] = JServe(
                jcfg, jp, max_seq=64,
                plan_cache=JPlanCache(str(tmp_path_factory.mktemp(name))),
                nonideal=JNonideal(**MODELS[name]), nonideal_seed=3,
                health=JHealthConfig(n_probes=8))
        return engines[name]

    return get


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("age", [1.0, 10.0, 1e4, 1e8])
def test_aged_gain_matches_reference_over_ages(reference, name, age):
    """From one reference lifetime's logical fields: the port's
    ``aged_gain_host`` at ``age`` within rtol 1e-6 of the reference's."""
    jm, tm = JNonideal(**MODELS[name]), NonidealModel(**MODELS[name])
    lt = reference(name).lifetime["slot0_attn/ffn_w_up/1"]
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    want = j_aged_gain(lt.codes, lt.stuck_log, lt.gamma_log, lt.relax_log,
                       4, jm, age)
    got = aged_gain_host(t(lt.codes).to(torch.int32), t(lt.stuck_log),
                         t(lt.gamma_log), t(lt.relax_log), 4, tm, age)
    np.testing.assert_allclose(got.numpy(), want, rtol=GAIN_RTOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_capture_matches_reference_lifetimes(reference, name):
    """The port's capture from the reference's cells: every matrix's
    post-stuck codes (the bank's magnitudes), tag, age and gain as the
    reference's lifetime holds them; a gain and ``degraded`` always, a
    fold for every matrix."""
    jcfg, _, tree, tcfg, params = _setup(MODELS[name])
    jm, tm = JNonideal(**MODELS[name]), NonidealModel(**MODELS[name])
    jeng = reference(name)
    lifetime: dict = {}
    cim, _ = deploy_model_params(params, tcfg, device=CPU, nonideal=tm,
                                 nonideal_key=3,
                                 cells=_reference_cells(tree, jcfg, jm, 3),
                                 lifetime=lifetime)
    assert list(lifetime) == list(jeng.lifetime)
    for n, jlt in jeng.lifetime.items():
        lt = lifetime[n]
        slot, pname, r = n.split("/")
        assert lt.bank is cim[slot][pname] and lt.rep == (int(r),)
        assert (lt.noise_tag, lt.age, lt.key) == (jlt.noise_tag, jlt.age, 3)
        np.testing.assert_array_equal(lt.dep.codes.abs().numpy(), jlt.codes)
        np.testing.assert_allclose(lt.dep.gain.numpy(),
                                   np.asarray(jlt.dep.gain), rtol=GAIN_RTOL)
        assert int(lt.dep.degraded) == 0
        assert torch.equal(lt.dep.folded, folded_weights(lt.dep))
        assert torch.equal(lt.w, params[slot][pname][int(r)].reshape(
            lt.dep.in_dim, lt.dep.out_dim))


def _deployed(model_kw, seed=4):
    jcfg, _, _, tcfg, params = _setup(model_kw)
    lifetime: dict = {}
    cim, _ = deploy_model_params(params, tcfg, device=CPU,
                                 nonideal=NonidealModel(**model_kw),
                                 nonideal_key=seed, lifetime=lifetime)
    return cim, lifetime


@pytest.mark.parametrize("name", list(MODELS))
def test_refresh_redraws_the_deployed_state_bit_for_bit(name):
    """No cells are held: marking every matrix stale at the deploy's age
    and restacking draws the cells again and rebuilds every gain and fold
    bit for bit (one fold a member), in fresh tensors."""
    cim, lifetime = _deployed(MODELS[name])
    for lt in lifetime.values():
        lt.stale = True
    for slot, sub in cim.items():
        for pname, old in sub.items():
            gain, folded = old.gain.clone(), old.folded.clone()
            new = restack_group(lifetime, slot, pname)
            assert new is not old and new.codes is old.codes
            assert new.gain is not old.gain and new.folded is not old.folded
            assert torch.equal(new.gain, gain) and torch.equal(
                new.folded, folded)
            assert torch.equal(old.gain, gain)
            for lt in lifetime.values():
                if group_key(lt.name) == (slot, pname):
                    assert lt.bank is new and not lt.stale
                    assert lt.dep.folded.data_ptr() == \
                        new.folded[lt.rep].data_ptr()


def test_reprogram_draw_is_keyed_and_pins_the_stuck_map():
    m = NonidealModel(**MODELS["faults"])
    spec = CrossbarSpec(rows=16, cols=16, n_bits=4)
    stuck = matrix_stuck(3, 5, (2, 3), spec, m, CPU)
    a = reprogram_cells(3, 5, 1, (2, 3), spec, m, stuck, CPU)
    b = reprogram_cells(3, 5, 1, (2, 3), spec, m, stuck, CPU)
    c = reprogram_cells(3, 5, 2, (2, 3), spec, m, stuck, CPU)
    d = reprogram_cells(3, 6, 1, (2, 3), spec, m, stuck, CPU)
    assert a.stuck is stuck and torch.equal(a.gamma, b.gamma)
    assert torch.equal(a.relax, b.relax)
    for other in (c, d):
        assert not torch.equal(a.gamma, other.gamma)
        assert not torch.equal(a.relax, other.relax)
    ideal = NonidealModel(sigma_relax=0.1)
    e = reprogram_cells(3, 5, 1, (2, 3), spec, ideal, None, CPU)
    assert e.stuck is None and e.gamma is not None and e.relax is not None


def test_ladder_transitions_refold_bit_identically():
    """recalibrate, reprogram and demote through ``restack_group``: each
    refreshed member's fold equals the fold's plain version of its new
    gain; recalibration multiplies the aged gain exactly; a reprogram
    changes the draw; the demoted member is marked, the others shared."""
    cim, lifetime = _deployed(MODELS["faults"])
    group = [lt for lt in lifetime.values()
             if group_key(lt.name) == ("slot0_attn", "wo")]
    a, b = group
    before = a.dep.gain.clone()
    recal = np.linspace(0.8, 1.2, a.dep.out_dim).astype(np.float32)
    a.recalibrate(recal)
    assert a.stale and a.rung == 1
    new = restack_group(lifetime, "slot0_attn", "wo")
    full = torch.ones(a.dep.codes.shape[1])
    full[:recal.size] = torch.from_numpy(recal)
    assert torch.equal(a.dep.gain, before * full)
    assert torch.equal(a.dep.folded, folded_weights(a.dep))
    assert torch.equal(new.gain[b.rep], cim["slot0_attn"]["wo"].gain[b.rep])
    b.reprogram()
    assert (b.reprograms, b.age, b.rung) == (1, 1.0, 0)
    old_b = b.dep.gain.clone()
    new = restack_group(lifetime, "slot0_attn", "wo")
    assert not torch.equal(b.dep.gain, old_b)
    assert torch.equal(b.dep.folded, folded_weights(b.dep))
    a.demote()
    last = restack_group(lifetime, "slot0_attn", "wo")
    assert int(last.degraded[a.rep]) == DEMOTED_RUNTIME
    assert int(last.degraded[b.rep]) == 0 and last.folded is new.folded
    with pytest.raises(ValueError):
        a.bank = None
        restack_group(lifetime, "slot0_attn", "wo")


@pytest.mark.parametrize("noise", [False, True])
def test_pad_host_deployment_preserves_outputs(noise):
    """Zero-drive padding: the padded read of zero-padded inputs, sliced
    at the true out_dim, equals the unpadded read (with read noise too:
    the same noise on the original weights), through the batched form's
    plain version and cim_mvm alike."""
    kw = MODELS["read"] if noise else MODELS["aging"]
    _, lifetime = _deployed(kw)
    lt = lifetime["slot0_attn/ffn_w_down/0"]
    dep = lt.dep
    i0, n0 = dep.codes.shape
    padded = pad_host_deployment(dep, i0 + 32, n0 + 8, dep.in_dim + 32,
                                 dep.out_dim + 2, rows=16)
    assert padded.codes.shape == (i0 + 32, n0 + 8)
    assert torch.equal(padded.folded, folded_weights(padded))
    x = torch.from_numpy(np.random.RandomState(3).randn(
        4, dep.in_dim).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 32))
    seed = 11 if noise else None
    want = cim_mvm(x, dep, seed, device=CPU)
    got = cim_mvm(xp, padded, seed, device=CPU)[:, :dep.out_dim]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    st = stack_deployments([padded, padded])
    both = cim_mvm_batched(torch.stack([xp, xp]), st, seed, device=CPU)
    assert torch.equal(both[0], cim_mvm(xp, padded, seed, device=CPU))
    with pytest.raises(ValueError):
        pad_host_deployment(dep, i0 + 3, n0, dep.in_dim, dep.out_dim,
                            rows=16)


def test_unbanked_lifetime_refreshes_at_once():
    """A lifetime with no bank (hand-built, as the reference's tests build
    them) is refreshed the moment its state changes, into a deployment
    of its own with its fold; a banked one is only marked stale."""
    cim, lifetime = _deployed(MODELS["aging"])
    a, b = lifetime["slot0_attn/wo/0"], lifetime["slot0_attn/wo/1"]
    a.bank = None
    old = a.dep
    a.advance(1e4)
    b.advance(1e4)
    assert not a.stale and b.stale and a.dep is not old
    want = torch.empty_like(a.dep.gain)
    a.gain_into(want)
    assert torch.equal(a.dep.gain, want)
    assert not torch.equal(a.dep.gain, old.gain)
    assert torch.equal(a.dep.folded, folded_weights(a.dep))
    assert torch.equal(old.gain, cim["slot0_attn"]["wo"].gain[0])
    a.recalibrate(np.full(a.dep.out_dim, 1.5, np.float32))
    assert torch.equal(a.dep.gain, want * 1.5)
