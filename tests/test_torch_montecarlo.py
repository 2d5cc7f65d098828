"""The port's Monte-Carlo NF engine (``repro_torch.nonideal.montecarlo``),
its conductance models and ``calibrate_eta`` against the reference's, on
the CPU.

JAX's split keys cannot be reproduced in torch: the port draws sample s
from generators keyed by ``derive_key(key, s)``.  So the reference's
sampled cells cross over (``convert.cell_sample_from_reference``) and
give bit-identical conductances; the port's fused engine is held to its
own per-sample oracle at the reference's bound (rtol 1e-9,
``tests/test_nonideal.py``); solves of the reference's sampled
conductances to the reference's at rtol 1e-7 (currents) and 1e-3
(nf_total, weighted error: cancellation-amplified |di|).
``calibrate_eta``: the fit on the reference's masks to the reference's
least squares at rtol 1e-9, and the reference's own assertions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import noise as jnoise
from repro.core.tiling import CrossbarSpec as JSpec
from repro.crossbar.batched import measured_nf_conductances as j_solve
from repro.nonideal import models as jm
from repro.nonideal import montecarlo as jmc
from repro_torch.convert import cell_sample_from_reference
from repro_torch.core import noise as tnoise
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.crossbar import measured_nf_batched, \
    measured_nf_conductances_checked
from repro_torch.distributed import tile_sharding_ctx
from repro_torch.nonideal import models as tm
from repro_torch.nonideal import montecarlo as tmc

CPU = "cpu"
SPEC, JSPEC = CrossbarSpec(16, 16, 8), JSpec(16, 16, 8)
MODELS = [dict(p_stuck_off=0.05, p_stuck_on=0.01),
          dict(sigma_program=0.15, sigma_read=0.02),
          dict(p_stuck_off=0.03, sigma_program=0.1, sigma_read=0.01,
               drift_nu=0.05, drift_time=100.0)]
MORE = [dict(p_open_wordline=0.1, p_open_bitline=0.1, p_stuck_on=0.02,
             sigma_corr=0.1),
        dict(sigma_relax=0.1, drift_nu=0.02, drift_time=50.0,
             sigma_program=0.05)]


def rand_masks(seed, t=3, j=16, k=16, p=0.25):
    """The reference tests' masks (JAX uniforms), as numpy."""
    return np.asarray((jax.random.uniform(jax.random.PRNGKey(seed),
                                          (t, j, k)) < p).astype(np.float32))


@pytest.mark.parametrize("kw", MODELS + MORE)
@pytest.mark.parametrize("age", [None, 1e3])
def test_apply_to_conductances_bit_for_bit(kw, age):
    """The reference's sampled cells moved across: the same perturbed
    and clean conductance fields, bit for bit; with relaxation, whose
    factor exp(s * relax) is taken here, within 3e-7 (XLA's and torch's
    f32 exp differ by an ulp, 1.5e-7 of g seen)."""
    masks = rand_masks(1)
    sample = jm.sample_cell_state(jax.random.PRNGKey(3), masks.shape,
                                  jm.NonidealModel(**kw))
    want = jm.apply_to_conductances(jnp.asarray(masks), sample, JSPEC,
                                    jm.NonidealModel(**kw), age)
    port = cell_sample_from_reference(
        tuple(None if f is None else np.asarray(f) for f in sample), CPU)
    got = tm.apply_to_conductances(torch.tensor(masks), port, SPEC,
                                   tm.NonidealModel(**kw), age)
    assert got.dtype == torch.float32
    if "sigma_relax" in kw:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tm.conductances_from_masks(torch.tensor(masks), SPEC).numpy(),
        np.asarray(jm.conductances_from_masks(jnp.asarray(masks), JSPEC)))


@pytest.mark.parametrize("kw", MODELS)
def test_mc_engine_matches_per_sample_oracle(kw):
    """The fused (samples x tiles) solve against the per-sample loop:
    the same draws, the same NF to solver tolerance."""
    masks = rand_masks(2)
    model = tm.NonidealModel(**kw)
    a = tmc.mc_nf(masks, SPEC, model, 3, 7, precision="f64", device=CPU)
    b = tmc.mc_nf_oracle(masks, SPEC, model, 3, 7, precision="f64",
                         device=CPU)
    assert a.nf_total.shape == (3, 3) and a.report is not None
    np.testing.assert_allclose(a.nf_total.numpy(), b.nf_total, rtol=1e-9)
    np.testing.assert_allclose(a.weighted_err.numpy(), b.weighted_err,
                               rtol=1e-9)
    assert a.unconverged == 0 and b.unconverged == 0
    g, _ = tmc.mc_samples(7, torch.tensor(masks), SPEC, model, 3,
                          device=CPU)
    for s in range(3):                  # sample s: derive_key(key, s)
        one = tm.sample_cell_state(tm.derive_key(7, s), masks.shape, model,
                                   device=CPU)
        assert torch.equal(g[s], tm.apply_to_conductances(
            torch.tensor(masks), one, SPEC, model))


@pytest.mark.parametrize("kw", MODELS)
def test_solve_of_reference_samples_matches_reference(kw):
    """The reference's Monte-Carlo conductances (its own draws) solved by
    the port: the reference's currents, NF and weighted error."""
    masks = rand_masks(4)
    model = jm.NonidealModel(**kw)
    g, g_clean = jmc.mc_samples(jax.random.PRNGKey(5), jnp.asarray(masks),
                                JSPEC, model, 3)
    with enable_x64():
        want = j_solve(g, JSPEC, g_ref=g_clean, precision="mixed")
    res, rep = measured_nf_conductances_checked(
        torch.tensor(np.asarray(g)), SPEC, g_ref=torch.tensor(
            np.asarray(g_clean)), precision="mixed", device=CPU)
    assert rep.n_failed == 0 and res.nf_total.shape == (3, 3)
    np.testing.assert_allclose(res.currents.numpy(),
                               np.asarray(want.currents), rtol=1e-7)
    np.testing.assert_allclose(res.nf_total.numpy(),
                               np.asarray(want.nf_total), rtol=1e-3)
    w = np.linspace(1.0, 2.0, 16)
    np.testing.assert_allclose(
        tmc._weighted_err(res.currents, res.ideal, w).numpy(),
        np.asarray(jmc._weighted_err(want.currents, want.ideal, w)),
        rtol=1e-3)


def test_mc_ideal_model_is_degenerate():
    masks = rand_masks(5)
    res = tmc.mc_nf(masks, SPEC, tm.NonidealModel(), 3, 0, precision="f64",
                    device=CPU)
    nf = res.nf_total.numpy()
    assert float(np.std(nf, axis=0).max()) == 0.0
    clean = measured_nf_batched(masks, SPEC, device=CPU)
    # conductances_from_masks stores g in f32; the mask path builds f64.
    np.testing.assert_allclose(nf[0], clean.nf_total.numpy(), rtol=1e-6)


def test_mc_fixed_stuck_map_shared_across_samples():
    masks = rand_masks(6)
    stuck = tm.sample_stuck(1, masks.shape, 0.1, 0.0, device=CPU)
    model = tm.NonidealModel(p_stuck_off=0.5)  # rate ignored: map pinned
    a = tmc.mc_nf(masks, SPEC, model, 2, 0, stuck=stuck, precision="f64",
                  device=CPU)
    b = tmc.mc_nf_oracle(masks, SPEC, model, 2, 0, stuck=stuck,
                         precision="f64", device=CPU)
    np.testing.assert_allclose(a.nf_total.numpy(), b.nf_total, rtol=1e-9)
    assert float(a.nf_total.std(0).max()) == 0.0


def test_mc_per_tile_weights_and_summary_and_ctx():
    masks = rand_masks(7, t=4).reshape(2, 2, 16, 16)
    model = tm.NonidealModel(p_stuck_off=0.05, sigma_program=0.1)
    w = np.random.default_rng(0).random((2, 2, 16)) + 0.5
    a = tmc.mc_nf(masks, SPEC, model, 2, 3, col_weights=w, device=CPU)
    b = tmc.mc_nf_oracle(masks, SPEC, model, 2, 3, col_weights=w,
                         device=CPU)
    assert a.weighted_err.shape == (2, 2, 2)
    np.testing.assert_allclose(a.weighted_err.numpy(), b.weighted_err,
                               rtol=1e-9)
    assert tmc.summarize(a.nf_total) == jmc.summarize(a.nf_total.numpy())
    # Over a 3-shard host mesh (8 ensemble tiles padded to 9): the same
    # ensemble as the fused solve (tests/test_torch_solver_shard.py).
    c = tmc.mc_nf(masks, SPEC, model, 2, 3, col_weights=w, device=CPU,
                  ctx=tile_sharding_ctx(3, device=CPU))
    for f in ("nf_total", "weighted_err", "residual"):
        np.testing.assert_allclose(getattr(c, f).numpy(),
                                   getattr(a, f).numpy(), rtol=1e-12,
                                   err_msg=f)
    assert c.unconverged == a.unconverged == 0


# ------------------------------ calibrate_eta -----------------------------

def test_fit_eta_on_reference_masks_matches_reference():
    """The fit on the reference's masks (its calibrate_eta's draw) against
    the reference's least squares on its own f64 solve at rtol 1e-9, and
    against the reference's calibrate_eta at 1e-7: that one squares the
    f32 aggregate distances in f32 (6e-8 a square) and, outside x64,
    subtracts the f64 currents in f32 (4e-8 of eta); the port keeps both
    in f64."""
    from repro.core import manhattan as jman
    from repro.crossbar.batched import measured_nf_batched as j_batched

    spec, jspec = CrossbarSpec(32, 32, 8), JSpec(32, 32, 8)
    masks = np.asarray((jax.random.uniform(jax.random.PRNGKey(0),
                                           (6, 32, 32)) < 0.2)
                       .astype(np.float32))
    got = tnoise._fit_eta(torch.tensor(masks), spec, device=CPU)
    with enable_x64():
        res = j_batched(jnp.asarray(masks), jspec)
        measured = np.abs(np.asarray(res.currents - res.ideal)).sum(-1) \
            / (spec.v_read / spec.r_on)
    d = np.asarray(jman.aggregate_distance(jnp.asarray(masks)), np.float64)
    np.testing.assert_allclose(got, (measured * d).sum() / (d ** 2).sum(),
                               rtol=1e-9)
    np.testing.assert_allclose(got, jnoise.calibrate_eta(jspec, n_tiles=6),
                               rtol=1e-7)


def test_calibrate_eta_against_circuit_and_policies():
    """The reference's assertions: eta above the first-order r/R_on,
    below 2e-2, and the mixed policy within 1e-8 of f64."""
    spec = CrossbarSpec(32, 32, 8)
    eta64 = tnoise.calibrate_eta(spec, n_tiles=6, device=CPU)
    etamx = tnoise.calibrate_eta(spec, n_tiles=6, precision="mixed",
                                 device=CPU)
    assert 2.5 / 300e3 < eta64 < 2e-2
    assert abs(etamx - eta64) / eta64 < 1e-8
    assert tnoise.calibrate_eta(spec, 1, n_tiles=6, device=CPU) != eta64
