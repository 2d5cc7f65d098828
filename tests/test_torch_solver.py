"""The port's circuit solver (``repro_torch.crossbar``) against the
reference's (``repro.crossbar``) and the dense nodal oracle, on the CPU.

The port's ``"lax"`` chain route runs the line-preconditioner kernel's
plain version here (``kernels/line_solve/ref.py``); on the card the
kernel itself (``tests/test_torch_cuda.py``).  Bounds are the
reference's own (``tests/test_solver.py``, ``tests/test_solver_shard.py``,
``tests/test_robustness.py``): currents rtol 1e-7 against the dense
oracle and against the reference's engine under F64 and MIXED, nf_total
rtol 1e-3 (a cancellation-amplified |sum di|), residual < 1e-9.  Under
F32 (no f64 polish) the currents of two f32 CG runs differ by f32
rounding, so they are held at the reference's F32 bound, rtol 1e-3
(``test_f32_screening_mode_is_coarse_but_sane``), and nf_total, which
the ~1e3 cancellation of |sum di| amplifies that rounding into (2.1e-3
seen), at rtol 1e-2; the reference bounds no F32 nf_total.  F32 under
Jacobi stops at the coarse loop's 64-iteration stall guard short of its
1e-5 target on both sides, so two unconverged f32 iterates are compared:
currents at rtol 1e-2 (2.3e-3 seen; each is ~0.26 off the f64 answer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64, has_batched_tridiagonal_solve
from repro.core.tiling import CrossbarSpec as JSpec
from repro.crossbar import batched as jb
from repro.crossbar import solver as js
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.crossbar import batched as tb
from repro_torch.crossbar import solver as ts
from repro_torch.kernels.line_solve.ref import line_diagonals, line_solve_plain

CPU = "cpu"
SPEC, JSPEC = CrossbarSpec(16, 16, 8), JSpec(16, 16, 8)


def rand_mask(seed, j, k, p=0.2):
    """The reference tests' masks (JAX uniforms), as numpy."""
    return np.asarray((jax.random.uniform(jax.random.PRNGKey(seed), (j, k))
                       < p).astype(np.float32))


def mixed_density(seed, t, j, k):
    rng = np.random.default_rng(seed)
    p = np.linspace(0.05, 0.8, t)[:, None, None]
    return (rng.random((t, j, k)) < p).astype(np.float32)


def np_(x):
    """A result field (tensor or JAX array) as numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def oracle(m, spec=SPEC):
    return js.column_currents_dense(m, np.full(m.shape[0], spec.v_read),
                                    JSpec(*spec))


# ------------------------------ single tile -------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(8, 8), (12, 6), (16, 16)])
def test_cg_matches_dense_oracle(seed, shape):
    m = rand_mask(seed, *shape)
    res = ts.measured_nf(m, SPEC, device=CPU)
    dense = ts.column_currents_dense(m, np.full(shape[0], SPEC.v_read), SPEC)
    np.testing.assert_array_equal(dense, oracle(m))     # the same oracle
    np.testing.assert_allclose(res.currents.numpy(), dense, rtol=1e-7)
    assert float(res.residual) < 1e-9


@pytest.mark.parametrize("seed,shape", [(3, (8, 8)), (4, (12, 12)),
                                        (5, (16, 10))])
def test_single_tile_matches_reference(seed, shape):
    """The Jacobi CG with cg's stopping rule: the reference's answer."""
    m = rand_mask(seed, *shape, p=0.3)
    v = np.full(shape[0], SPEC.v_read)
    spec_arr = (SPEC.r, SPEC.r_on, SPEC.r_off)
    ref = js.measured_nf(jnp.asarray(m), JSPEC)
    res = ts.solve_crossbar(m, v, spec_arr, device=CPU)
    assert isinstance(res, ts.SolveResult)
    np.testing.assert_allclose(res.currents.numpy(), np_(ref.currents),
                               rtol=1e-7)
    np.testing.assert_allclose(res.ideal.numpy(), np_(ref.ideal), rtol=1e-12)
    np.testing.assert_allclose(float(res.nf_total), float(ref.nf_total),
                               rtol=1e-3)
    assert float(res.residual) < 1e-9


def test_zero_wire_resistance_limit_and_distance():
    m = rand_mask(3, 8, 8, 0.3)
    res = ts.measured_nf(m, CrossbarSpec(8, 8, 8, r=1e-6), device=CPU)
    np.testing.assert_allclose(res.currents.numpy(), res.ideal.numpy(),
                               rtol=1e-5)
    nfs = []
    for j, k in [(0, 0), (4, 4), (7, 7)]:
        one = np.zeros((8, 8), np.float32)
        one[j, k] = 1
        nfs.append(float(ts.measured_nf(one, SPEC, device=CPU).nf_total))
    assert nfs[0] < nfs[1] < nfs[2]


# ------------------------------ batched engine ----------------------------

@pytest.mark.parametrize("precision", ["f64", "mixed", "f32"])
@pytest.mark.parametrize("chain", ["lax", "assoc", "jacobi"])
@pytest.mark.parametrize("shape", [(16, 16), (32, 32), (24, 12)])
def test_batched_matches_reference(precision, chain, shape):
    J, K = shape
    masks = mixed_density(J + K, 6, J, K)
    ref = jb.measured_nf_batched(jnp.asarray(masks), JSpec(J, K, 8),
                                 precision=precision, chain_impl=chain)
    res = tb.measured_nf_batched(masks, CrossbarSpec(J, K, 8),
                                 precision=precision, chain_impl=chain,
                                 device=CPU)
    rtol = {"f64": 1e-7, "mixed": 1e-7,
            "f32": 1e-2 if chain == "jacobi" else 1e-3}[precision]
    np.testing.assert_allclose(res.currents.numpy(), np_(ref.currents),
                               rtol=rtol)
    np.testing.assert_allclose(res.nf_total.numpy(), np_(ref.nf_total),
                               rtol=1e-2 if precision == "f32" else 1e-3)
    if precision == "f64" and chain != "jacobi":
        assert res.iterations == int(ref.iterations)
    if precision != "f32":
        assert float(res.residual.max()) < 1e-9


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("shape", [(128, 128), (128, 10)])
def test_paper_crossbars_match_reference(shape, precision):
    """The paper's 128x128 crossbar and its 128x10 tile, 2 tiles at 20%
    density, against the reference's engine in x64 on JAX's CPU (its
    "lax" route where the batched tridiagonal solve lowers here, else
    "assoc"), at the reference's bounds."""
    J, K = shape
    rng = np.random.default_rng(J * K)
    masks = (rng.random((2, J, K)) < 0.2).astype(np.float32)
    chain = "lax" if has_batched_tridiagonal_solve() else "assoc"
    ref = jb.measured_nf_batched(jnp.asarray(masks), JSpec(J, K, 8),
                                 precision=precision, chain_impl=chain)
    res = tb.measured_nf_batched(masks, CrossbarSpec(J, K, 8),
                                 precision=precision, device=CPU)
    np.testing.assert_allclose(res.currents.numpy(), np_(ref.currents),
                               rtol=1e-7)
    np.testing.assert_allclose(res.nf_total.numpy(), np_(ref.nf_total),
                               rtol=1e-3)
    if precision == "f64" and chain == "lax":
        assert res.iterations == int(ref.iterations)
    assert float(res.residual.max()) < 1e-9


def test_batched_matches_dense_oracle_and_sequential():
    masks = mixed_density(13, 6, 12, 12)
    res = tb.measured_nf_batched(masks, SPEC, device=CPU)
    seq = ts.measured_nf_sequential(masks, SPEC, device=CPU)
    assert float(res.residual.max()) < 1e-9
    for i in range(6):
        np.testing.assert_allclose(res.currents[i].numpy(), oracle(masks[i]),
                                   rtol=1e-7)
    np.testing.assert_allclose(seq.currents.numpy(), res.currents.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(seq.nf_total.numpy(), res.nf_total.numpy(),
                               rtol=1e-3)


def test_measured_nf_routes_and_single_tile_precision():
    masks = mixed_density(17, 5, 16, 16)
    batched = ts.measured_nf(masks, SPEC, device=CPU)
    assert isinstance(batched, tb.BatchedSolveResult)
    single = ts.measured_nf(masks[1], SPEC, device=CPU)
    mixed = ts.measured_nf(masks[1], SPEC, precision="mixed", device=CPU)
    assert isinstance(mixed, ts.SolveResult) and mixed.nf_cols.shape == (16,)
    for a in (batched.currents[1], mixed.currents):
        np.testing.assert_allclose(a.numpy(), single.currents.numpy(),
                                   rtol=1e-6)


def test_batched_early_exit_and_batch_dims():
    masks = np.asarray((jax.random.uniform(jax.random.PRNGKey(19),
                                           (2, 3, 8, 8)) < 0.25)
                       .astype(np.float32))
    res = ts.measured_nf(masks, SPEC, device=CPU)
    ref = js.measured_nf(jnp.asarray(masks), JSPEC)
    assert res.nf_total.shape == (2, 3) and res.currents.shape == (2, 3, 8)
    assert res.iterations == int(ref.iterations) < 100
    assert float(res.residual.max()) < 1e-9
    np.testing.assert_allclose(res.currents.numpy(), np_(ref.currents),
                               rtol=1e-7)


@pytest.mark.parametrize("shape", [(8, 2), (2, 8), (1, 4), (8, 1)])
def test_batched_degenerate_geometries(shape):
    """Chains shorter than 3 take Jacobi on every route."""
    m = rand_mask(37, *shape, p=0.4)
    for chain in ("lax", "assoc"):
        res = tb.measured_nf_batched(m[None], SPEC, chain_impl=chain,
                                     device=CPU)
        np.testing.assert_allclose(res.currents[0].numpy(), oracle(m),
                                   rtol=1e-7)


def test_batched_per_tile_drive_voltages():
    m = np.stack([rand_mask(23, 8, 8, 0.3)] * 2)
    v = np.stack([np.full(8, SPEC.v_read), np.full(8, 2 * SPEC.v_read)])
    res = tb.measured_nf_batched(m, SPEC, v_in=v, device=CPU)
    ref = jb.measured_nf_batched(jnp.asarray(m), JSPEC, v_in=jnp.asarray(v))
    np.testing.assert_allclose(res.currents[1].numpy(),
                               2 * res.currents[0].numpy(), rtol=1e-7)
    np.testing.assert_allclose(res.currents.numpy(), np_(ref.currents),
                               rtol=1e-7)


def test_conductance_solve_broadcasts_reference():
    """One (T, J, K) clean reference under an (S, T, J, K) stack: the
    reference's answer, and the same as the broadcast reference."""
    rng = np.random.default_rng(5)
    masks = mixed_density(5, 3, 12, 12)
    g_ref = np.where(masks > 0, 1 / SPEC.r_on, 1 / SPEC.r_off)
    g = g_ref * np.exp(0.1 * rng.standard_normal((2,) + masks.shape))
    with enable_x64():
        want = jb.measured_nf_conductances(jnp.asarray(g), JSPEC,
                                           g_ref=jnp.asarray(g_ref))
    got = tb.measured_nf_conductances(g, SPEC, g_ref=g_ref, device=CPU)
    full = tb.measured_nf_conductances(g, SPEC, g_ref=np.broadcast_to(
        g_ref, g.shape).copy(), device=CPU)
    assert got.nf_total.shape == (2, 3)
    for a in (got, full):
        np.testing.assert_allclose(a.currents.numpy(), np_(want.currents),
                                   rtol=1e-7)
        np.testing.assert_allclose(a.ideal.numpy(), np_(want.ideal),
                                   rtol=1e-12)
        np.testing.assert_allclose(a.nf_total.numpy(), np_(want.nf_total),
                                   rtol=1e-3)


# -------------------------------- watchdog --------------------------------

def _same_report(a, b):
    np.testing.assert_array_equal(a.converged.numpy(), np_(b.converged))
    assert a.escalations == b.escalations
    assert a.n_failed == int(b.n_failed)


def test_watchdog_nan_and_zero_conductance_tiles_match_reference():
    """A NaN tile never converges (escalated, reported); an all-OFF and
    a fully severed (zero-conductance) tile: the reference's verdicts,
    and finite NF wherever a tile is reported converged."""
    masks = mixed_density(4, 3, 16, 16)
    g = np.where(masks > 0, 1 / SPEC.r_on, 1 / SPEC.r_off)
    g[1, 3, 3] = np.nan
    g = np.concatenate([g, np.full((1, 16, 16), 1 / SPEC.r_off),
                        np.zeros((1, 16, 16))])
    res, rep = tb.measured_nf_conductances_checked(g, SPEC, device=CPU)
    jres, jrep = jb.measured_nf_conductances_checked(jnp.asarray(g), JSPEC)
    _same_report(rep, jrep)
    conv = rep.converged.numpy()
    assert list(conv) == [True, False, True, True, True]
    assert rep.escalations >= 1 and rep.n_failed == 1
    assert np.isfinite(res.nf_total.numpy()[conv]).all()
    np.testing.assert_allclose(res.currents.numpy()[conv],
                               np_(jres.currents)[conv], rtol=1e-7,
                               atol=1e-30)


@pytest.mark.parametrize("case", ["mixed", "starved", "f32_stall",
                                  "zero_drive", "single"])
def test_watchdog_verdicts_match_reference(case):
    masks = mixed_density(6, 4, 16, 16)
    kw = {"mixed": dict(precision="mixed"),
          "starved": dict(maxiter=1, precision="f64", escalate=False),
          "f32_stall": dict(precision="f32"),
          "zero_drive": dict(v_in=np.zeros(16)),
          "single": {}}[case]
    if case == "single":
        masks = masks[1]
    jkw = dict(kw)
    if "v_in" in kw:
        jkw["v_in"] = jnp.asarray(kw["v_in"])
    res, rep = tb.measured_nf_batched_checked(masks, SPEC, device=CPU, **kw)
    jres, jrep = jb.measured_nf_batched_checked(jnp.asarray(masks), JSPEC,
                                                **jkw)
    _same_report(rep, jrep)
    assert rep.converged.shape == tuple(np.shape(jrep.converged))
    assert rep.all_converged == (case != "starved")
    if case == "f32_stall":
        assert rep.escalations >= 1
        f64, _ = tb.measured_nf_batched_checked(masks, SPEC, device=CPU)
        np.testing.assert_allclose(res.nf_total.numpy(),
                                   f64.nf_total.numpy(), rtol=1e-9)
    if case != "starved":
        np.testing.assert_allclose(res.currents.numpy(), np_(jres.currents),
                                   rtol=1e-7, atol=1e-30)
    if case == "single":
        r1, rep1 = ts.measured_nf_checked(masks, SPEC, device=CPU)
        assert isinstance(r1, ts.SolveResult) and rep1.converged.shape == ()


def test_resolve_precision():
    assert tb.resolve_precision(None) == tb.F64
    assert tb.resolve_precision("mixed") == tb.MIXED
    assert tb.resolve_precision("f32") == tb.F32
    assert tb.resolve_precision(tb.MIXED) is tb.MIXED
    assert tb.resolve_precision("float64") == tb.F64
    with pytest.raises(ValueError):
        tb.resolve_precision("bf16")
    assert len({tb.F64, tb.MIXED, tb.F32, tb.SolverPrecision()}) == 3
    assert tb.MIXED.dtype == torch.float32 and tb.F64.dtype == torch.float64
    for name in ("F64", "MIXED", "F32"):
        port, ref = getattr(tb, name), getattr(jb, name)
        assert (port.cg_dtype, port.coarse_tol, port.coarse_maxiter,
                port.polish, port.polish_maxiter) == (
            ref.cg_dtype, ref.coarse_tol, ref.coarse_maxiter, ref.polish,
            ref.polish_maxiter)
    with pytest.raises(ValueError, match="chain_impl"):
        tb.measured_nf_batched(rand_mask(0, 8, 8)[None], SPEC,
                               chain_impl="thomas", device=CPU)


# ---------------------------- the chain solve -----------------------------

def _dense_line_matrix(diag, cw):
    """M = blockdiag(wordline chains, bitline chains) of one tile as a
    dense (2 J K)^2 matrix (node (plane, j, k) at plane J K + j K + k)."""
    _, J, K = diag.shape
    JK = J * K
    M = torch.diag(diag.reshape(-1))
    for j in range(J):
        for k in range(K):
            if k > 0:
                M[j * K + k, j * K + k - 1] = M[j * K + k - 1, j * K + k] = -cw
            if j > 0:
                a, b = JK + j * K + k, JK + (j - 1) * K + k
                M[a, b] = M[b, a] = -cw
    return M


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 16, 16), (1, 20, 3)])
def test_plain_chain_solve_matches_dense_block_solve(dtype, tol, shape):
    rng = np.random.default_rng(sum(shape))
    g = torch.tensor(np.where(rng.random(shape) < 0.3, 1 / 300e3, 1 / 3e6),
                     dtype=dtype)
    g[0, 0, 0] = 0.0
    r = torch.tensor(rng.standard_normal((shape[0], 2) + shape[1:]),
                     dtype=dtype)
    z = line_solve_plain(g, r, 0.4)
    diag = line_diagonals(g, 0.4)
    for t in range(shape[0]):
        M = _dense_line_matrix(diag[t].double(), 0.4)
        want = torch.linalg.solve(M, r[t].double().reshape(-1))
        err = (z[t].double().reshape(-1) - want).abs().max()
        assert err <= tol * want.abs().max(), err


def test_stencil_matches_reference():
    rng = np.random.default_rng(1)
    g = np.where(rng.random((2, 6, 5)) < 0.4, 1 / 300e3, 1 / 3e6)
    x = rng.standard_normal((2, 2, 6, 5))
    got = ts._stencil_matvec(torch.tensor(g), 0.4, torch.tensor(x))
    with enable_x64():
        want = np.stack([np.asarray(js._stencil_matvec(
            jnp.asarray(g[t]), 0.4, jnp.asarray(x[t]))) for t in range(2)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-18)


def test_manhattan_hypothesis_correlation():
    """Measured NF correlates with the Eq-16 prediction (test-scale
    Fig 4), and the port's analytic NF is the reference's."""
    from repro.core import manhattan as jm
    from repro_torch.core import manhattan as tm

    keys = jax.random.split(jax.random.PRNGKey(7), 24)
    masks = np.stack([np.asarray((jax.random.uniform(k, (16, 16)) < 0.2)
                                 .astype(np.float32)) for k in keys])
    measured = ts.measured_nf(masks, SPEC, device=CPU).nf_total.numpy()
    predicted = tm.nonideality_factor(torch.tensor(masks), SPEC.r,
                                      SPEC.r_on).numpy()
    np.testing.assert_array_equal(predicted, np_(jm.nonideality_factor(
        jnp.asarray(masks), SPEC.r, SPEC.r_on)))
    assert np.corrcoef(measured, predicted)[0, 1] > 0.8
