"""The port's sharded circuit solve (``repro_torch.distributed``) against
its batched engine, the single-tile oracle and the reference's sharded
solve (``repro.distributed.solver_shard``), on the CPU.

The reference solves over the 8 host devices ``tests/conftest.py``
forces; the port over host meshes of 1, 2 and 8 shards
(``tile_mesh(n, device="cpu")``), which share the one CPU and so run in
turn.  Bounds are the reference's own (``tests/test_solver_shard.py``):
the sharded solve against the batched engine rtol 1e-12 (same
arithmetic, same per-tile trajectory), MIXED against the f64 engine
1e-6, against the Jacobi-CG oracle 1e-6; and ``tests/test_torch_solver.py``'s
against the reference's engine: currents rtol 1e-7, nf_total rtol 1e-3,
residual < 1e-9, ``unconverged`` equal.  ``mc_nf(ctx=)`` against its
per-sample oracle at rtol 1e-9 (``tests/test_nonideal.py``) and against
the unsharded ensemble at 1e-12.  ``logical_spec`` exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.compat import enable_x64, make_abstract_mesh
from repro.core.tiling import CrossbarSpec as JSpec
from repro.distributed import sharding as jsh
from repro.distributed import solver_shard as jss
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.crossbar import batched as tb
from repro_torch.crossbar import solver as ts
from repro_torch.distributed import (
    RULE_SETS,
    Mesh,
    ShardingCtx,
    logical_spec,
    measured_nf_sharded,
    tile_mesh,
    tile_sharding_ctx,
)
from repro_torch.distributed import solver_shard as tss
from repro_torch.nonideal import NonidealModel, mc_nf, mc_nf_oracle

CPU = "cpu"
SPEC, JSPEC = CrossbarSpec(16, 16, 8), JSpec(16, 16, 8)


def masks8(p=0.2):
    """The reference tests' masks (JAX uniforms), as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(42), 8)
    return np.stack([np.asarray(jax.random.uniform(k, (16, 16)) < p,
                                np.float32) for k in keys])


def host(n):
    return tile_sharding_ctx(n, device=CPU)


def sharded(m, n=8, **kw):
    return measured_nf_sharded(m, SPEC, ctx=host(n), device=CPU, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------ the mesh ----------------------------------

def test_simulated_device_count_and_tile_mesh():
    """The reference solves over conftest's 8 host devices; the port's
    host meshes take any shard count on the one CPU."""
    assert len(jax.local_devices()) == 8
    mesh = tile_mesh(8, device=CPU)
    assert mesh.shape == {"tiles": 8} and len(mesh.devices) == 8
    assert tile_mesh(device=CPU).shape == {"tiles": 1}
    assert tss._tile_axes(mesh, RULE_SETS["default"]) == \
        jss._tile_axes(jss.tile_mesh(8), jsh.RULE_SETS["default"])


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_mesh_without_a_card_raises(device):
    """A mesh that names a CUDA device where there is none raises: no
    fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tile_mesh(device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        measured_nf_sharded(masks8(), SPEC)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh(("tiles",), (1,), (torch.device(device),))


def test_mesh_shape_must_match_devices():
    with pytest.raises(ValueError, match="devices"):
        Mesh(("tiles",), (4,), (torch.device(CPU),) * 2)
    with pytest.raises(ValueError):
        Mesh(("a", "a"), (1, 1), (torch.device(CPU),))


MESHES = {"tiles8": ((8,), ("tiles",)), "data4": ((4,), ("data",)),
          "pod2_data4": ((2, 4), ("pod", "data")),
          "model8": ((8,), ("model",))}
DIMS = ["tiles", "batch", "heads", "embed"]


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dim", DIMS)
def test_logical_spec_matches_reference(mesh, dim, rules):
    """The same spec as the reference's on sizes that divide each axis
    product and sizes that do not, alone and beside a second dim that
    wants the same axes (the used-axis check), trailing Nones trimmed."""
    sizes, names = MESHES[mesh]
    jmesh = make_abstract_mesh(sizes, names)
    tmesh = Mesh(names, sizes, (torch.device(CPU),) * int(np.prod(sizes)))
    jr, tr = jsh.RULE_SETS[rules], RULE_SETS[rules]
    assert tr == jr
    for size in (1, 2, 3, 4, 6, 8, 12, 16, 56, 512, 4097):
        for shape, dims in (((size,), (dim,)),
                            ((size, 8), (dim, "tiles")),
                            ((16, size), ("batch", dim)),
                            ((size, 4), (dim, None)),
                            ((size, 16, 8), (dim, "mlp", dim))):
            want = tuple(jsh.logical_spec(shape, dims, jmesh, jr))
            assert logical_spec(shape, dims, tmesh, tr) == want, \
                (shape, dims)
    assert logical_spec((4,), (dim,), None, tr) == () == \
        tuple(jsh.logical_spec((4,), (dim,), None, jr))
    with pytest.raises(ValueError):
        logical_spec((4, 4), (dim,), tmesh, tr)


# ------------------------------ the solve ---------------------------------

def test_sharded_matches_jacobi_oracle():
    m = masks8()
    oracle = np.stack([ts.measured_nf(m[i], SPEC, device=CPU).currents
                       .numpy() for i in range(8)])
    res = sharded(m)
    np.testing.assert_allclose(res.currents.numpy(), oracle, rtol=1e-6)
    assert res.unconverged == 0
    assert float(res.residual.max()) < 1e-9


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_matches_reference(precision, n):
    """The port's sharded solve on n host shards against the reference's
    on its 8 host devices (the 8-way tile mesh, its default)."""
    m = masks8()
    want = jss.measured_nf_sharded(jnp.asarray(m), JSPEC,
                                   precision=precision)
    got = sharded(m, n, precision=precision)
    np.testing.assert_allclose(got.currents.numpy(), _np(want.currents),
                               rtol=1e-7)
    np.testing.assert_allclose(got.nf_total.numpy(), _np(want.nf_total),
                               rtol=1e-3)
    assert float(got.residual.max()) < 1e-9
    assert got.unconverged == int(want.unconverged) == 0
    if precision == "f64":
        assert got.iterations == int(want.iterations)


def test_sharded_mixed_tracks_f64_engine_tightly():
    m = masks8()
    f64 = tb.measured_nf_batched(m, SPEC, device=CPU)
    res = sharded(m, precision="mixed")
    err = ((res.currents - f64.currents).abs() / f64.currents.abs()).max()
    assert float(err) < 1e-6
    assert res.unconverged == 0


@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_f64_matches_batched_to_roundoff(n):
    """Same arithmetic, same preconditioner, same per-tile trajectory:
    sharding changes the currents by reduction-order roundoff at most
    (the NF fields, a cancellation-amplified |di|, by ~1e3 times more),
    and the worst shard's iterations are the batched loop's."""
    m = masks8()
    a = tb.measured_nf_batched(m, SPEC, device=CPU)
    b = sharded(m, n)
    for f in ("currents", "ideal"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   getattr(a, f).numpy(), rtol=1e-12,
                                   err_msg=f)
    assert b.iterations == a.iterations


def test_sharded_pads_non_divisible_batches():
    m = masks8()[:5]                       # 5 tiles on 8 shards
    full = tb.measured_nf_batched(m, SPEC, device=CPU)
    res = sharded(m)
    assert res.currents.shape == (5, 16) and res.nf_total.shape == (5,)
    np.testing.assert_allclose(res.currents.numpy(), full.currents.numpy(),
                               rtol=1e-12)
    assert res.unconverged == 0
    want = jss.measured_nf_sharded(jnp.asarray(m), JSPEC)
    np.testing.assert_allclose(res.currents.numpy(), _np(want.currents),
                               rtol=1e-7)
    assert res.iterations == int(want.iterations)


def test_sharded_preserves_leading_batch_dims():
    m = masks8().reshape(2, 4, 16, 16)
    res = sharded(m, 3)                    # 8 tiles padded to 9
    assert res.nf_total.shape == (2, 4) and res.residual.shape == (2, 4)
    assert res.currents.shape == (2, 4, 16)
    flat = tb.measured_nf_batched(m.reshape(8, 16, 16), SPEC, device=CPU)
    np.testing.assert_allclose(res.currents.reshape(8, 16).numpy(),
                               flat.currents.numpy(), rtol=1e-12)


def test_sharded_composes_with_sharding_ctx():
    """A caller's 2-shard tile mesh and the 8-shard one agree exactly, and
    a training mesh's data axes take the tiles."""
    m = masks8()
    a = sharded(m, 8)
    b = measured_nf_sharded(m, SPEC, ctx=ShardingCtx(
        mesh=tile_mesh(2, device=CPU)), device=CPU)
    np.testing.assert_allclose(a.currents.numpy(), b.currents.numpy(),
                               rtol=1e-12)
    train = Mesh(("pod", "data", "model"), (2, 2, 2),
                 (torch.device(CPU),) * 8)
    c = measured_nf_sharded(m[:7], SPEC, ctx=ShardingCtx(mesh=train),
                            device=CPU)
    np.testing.assert_allclose(c.currents.numpy(), a.currents[:7].numpy(),
                               rtol=1e-12)
    assert tss._tile_axes(train, RULE_SETS["default"]) == ("pod", "data")


@pytest.mark.parametrize("ctx", ["meshless", "model_only"])
def test_sharded_meshless_or_replicated_ctx_degrades(ctx):
    """ShardingCtx() takes the default mesh on ``device`` (one host
    shard), as the reference's; a mesh whose rules replicate "tiles"
    solves the batch as one shard: the batched engine's answer."""
    m = masks8()
    c = ShardingCtx() if ctx == "meshless" else ShardingCtx(mesh=Mesh(
        ("model",), (4,), (torch.device(CPU),) * 4))
    res = measured_nf_sharded(m, SPEC, ctx=c, device=CPU)
    full = tb.measured_nf_batched(m, SPEC, device=CPU)
    np.testing.assert_allclose(res.currents.numpy(), full.currents.numpy(),
                               rtol=1e-12)
    assert res.iterations == full.iterations and res.unconverged == 0


def test_sharded_early_exit_and_global_check():
    res = sharded(masks8())
    assert res.iterations < 100            # line preconditioner: ~5
    assert res.unconverged == 0


def test_unconverged_is_summed_over_shards_nan_aware():
    """Two starved shards (maxiter 1) and a NaN tile: every tile that
    missed tol or went non-finite is counted, across shards."""
    m = masks8()
    one = sharded(m, 4, maxiter=1)
    assert one.unconverged == int((one.residual > 1e-12).sum()) > 2
    assert one.iterations == 1
    g = np.where(m > 0, 1 / SPEC.r_on, 1 / SPEC.r_off)
    g[5, 2, 2] = np.nan
    res = tss.measured_nf_conductances_sharded(g, SPEC, ctx=host(4),
                                               device=CPU, maxiter=20)
    assert res.unconverged == 1 and res.iterations == 20


def test_assoc_chain_kernel_matches_lax():
    m = masks8()
    a = tb.measured_nf_batched(m, SPEC, chain_impl="lax", device=CPU)
    c = sharded(m, chain_impl="assoc")
    np.testing.assert_allclose(c.currents.numpy(), a.currents.numpy(),
                               rtol=1e-10)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_sharded_conductances_match_batched_and_reference(n):
    """One (T, J, K) clean reference under an (S, T, J, K) ensemble: each
    shard its slice of the repeated reference (whole repeats, a slice of
    one, or gathered across two), against the batched engine at 1e-12
    and the reference's sharded solve at its bounds."""
    rng = np.random.default_rng(5)
    m = masks8()[:3]
    g_ref = np.where(m > 0, 1 / SPEC.r_on, 1 / SPEC.r_off)
    g = g_ref * np.exp(0.1 * rng.standard_normal((2,) + m.shape))
    got = tss.measured_nf_conductances_sharded(g, SPEC, g_ref=g_ref,
                                               ctx=host(n), device=CPU)
    full = tb.measured_nf_conductances(g, SPEC, g_ref=g_ref, device=CPU)
    assert got.nf_total.shape == (2, 3)
    for f in ("currents", "ideal"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(full, f).numpy(), rtol=1e-12,
                                   err_msg=f)
    with enable_x64():
        want = jss.measured_nf_conductances_sharded(
            jnp.asarray(g), JSPEC, g_ref=jnp.asarray(g_ref))
    np.testing.assert_allclose(got.currents.numpy(), _np(want.currents),
                               rtol=1e-7)
    np.testing.assert_allclose(got.ideal.numpy(), _np(want.ideal),
                               rtol=1e-12)
    np.testing.assert_allclose(got.nf_total.numpy(), _np(want.nf_total),
                               rtol=1e-3)
    assert got.unconverged == int(want.unconverged) == 0


@pytest.mark.parametrize("ref_lead", [(), (3,), (1, 3), (2, 1), (1, 1)])
def test_sharded_clean_reference_layouts_match_batched(ref_lead):
    """A clean reference whose leading dims broadcast to the (2, 3)
    ensemble's (repeated along the tile axis, or not: (2, 1) gathers a
    shard's slice) on 4 shards, plain and checked (maxiter 1: every tile
    reruns up the ladder, its ideal currents read from its reference
    tile), against the batched engine, which broadcasts it, at 1e-12."""
    rng = np.random.default_rng(6)
    m = masks8()[:6].reshape(2, 3, 16, 16)
    g_ref = np.where(m > 0, 1 / SPEC.r_on, 1 / SPEC.r_off)
    g_ref = g_ref[tuple(slice(None) if n > 1 else slice(0, 1)
                        for n in (1,) * (2 - len(ref_lead)) + ref_lead)
                  ].reshape(ref_lead + (16, 16))
    g = np.broadcast_to(g_ref, m.shape) * np.exp(
        0.1 * rng.standard_normal(m.shape))
    for fn, kw in ((tss.measured_nf_conductances_sharded, {}),
                   (tss.measured_nf_conductances_sharded_checked,
                    dict(maxiter=1))):
        got = fn(g, SPEC, g_ref=g_ref, ctx=host(4), device=CPU, **kw)
        base = (tb.measured_nf_conductances if not kw else
                tb.measured_nf_conductances_checked)(
            g, SPEC, g_ref=g_ref, device=CPU, **kw)
        if kw:
            (got, rep), (base, brep) = got, base
            assert rep.escalations == brep.escalations >= 1
            assert rep.n_failed == brep.n_failed == got.unconverged
        for f in ("currents", "ideal"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(base, f).numpy(), rtol=1e-12,
                                       err_msg=f)
    with pytest.raises(ValueError, match="broadcast"):
        tss.measured_nf_conductances_sharded(g, SPEC, g_ref=g_ref[..., :8],
                                             ctx=host(4), device=CPU)


def test_checked_nan_and_zero_conductance_tiles_match_reference():
    """test_torch_solver's watchdog tiles (a NaN cell, an all-OFF and a
    severed tile) through the sharded checked solve on 2 host shards:
    the reference's verdicts, escalations and currents, ``unconverged``
    recounted after the escalation.  At maxiter 400 on both packages
    (the NaN tile spins to it, then twice it under Jacobi): the other
    tiles converge in a handful of iterations either way."""
    masks = (np.random.default_rng(4).random((3, 16, 16))
             < np.linspace(0.05, 0.8, 3)[:, None, None]).astype(np.float32)
    g = np.where(masks > 0, 1 / SPEC.r_on, 1 / SPEC.r_off)
    g[1, 3, 3] = np.nan
    g = np.concatenate([g, np.full((1, 16, 16), 1 / SPEC.r_off),
                        np.zeros((1, 16, 16))])
    res, rep = tss.measured_nf_conductances_sharded_checked(
        g, SPEC, ctx=host(2), device=CPU, maxiter=400)
    with enable_x64():
        jres, jrep = jss.measured_nf_conductances_sharded_checked(
            jnp.asarray(g), JSPEC, ctx=jss.tile_sharding_ctx(2),
            maxiter=400)
    np.testing.assert_array_equal(rep.converged.numpy(),
                                  _np(jrep.converged))
    assert rep.escalations == jrep.escalations >= 1
    assert rep.n_failed == int(jrep.n_failed) == 1
    assert res.unconverged == int(jres.unconverged) == 1
    conv = rep.converged.numpy()
    assert list(conv) == [True, False, True, True, True]
    assert np.isfinite(res.nf_total.numpy()[conv]).all()
    np.testing.assert_allclose(res.currents.numpy()[conv],
                               _np(jres.currents)[conv], rtol=1e-7,
                               atol=1e-30)
    quiet, qrep = tss.measured_nf_conductances_sharded_checked(
        g[:3], SPEC, ctx=host(2), device=CPU, escalate=False, maxiter=50)
    assert qrep.escalations == 0 and qrep.n_failed == quiet.unconverged == 1


# ------------------------------ mc_nf(ctx=) -------------------------------

MODELS = [dict(p_stuck_off=0.05, p_stuck_on=0.01),
          dict(sigma_program=0.15, sigma_read=0.02),
          dict(p_stuck_off=0.03, sigma_program=0.1, sigma_read=0.01,
               drift_nu=0.05, drift_time=100.0)]


@pytest.mark.parametrize("kw", MODELS)
def test_mc_nf_ctx_matches_oracle_and_unsharded(kw):
    """The ensemble solved over a 2-shard host mesh (3 samples x 3 tiles:
    each shard cuts across samples, the second padded) against the per-sample oracle at rtol
    1e-9 and the unsharded fused solve at 1e-12."""
    masks = (np.random.default_rng(2).random((3, 16, 16)) < 0.25
             ).astype(np.float32)
    model = NonidealModel(**kw)
    a = mc_nf(masks, SPEC, model, 3, 7, precision="f64", ctx=host(2),
              device=CPU)
    b = mc_nf_oracle(masks, SPEC, model, 3, 7, precision="f64", device=CPU)
    c = mc_nf(masks, SPEC, model, 3, 7, precision="f64", device=CPU)
    assert a.nf_total.shape == (3, 3) and a.report is not None
    np.testing.assert_allclose(a.nf_total.numpy(), b.nf_total, rtol=1e-9)
    np.testing.assert_allclose(a.weighted_err.numpy(), b.weighted_err,
                               rtol=1e-9)
    for f in ("nf_total", "weighted_err", "residual"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   getattr(c, f).numpy(), rtol=1e-12,
                                   err_msg=f)
    assert a.unconverged == b.unconverged == c.unconverged == 0


def test_mc_nf_ctx_on_another_device_raises(monkeypatch):
    """The ensemble is drawn on ``device`` and solved on the ctx's mesh:
    where they differ mc_nf refuses before drawing.  (The CPU has no
    second device, so ``device`` resolves here as given.)"""
    from repro_torch.nonideal import montecarlo

    monkeypatch.setattr(montecarlo, "resolve_device", torch.device)
    masks = np.ones((2, 16, 16), np.float32)
    with pytest.raises(ValueError, match="mesh solves on cpu"):
        mc_nf(masks, SPEC, NonidealModel(p_stuck_off=0.05), 2, 7,
              ctx=host(2), device="cuda:0")


# ------------------------------ multi-process -----------------------------

def _gloo_rank(rank: int, store: str, masks, out: str, axis: str) -> None:
    """One of two ranks, a host device a rank: over "tiles" the tile axis
    spans both; over "model" (replicated) rank 0 solves it all.  Every
    rank writes the whole population it got back."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        mesh = Mesh((axis,), (2,), (torch.device(CPU),), rank, 2)
        res = measured_nf_sharded(masks, SPEC, ctx=ShardingCtx(mesh=mesh),
                                  precision="mixed", device=CPU)
        torch.save(dict(res._asdict(), size=mesh.shape[axis]),
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("axis", ["tiles", "model"])
def test_two_gloo_ranks_match_single_process_two_shards(tmp_path, axis):
    """Two processes (gloo over a FileStore): each rank's whole
    population, iterations (MAX) and unconverged (SUM) equal the
    single-process solve's over the same axis (2 shards, or 1)."""
    m = masks8()[:7]                       # padded to 8 over the ranks
    mp.spawn(_gloo_rank,
             args=(str(tmp_path / "store"), m, str(tmp_path), axis),
             nprocs=2, join=True)
    want = measured_nf_sharded(m, SPEC, precision="mixed", device=CPU,
                               ctx=ShardingCtx(mesh=Mesh(
                                   (axis,), (2,), (torch.device(CPU),) * 2)))
    for rank in (0, 1):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["size"] == 2
        for f in ("currents", "ideal", "nf_cols", "nf_total", "residual"):
            np.testing.assert_allclose(got[f].numpy(),
                                       getattr(want, f).numpy(),
                                       rtol=1e-12, err_msg=f)
        assert got["iterations"] == want.iterations
        assert got["unconverged"] == want.unconverged == 0
