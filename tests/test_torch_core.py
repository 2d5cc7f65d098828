"""Parity of the port's quantise -> tile -> plan -> package chain with the
JAX reference: every integer and every plan field bit-identical.

Inputs are made from a seed with numpy and fed to both packages.  The
reference's planner runs through its own XLA path; the port's through
the plain version of its ``manhattan_score`` kernel (CPU tensors).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import manhattan as jman
from repro.core.bitslice import codes_to_bits as j_codes_to_bits
from repro.core.bitslice import magnitude_scale as j_scale
from repro.core.bitslice import quantize_magnitude as j_quantize
from repro.core.mdm import plan_layer as j_plan_layer
from repro.core.tiling import CrossbarSpec as JSpec
from repro.core.tiling import tile_masks as j_tile_masks
from repro.kernels.cim_mvm.ops import deploy as j_deploy
from repro_torch.core import manhattan as tman
from repro_torch.core.bitslice import codes_to_bits, magnitude_scale
from repro_torch.core.bitslice import quantize_magnitude
from repro_torch.core.mdm import MODES, placed_masks, plan_layer
from repro_torch.core.tiling import CrossbarSpec, tile_masks, untile_masks
from repro_torch.deploy import plan_matrix, quantize_codes_host
from repro_torch.kernels.cim_mvm.ops import deploy

SPECS = {"16x16x8": (16, 16, 8), "64x64x8": (64, 64, 8),
         "16x16x4": (16, 16, 4), "32x32x4": (32, 32, 4)}


def _w(shape, seed, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def assert_same(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes() or np.array_equal(a, b), what


@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("shape,seed", [((48, 6), 0), ((70, 13), 1),
                                         ((100, 23), 2)])
def test_quantise_and_tile_bit_identical(shape, seed, n_bits):
    w = _w(shape, seed) * (10.0 ** (seed - 1))
    s_j = np.float32(np.asarray(j_scale(jnp.asarray(w), n_bits)))
    s_t = magnitude_scale(torch.from_numpy(w), n_bits)
    assert s_j.tobytes() == _np(s_t).astype(np.float32).tobytes()
    c_j, sg_j, _ = j_quantize(jnp.asarray(w), n_bits)
    c_t, sg_t, _ = quantize_magnitude(torch.from_numpy(w), n_bits)
    assert_same(np.asarray(c_j).astype(np.int64), _np(c_t).astype(np.int64))
    assert_same(sg_j, sg_t)
    assert_same(quantize_codes_host(w, s_j, n_bits).astype(np.int64),
                _np(c_t).astype(np.int64))
    rows = 16 if n_bits == 8 else 32
    js, ts = JSpec(rows, rows, n_bits), CrossbarSpec(rows, rows, n_bits)
    bits_j = j_codes_to_bits(c_j, n_bits)
    bits_t = codes_to_bits(c_t, n_bits)
    assert_same(bits_j, bits_t)
    m_t = tile_masks(bits_t, ts)
    assert_same(j_tile_masks(bits_j, js), m_t)
    assert_same(untile_masks(m_t, *shape, ts), bits_t)


@pytest.mark.parametrize("jk", [(16, 16), (64, 64), (128, 10), (4, 1024)])
@pytest.mark.parametrize("seed", [0, 11])
def test_row_order_matches_reference(jk, seed):
    m = (np.random.default_rng(seed).random(jk) < 0.25).astype(np.float32)
    got = tman.optimal_row_order(torch.from_numpy(m))
    assert_same(np.asarray(jman.optimal_row_order(jnp.asarray(m))),
                _np(got).astype(np.int32))


def test_row_order_wide_tile_lexsort_branch():
    """K = 4096 overflows the packed int32 key: the two-stable-sort
    branch must order equal-count rows by score, as the reference's
    lexsort does."""
    J, K = 4, 4096
    m = np.zeros((J, K), np.float32)
    m[0, :4000] = 1
    m[1, 10:4010] = 1
    m[2, :] = 1
    got = _np(tman.optimal_row_order(torch.from_numpy(m))).tolist()
    assert got == [2, 1, 0, 3]
    assert got == np.asarray(jman.optimal_row_order(jnp.asarray(m))).tolist()
    rng = np.random.default_rng(5)
    m = (rng.random((6, 2048)) < 0.5).astype(np.float32)
    m[3] = m[1]                       # a tie in count and score
    assert_same(np.asarray(jman.optimal_row_order(jnp.asarray(m))),
                _np(tman.optimal_row_order(torch.from_numpy(m))).astype(
                    np.int32))


def test_row_order_ties_break_by_index():
    m = np.zeros((4, 8), np.float32)
    m[1, 2] = 1
    m[3, 2] = 1
    got = _np(tman.optimal_row_order(torch.from_numpy(m))).tolist()
    assert got == [1, 3, 0, 2]
    assert got == np.asarray(jman.optimal_row_order(jnp.asarray(m))).tolist()


def test_manhattan_reductions_match_reference():
    m = (np.random.default_rng(3).random((5, 16, 24)) < 0.3).astype(
        np.float32)
    for fj, ft in ((jman.row_scores, tman.row_scores),
                   (jman.row_counts, tman.row_counts),
                   (jman.aggregate_distance, tman.aggregate_distance)):
        assert_same(fj(jnp.asarray(m)), ft(torch.from_numpy(m)))
    assert_same(jman.nonideality_factor(jnp.asarray(m), 2.5, 300e3),
                tman.nonideality_factor(torch.from_numpy(m), 2.5, 300e3))


def _assert_plans_equal(pj, pt):
    for f in ("row_perm", "row_position", "nf_before", "nf_after", "scale"):
        assert_same(getattr(pj, f), getattr(pt, f), f)
    assert bool(pj.reversed_dataflow) == pt.reversed_dataflow


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,spec,seed,scale", [
    ((256, 64), "64x64x8", 0, 0.05),     # test_manhattan bell-shaped
    ((128, 16), "64x64x8", 4, 0.1),
    ((48, 6), "16x16x8", 0, 0.1),        # test_mdm_semantics shapes
    ((70, 9), "16x16x8", 11, 0.1),
    ((130, 21), "16x16x8", 7, 0.2),
    ((33, 7), "32x32x4", 3, 0.5),
    ((48, 40), "16x16x4", 6, 0.3),       # the serving tests' spec
])
def test_plans_bit_identical(mode, shape, spec, seed, scale):
    w = _w(shape, seed, scale)
    pj = j_plan_layer(jnp.asarray(w), JSpec(*SPECS[spec]), mode)
    pt = plan_layer(torch.from_numpy(w), CrossbarSpec(*SPECS[spec]), mode)
    _assert_plans_equal(pj, pt)


@pytest.mark.parametrize("mode", MODES)
def test_placed_masks_match_reference(mode):
    from repro.core.bitslice import bitslice as j_bitslice
    from repro.core.mdm import placed_masks as j_placed
    from repro.core.mdm import plan_from_bits as j_plan_bits
    from repro_torch.core.bitslice import bitslice

    w = _w((48, 6), 0, 0.1)
    sj = j_bitslice(jnp.asarray(w), 8)
    pj = j_plan_bits(sj.bits, sj.scale, JSpec(16, 16, 8), mode)
    st = bitslice(torch.from_numpy(w), 8)
    pt = plan_layer(torch.from_numpy(w), CrossbarSpec(16, 16, 8), mode)
    assert_same(j_placed(sj.bits, pj, JSpec(16, 16, 8)),
                placed_masks(st.bits, pt, CrossbarSpec(16, 16, 8)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,spec", [((70, 13), "16x16x8"),
                                        ((33, 7), "32x32x4"),
                                        ((130, 96), "64x64x8")])
def test_deploy_codes_and_pos_bit_identical(mode, shape, spec):
    w = _w(shape, sum(shape))
    dj, pj = j_deploy(jnp.asarray(w), JSpec(*SPECS[spec]), mode, eta=2e-3)
    dt, pt = deploy(torch.from_numpy(w), CrossbarSpec(*SPECS[spec]), mode,
                    eta=2e-3)
    _assert_plans_equal(pj, pt)
    for f in ("codes", "pos", "scale"):
        assert_same(getattr(dj, f), getattr(dt, f), f)
    for f in ("n_bits", "wpt", "cols", "eta", "reversed_df", "in_dim",
              "out_dim"):
        assert getattr(dj, f) == getattr(dt, f), f


def test_per_matrix_chunks_match_fused_reference_planner():
    """Planning one matrix per chunk (the port's deploy) equals the
    reference's fused whole-population planner, codes included."""
    from repro.deploy import plan_matrices as j_plan_matrices

    mats = {f"m{j}": _w(s, j) for j, s in enumerate([(48, 6), (70, 13),
                                                      (16, 2)])}
    ts, js = CrossbarSpec(16, 16, 8), JSpec(16, 16, 8)
    pj, _ = j_plan_matrices({k: jnp.asarray(v) for k, v in mats.items()},
                            js, "mdm")
    for name, w in mats.items():
        plan, codes, _, scale = plan_matrix(torch.from_numpy(w), ts, "mdm")
        _assert_plans_equal(pj[name], plan)
        assert_same(quantize_codes_host(w, np.float32(_np(scale)), 8)
                    .astype(np.int64), _np(codes).astype(np.int64))
