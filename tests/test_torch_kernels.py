"""The port's kernels against the JAX reference (plain versions, CPU).

CPU parity bounds are the reference's own for the same function:
``manhattan_score`` rtol 1e-6 (tests/test_kernels.py), ``cim_mvm`` the
three-way rtol 1e-5 + atol 1e-6 (tests/test_cim_dispatch.py), flash
attention rtol = atol = 2e-5 (tests/test_kernels_perf.py).  The JAX
Pallas kernels run in interpret mode, as the reference's tests run them.
The CUDA kernels against their plain versions: tests/test_torch_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import CrossbarSpec as JSpec
from repro.kernels.cim_mvm.ops import cim_mvm as j_cim_mvm
from repro.kernels.cim_mvm.ops import deploy as j_deploy
from repro.kernels.cim_mvm.ref import cim_mvm_ref as j_cim_mvm_ref
from repro.kernels.flash_attention.ops import flash_attention_tpu
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.manhattan_score import manhattan_score as j_score
from repro.models.attention import flash_attention as j_flash
from repro_torch.core.bitslice import bitslice, unbitslice
from repro_torch.core.mdm import MODES
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.kernels.cim_mvm.ops import cim_mvm, deploy, fold
from repro_torch.kernels.cim_mvm.ref import (
    cim_effective_weights,
    cim_mvm_plain,
    cim_mvm_ref,
    deployment_weights,
    read_noise,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    EMPTY_POS,
    flash_attention_plain,
)
from repro_torch.kernels.manhattan_score.ops import manhattan_score

CPU = "cpu"
NF_UNIT = 2.5 / 300e3


def _masks(shape, seed, p=0.3):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


# --------------------------- manhattan_score -----------------------------

@pytest.mark.parametrize("t,r,c,seed", [
    (1, 16, 16, 0), (9, 64, 64, 1), (3, 16, 64, 2), (5, 64, 16, 3),
    (2, 64, 64, 42), (7, 16, 16, 99),
])
def test_manhattan_score_matches_reference(t, r, c, seed):
    m = _masks((t, r, c), seed)
    want = j_score(jnp.asarray(m), nf_unit=NF_UNIT)
    got = manhattan_score(torch.from_numpy(m), NF_UNIT, device=CPU)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_manhattan_score_placed_variants_match_reference():
    """reverse / row_position score the placed tile without building it:
    equal to the reference kernel on explicitly mirrored and permuted
    masks."""
    m = _masks((4, 16, 16), 7)
    rng = np.random.default_rng(8)
    perm = np.stack([rng.permutation(16) for _ in range(4)])
    position = np.argsort(perm, -1).astype(np.int32)
    placed = np.take_along_axis(m[..., ::-1], perm[..., None], axis=1)
    _, _, nf_want = j_score(jnp.asarray(placed), nf_unit=NF_UNIT)
    s_want, n_want, _ = j_score(jnp.asarray(m[..., ::-1].copy()),
                                nf_unit=NF_UNIT)
    s, n, nf = manhattan_score(torch.from_numpy(m), NF_UNIT, reverse=True,
                               row_position=torch.from_numpy(position),
                               device=CPU)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), rtol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(n_want), rtol=1e-6)
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_want), rtol=1e-6)


def test_manhattan_score_batch_dims():
    m = torch.from_numpy(_masks((2, 5, 16, 16), 3, 0.2)).float()
    s, n, nf = manhattan_score(m, device=CPU)
    assert s.shape == (2, 5, 16) and n.shape == (2, 5, 16)
    assert nf.shape == (2, 5)


# ------------------------------- cim_mvm ---------------------------------

def _three_way(mode, shape, spec, eta=2e-3, seed=None):
    I, N, M = shape
    rng = np.random.default_rng(I * N + M if seed is None else seed)
    w = (rng.standard_normal((I, N)) * 0.2).astype(np.float32)
    x = rng.standard_normal((M, I)).astype(np.float32)
    js, ts = JSpec(*spec), CrossbarSpec(*spec)
    dj, _ = j_deploy(jnp.asarray(w), js, mode, eta=eta)
    dt, pt = deploy(torch.from_numpy(w), ts, mode, eta=eta)
    np.testing.assert_array_equal(np.asarray(dj.codes), dt.codes.numpy())
    y = cim_mvm(torch.from_numpy(x), dt, device=CPU).numpy()
    x_pad = np.pad(x, ((0, 0), (0, dt.codes.shape[0] - I)))
    y_oracle = cim_mvm_ref(torch.from_numpy(x_pad), dt.codes, pt, ts,
                           eta)[:, :N].numpy()
    refs = {
        "xla": np.asarray(j_cim_mvm(jnp.asarray(x), dj, impl="xla")),
        "interpret": np.asarray(j_cim_mvm(jnp.asarray(x), dj,
                                          impl="interpret")),
        "ref": np.asarray(j_cim_mvm_ref(
            jnp.asarray(x_pad), dj.codes.astype(jnp.int32),
            j_deploy(jnp.asarray(w), js, mode, eta=eta)[1], js, eta)[:, :N]),
        "port oracle": y_oracle,
    }
    for name, ref in refs.items():
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(48, 6, 4), (70, 13, 5)])
def test_cim_mvm_three_way(mode, shape):
    _three_way(mode, shape, (16, 16, 8))


@pytest.mark.parametrize("mode", ["baseline", "mdm"])
def test_cim_mvm_odd_bits(mode):
    _three_way(mode, (33, 7, 3), (32, 32, 4), eta=1e-3)


def test_cim_mvm_eta0_equals_quantised_matmul():
    """eta = 0: the CIM path is exactly x @ quantise(W) for every mode."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((128, 32)) * 0.3).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32))
    wq = unbitslice(bitslice(w, 8))
    for mode in MODES:
        dep, _ = deploy(w, CrossbarSpec(64, 64, 8), mode, eta=0.0)
        np.testing.assert_allclose(cim_mvm(x, dep, device=CPU).numpy(),
                                   (x @ wq).numpy(), rtol=1e-5, atol=1e-5)


def test_cim_mvm_batched_input_and_layer_views():
    w = torch.randn(64, 16, generator=torch.Generator().manual_seed(1)) * 0.1
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(2))
    dep, _ = deploy(w, CrossbarSpec(64, 64, 8))
    y = cim_mvm(x, dep, device=CPU)
    assert y.shape == (2, 3, 16)
    np.testing.assert_allclose(y.reshape(6, 16).numpy(),
                               cim_mvm(x.reshape(6, 64), dep,
                                       device=CPU).numpy(), rtol=1e-6)


def test_cim_mvm_refuses_nonideal_deployments():
    """Once a refusal, now parity: deployments carrying a gain, a column
    permutation, or both, against the reference's ``cim_mvm(impl="xla")``
    (the only reference path that applies them) at its three-way bound,
    for x in f32 and bf16 (both packages upcast x to f32)."""
    spec = (16, 16, 8)
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    dep, _ = deploy(torch.from_numpy(w), CrossbarSpec(*spec), "mdm")
    j_dep, _ = j_deploy(jnp.asarray(w), JSpec(*spec), "mdm")
    gain = np.exp(0.1 * rng.standard_normal(dep.codes.shape)).astype(
        np.float32)
    ti, tn = dep.codes.shape[0] // spec[0], dep.pos.shape[1]
    col_pos = np.argsort(rng.random((ti, tn, spec[1])), -1).astype(np.int32)
    for extra in ({"gain": gain}, {"col_pos": col_pos},
                  {"gain": gain, "col_pos": col_pos}):
        d = dataclasses.replace(dep, **{k: torch.from_numpy(v)
                                        for k, v in extra.items()})
        jd = dataclasses.replace(j_dep, **{k: jnp.asarray(v)
                                           for k, v in extra.items()})
        want = np.asarray(j_cim_mvm(jnp.asarray(x), jd, impl="xla"))
        for xt in (torch.from_numpy(x), torch.from_numpy(x).bfloat16()):
            xw = xt.float().numpy()
            want = np.asarray(j_cim_mvm(jnp.asarray(xw), jd, impl="xla"))
            for dd in (d, fold(d)):       # as given, and folded
                got = cim_mvm(xt, dd, device=CPU).numpy()
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _with_operands(dep, ops, rows, rng):
    """``dep`` carrying the operands named in ``ops``: a log-normal gain,
    random per-tile bitline permutations, read noise (sigma_read 0.05,
    tag 3)."""
    extra = {}
    if "gain" in ops:
        extra["gain"] = torch.from_numpy(np.exp(0.1 * rng.standard_normal(
            dep.codes.shape)).astype(np.float32))
    if "colpos" in ops:
        ti, tn = dep.codes.shape[0] // rows, dep.pos.shape[1]
        extra["col_pos"] = torch.from_numpy(np.argsort(
            rng.random((ti, tn, dep.cols)), -1).astype(np.int32))
    if "noise" in ops:
        extra.update(noise_tag=torch.tensor(3, dtype=torch.int32),
                     sigma_read=0.05)
    return dataclasses.replace(dep, **extra)


OPERANDS = ("gain", "colpos", "gain+colpos", "noise", "gain+colpos+noise")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec,shape", [((16, 16, 8), (40, 13)),
                                        ((64, 64, 8), (70, 80))])
@pytest.mark.parametrize("ops", OPERANDS)
def test_fold_plain_is_the_expansion_times_gain(mode, spec, shape, ops):
    """The fold's plain version (which the card's fold kernel is held to
    bit for bit) is W'(col_pos) * gain exactly, the expansion computed
    here directly, in all four modes (two with reversed dataflow), as
    (i_pad, ld) with ld = n_pad rounded up to 8 (n_pad 14 under wpt 2)
    and zero columns past n_pad; an ideal deployment is not folded."""
    rng = np.random.default_rng(len(ops) + shape[0])
    w = torch.from_numpy((rng.standard_normal(shape) * 0.2).astype(
        np.float32))
    dep, _ = deploy(w, CrossbarSpec(*spec), mode)
    assert dep.folded is None
    d = _with_operands(dep, ops, spec[0], rng)
    f = fold(d)
    i_pad, n_pad = d.codes.shape
    assert f.folded.shape == (i_pad, -(-n_pad // 8) * 8)
    assert (f.folded[:, n_pad:] == 0).all()
    want = cim_effective_weights(d.codes, d.pos, d.scale, n_bits=d.n_bits,
                                 wpt=d.wpt, cols=d.cols, eta=d.eta,
                                 reversed_df=d.reversed_df,
                                 col_pos=d.col_pos)
    if d.gain is not None:
        want = want * d.gain
    assert torch.equal(f.folded[:, :n_pad], want)
    assert torch.equal(deployment_weights(d, None), want)
    assert torch.equal(deployment_weights(f, None), want)


@pytest.mark.parametrize("ops", OPERANDS)
@pytest.mark.parametrize("read_seed", [None, 7])
def test_cim_mvm_plain_reads_the_fold_bit_for_bit(ops, read_seed):
    """The plain version on a folded deployment reads its ``folded`` W'
    (the codes no longer matter) and gives the unfolded result bit for
    bit, with and without a read's noise."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy((rng.standard_normal((70, 45)) * 0.2).astype(
        np.float32))
    dep, _ = deploy(w, CrossbarSpec(16, 16, 8), "mdm")
    d = _with_operands(dep, ops, 16, rng)
    f = fold(d)
    x = torch.from_numpy(rng.standard_normal((5, 70)).astype(np.float32))
    want = cim_mvm_plain(x, d, read_seed)
    assert torch.equal(cim_mvm_plain(x, f, read_seed), want)
    assert torch.equal(cim_mvm(x, f, read_seed, device=CPU), want)
    blank = dataclasses.replace(f, codes=torch.zeros_like(f.codes))
    assert blank.folded is None        # replace drops the fold
    blank.folded = f.folded
    assert torch.equal(cim_mvm_plain(x, blank, read_seed), want)


@pytest.mark.parametrize("ops", ["noise", "gain+colpos+noise"])
def test_folded_read_noise_matches_reference_formula(ops):
    """A folded deployment's noisy read against the reference's
    ``cim_mvm(impl="xla")``, its gain and col_pos moved across and the
    port's eps moved into the reference's noise term (sigma_read * agg)
    * scale * eps, at the reference's three-way bound; x f32 and bf16."""
    spec = (16, 16, 8)
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    dep, _ = deploy(torch.from_numpy(w), CrossbarSpec(*spec), "mdm")
    j_dep, _ = j_deploy(jnp.asarray(w), JSpec(*spec), "mdm")
    d = _with_operands(dep, ops, spec[0], rng)
    jd = dataclasses.replace(j_dep, **{
        k: jnp.asarray(getattr(d, k).numpy()) for k in ("gain", "col_pos")
        if getattr(d, k) is not None})
    f = fold(d)
    i_pad, n_pad = d.codes.shape
    eps = read_noise(7, 3, i_pad, n_pad, "cpu").numpy()[:40, :24]
    agg = float(((1.0 - 4.0 ** -spec[2]) / 3.0) ** 0.5)
    nz = np.float32(0.05 * agg) * np.float32(d.scale)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    for xt in (torch.from_numpy(x), torch.from_numpy(x).bfloat16()):
        xw = xt.float().numpy()
        clean = np.asarray(j_cim_mvm(jnp.asarray(xw), jd, impl="xla"))
        want = clean + xw.astype(np.float64) @ (nz * eps).astype(np.float64)
        got = cim_mvm(xt, f, read_seed=7, device=CPU).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.abs(got - clean).max() > 1e-3 * np.abs(clean).max()


# ---------------------------- flash attention ----------------------------

def _qkv(B, Sq, Skv, H, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, H, Dh), f(B, Skv, Hkv, Dh), f(B, Skv, Hkv, Dh)


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, H, Hkv, Dh, window
    (2, 64, 64, 4, 2, 32, 0),
    (1, 40, 72, 6, 3, 16, 24),
    (2, 1, 96, 4, 4, 32, 0),        # decode shape
    (1, 33, 33, 8, 1, 16, 0),       # MQA
    (2, 12, 40, 4, 4, 96, 0),       # phi3-mini head_dim
])
def test_flash_matches_reference(case):
    B, Sq, Skv, H, Hkv, Dh, win = case
    q, k, v = _qkv(B, Sq, Skv, H, Hkv, Dh, sum(case))
    qpos = np.arange(Sq, dtype=np.int32) + max(0, Skv - Sq)
    kpos = np.arange(Skv, dtype=np.int32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          q_positions=torch.from_numpy(qpos),
                          k_positions=torch.from_numpy(kpos), window=win,
                          chunk=16, device=CPU).numpy()
    j = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    kern = flash_attention_tpu(j[0], j[1], j[2], q_positions=j[3],
                               k_positions=j[4], window=win, block_q=32,
                               block_k=32)
    exact = attention_ref(*j, window=win)
    for ref in (kern, exact):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("case", [
    (2, 20, 20, 4, 2, 32, 0),
    (1, 40, 72, 6, 3, 16, 24),
    (2, 1, 96, 4, 4, 32, 0),        # decode shape
    (2, 12, 40, 4, 4, 96, 0),       # phi3-mini head_dim
])
def test_flash_bf16_matches_reference(case):
    """bf16 q, k, v (the reference's default dtype): the plain version
    against the reference's Pallas kernel in interpret mode on the same
    bf16 inputs, compared in f32.  Both compute in f32 and round the
    output to bf16 once, so a value near a rounding boundary may differ
    by one bf16 ulp: rtol 2^-7 beside the f32 atol 2e-5."""
    B, Sq, Skv, H, Hkv, Dh, win = case
    q, k, v = _qkv(B, Sq, Skv, H, Hkv, Dh, sum(case) + 1)
    qpos = np.arange(Sq, dtype=np.int32) + max(0, Skv - Sq)
    kpos = np.arange(Skv, dtype=np.int32)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = flash_attention(*t, q_positions=torch.from_numpy(qpos),
                          k_positions=torch.from_numpy(kpos), window=win,
                          chunk=16, device=CPU)
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    assert np.array_equal(np.asarray(j[0]).view(np.uint16),
                          t[0].view(torch.int16).numpy().view(np.uint16))
    kern = flash_attention_tpu(*j, q_positions=jnp.asarray(qpos),
                               k_positions=jnp.asarray(kpos), window=win,
                               block_q=32, block_k=32)
    assert kern.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kern, np.float32),
                               rtol=2.0 ** -7, atol=2e-5)


def test_flash_per_lane_positions_and_empty_slots():
    """(B, S) positions with EMPTY_POS slots vs the reference's pure-JAX
    flash attention, which takes the same per-lane form."""
    B, Sq, C, H, Hkv, Dh = 3, 2, 24, 4, 2, 96
    q, k, v = _qkv(B, Sq, C, H, Hkv, Dh, 5)
    kpos = np.full((B, C), int(EMPTY_POS), np.int32)
    qpos = np.zeros((B, Sq), np.int32)
    for b, n in enumerate((5, 17, 24)):
        kpos[b, :n] = np.arange(n)
        qpos[b] = np.arange(n - Sq, n)
    kpos[0, 0] = int(EMPTY_POS)          # an evicted slot mid-ring
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          q_positions=torch.from_numpy(qpos),
                          k_positions=torch.from_numpy(kpos), chunk=8,
                          device=CPU).numpy()
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  q_positions=jnp.asarray(qpos),
                  k_positions=jnp.asarray(kpos), chunk=8)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_flash_fully_masked_row_is_zero():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 2, 2, 16, 1))
    kpos = torch.full((8,), EMPTY_POS, dtype=torch.int32)
    out = flash_attention_plain(q, k, v, torch.arange(2, dtype=torch.int32),
                                kpos, chunk=4)
    assert torch.isfinite(out).all() and (out == 0).all()


# ------------------------- launch geometry (CPU) --------------------------

import re
from pathlib import Path

from repro_torch.kernels.cim_mvm import ops as cim_ops
from repro_torch.kernels.flash_attention import ops as flash_ops


def _cu_constant(path, name):
    text = Path(path).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# The kernels' index loops, restated from kernel.cu: their constants are
# held to the sources by test_geometry_constants_mirror_the_kernels, and
# the card tests (tests/test_torch_cuda.py) check the kernels themselves.

def _cim_decode_rows(geom):
    """The rows of I each (cluster rank, block slice) of the cim_mvm
    decode form sums, in the kernel's order of reduction: ranks 0..7,
    and within a rank slices 0..KS-1; each list in the order its thread
    visits the rows."""
    ks = cim_ops.THREADS // geom.tile
    out = []
    for r in range(cim_ops.DECODE_CLUSTER):
        k0, k1 = r * geom.rps, min((r + 1) * geom.rps, geom.I)
        out += [list(range(k0 + s, k1, ks)) for s in range(ks)]
    return out


def _cim_prefill_tiles(geom):
    """The cim_mvm prefill forms' output tiles (row range, column range)
    and the I slabs each tile's blocks sum, in order: split z of gz (a
    cluster rank) the slabs [s * z / gz, s * (z + 1) / gz) of s."""
    bm, bn, bk = cim_ops.PREFILL_BM, geom.tile, cim_ops.PREFILL_BK
    tiles = [((by * bm, min((by + 1) * bm, geom.M)),
              (bx * bn, min((bx + 1) * bn, geom.N)))
             for by in range(geom.gy) for bx in range(geom.gx)]
    n = -(-geom.I // bk)
    slabs = [(kt * bk, min((kt + 1) * bk, geom.I)) for z in range(geom.gz)
             for kt in range(n * z // geom.gz, n * (z + 1) // geom.gz)]
    return tiles, slabs


def _cim_batched_work(geom):
    """The batched folded decode form's work, from its persistent loops:
    for each cluster c of gx / gy, its items w = c, c + gx / gy, ...
    (member w // tiles, columns from (w % tiles) * tile), and for each
    rank of the cluster, in rank order (the order of the merge), the
    rows of I its slabs cover."""
    bk, split = cim_ops.BATCHED_BK, geom.gy
    tiles = -(-geom.N // geom.tile)
    n_items, nc, n = geom.gz * tiles, geom.gx // split, -(-geom.I // bk)
    ranks = [[i for kt in range(n * r // split, n * (r + 1) // split)
              for i in range(kt * bk, min((kt + 1) * bk, geom.I))]
             for r in range(split)]
    return [[(w // tiles, (w % tiles) * geom.tile)
             for w in range(c, n_items, nc)] for c in range(nc)], ranks


def _flash_decode_parts(C):
    """The keys of each of the flash decode form's partial states, in the
    order the partials merge; key c goes to warp (c // 4) % 8, lane
    group c % 4, two rounds of 32 keys a loop step."""
    warps = flash_ops.DECODE_WARPS
    parts = [[] for _ in range(4 * warps)]
    for w in range(warps):
        for g in range(4):
            c0 = 4 * w + g
            while c0 < C:
                parts[4 * w + g] += [c for c in (c0, c0 + 4 * warps)
                                     if c < C]
                c0 += 2 * 4 * warps
    return parts


def test_geometry_constants_mirror_the_kernels():
    """The Python geometry mirrors kernel.cu: constants and field order."""
    cim_cu = Path(cim_ops.__file__).with_name("kernel.cu")
    assert _cu_constant(cim_cu, "THREADS") == cim_ops.THREADS
    assert _cu_constant(cim_cu, "CLUSTER") == cim_ops.DECODE_CLUSTER
    assert _cu_constant(cim_cu, "DEC_RM") == cim_ops.DECODE_RM
    assert _cu_constant(cim_cu, "PF_BM") == cim_ops.PREFILL_BM
    assert _cu_constant(cim_cu, "PF_BN") == cim_ops.PREFILL_BN
    assert _cu_constant(cim_cu, "PF_BK") == cim_ops.PREFILL_BK
    assert _cu_constant(cim_cu, "PF_STAGES") == cim_ops.PREFILL_STAGES
    assert _cu_constant(cim_cu, "FOLD_COLS") == cim_ops.FOLD_COLS
    assert _cu_constant(cim_cu, "BT_BN") == cim_ops.BATCHED_BN
    assert _cu_constant(cim_cu, "BT_BK") == cim_ops.BATCHED_BK
    assert _cu_constant(cim_cu, "BT_STAGES") == cim_ops.BATCHED_STAGES
    assert _cu_constant(cim_cu, "BT_BLOCKS") == cim_ops.BATCHED_BLOCKS
    assert _cu_constant(cim_cu, "GR_BM") == cim_ops.GROUPED_BM
    assert _cu_constant(cim_cu, "GR_BN") == cim_ops.GROUPED_BN
    assert _cu_constant(cim_cu, "GR_BK") == cim_ops.GROUPED_BK
    for name, value in (("GD_BN", cim_ops.GROUPED_DECODE_BN),
                        ("GD_BK", cim_ops.GROUPED_DECODE_BK),
                        ("GD_STAGES", cim_ops.GROUPED_DECODE_STAGES),
                        ("GD_RB", cim_ops.GROUPED_DECODE_RB),
                        ("GD_BLOCKS", cim_ops.GROUPED_DECODE_BLOCKS),
                        ("GP_BN", cim_ops.GROUPED_PREFILL_BN),
                        ("GP_BK", cim_ops.GROUPED_PREFILL_BK),
                        ("GP_STAGES", cim_ops.GROUPED_PREFILL_STAGES),
                        ("GP_NT", cim_ops.GROUPED_PREFILL_NT),
                        ("GP_KS", cim_ops.GROUPED_PREFILL_KS),
                        ("GFD_STAGES", cim_ops.GROUPED_FOLDED_DECODE_STAGES),
                        ("GFD_BLOCKS", cim_ops.GROUPED_FOLDED_DECODE_BLOCKS),
                        ("GFP_STAGES",
                         cim_ops.GROUPED_FOLDED_PREFILL_STAGES)):
        assert _cu_constant(cim_cu, name) == value, name
    # The grouped decode form's split and the prefill form's layout.
    text = cim_cu.read_text()
    assert max(cim_ops.GROUPED_SPLITS) <= _cu_constant(cim_cu, "CLUSTER")
    for name, base, value in (
            ("GP_CLD", "GP_BN", 8), ("GP_XLD", "GP_BK", 4),
            ("GP_XLDB", "GP_BK", 8),
            ("GFP_WLD", "GP_BN", cim_ops.GROUPED_FOLDED_PREFILL_WLD
             - cim_ops.GROUPED_PREFILL_BN),
            ("GFP_WLDB", "GP_BN", cim_ops.GROUPED_FOLDED_PREFILL_WLDB
             - cim_ops.GROUPED_PREFILL_BN)):
        assert re.search(rf"constexpr int {name} = {base} \+ (\d+);",
                         text).group(1) == str(value)
    for name, base, value in (
            ("BT_WLD", "BT_BN", cim_ops.BATCHED_WLD - cim_ops.BATCHED_BN),
            ("BT_XLD", "BT_BK", cim_ops.BATCHED_XLD - cim_ops.BATCHED_BK)):
        assert re.search(rf"constexpr int {name} = {base} \+ (\d+);",
                         cim_cu.read_text()).group(1) == str(value)
    assert re.search(r"constexpr int PF_WLD = PF_BN \+ (\d+);",
                     cim_cu.read_text()).group(1) == str(
        cim_ops.PREFILL_WLD - cim_ops.PREFILL_BN)
    forms = re.search(r"constexpr int FORM_DECODE = 0, FORM_PREFILL = 1, "
                      r"FORM_DECODE_FOLDED = 2,\s*FORM_PREFILL_FOLDED = 3, "
                      r"FORM_FOLD = 4,\s*FORM_DECODE_BATCHED = 5, "
                      r"FORM_GROUPED = 6,\s*FORM_GROUPED_DECODE = 7, "
                      r"FORM_GROUPED_PREFILL = 8,\s*FORM_GROUPED_FOLDED = 9, "
                      r"FORM_GROUPED_FOLDED_DECODE = 10,\s*"
                      r"FORM_GROUPED_FOLDED_PREFILL = 11;",
                      cim_cu.read_text())
    assert forms and (cim_ops.FORM_DECODE, cim_ops.FORM_PREFILL,
                      cim_ops.FORM_DECODE_FOLDED, cim_ops.FORM_PREFILL_FOLDED,
                      cim_ops.FORM_FOLD, cim_ops.FORM_DECODE_BATCHED,
                      cim_ops.FORM_GROUPED, cim_ops.FORM_GROUPED_DECODE,
                      cim_ops.FORM_GROUPED_PREFILL,
                      cim_ops.FORM_GROUPED_FOLDED,
                      cim_ops.FORM_GROUPED_FOLDED_DECODE,
                      cim_ops.FORM_GROUPED_FOLDED_PREFILL) == tuple(range(12))
    assert cim_ops.GROUPED_FOLDED_FORMS == (9, 10, 11)
    fields = re.search(r"struct Geom \{\s*int ([^;]*);",
                       cim_cu.read_text()).group(1)
    assert tuple(f.strip() for f in fields.split(",")) == \
        cim_ops._GEOM_FIELDS
    fl_cu = Path(flash_ops.__file__).with_name("kernel.cu")
    assert _cu_constant(fl_cu, "PF_QB") == flash_ops.PREFILL_QB
    assert _cu_constant(fl_cu, "PF_KT") == flash_ops.PREFILL_KT
    assert _cu_constant(fl_cu, "DEC_WARPS") == flash_ops.DECODE_WARPS
    assert _cu_constant(fl_cu, "BP_KT") == flash_ops.BF16_KT
    assert _cu_constant(fl_cu, "BP_STAGES") == flash_ops.BF16_STAGES
    assert _cu_constant(fl_cu, "BD_WARPS") == flash_ops.BF16_DECODE_WARPS
    assert _cu_constant(fl_cu, "BD_HEADS") == flash_ops.BF16_DECODE_HEADS
    assert _cu_constant(fl_cu, "BD_MAX_SPLIT") == flash_ops.BF16_MAX_SPLIT
    assert _cu_constant(fl_cu, "BD_ROUND") == flash_ops.BF16_ROUND
    assert _cu_constant(fl_cu, "BD_ROUNDS") == flash_ops.BF16_ROUNDS
    text = fl_cu.read_text()
    forms = re.search(r"constexpr int FORM_DECODE = 0, FORM_PREFILL = 1, "
                      r"FORM_PREFILL_BF16 = 2,\s*FORM_DECODE_BF16 = 3;", text)
    assert forms and (flash_ops.FORM_DECODE, flash_ops.FORM_PREFILL,
                      flash_ops.FORM_PREFILL_BF16,
                      flash_ops.FORM_DECODE_BF16) == (0, 1, 2, 3)
    fields = re.search(r"struct Geom \{\s*int ([^;]*);", text).group(1)
    assert tuple(f.strip() for f in fields.split(",")) == \
        flash_ops._GEOM_FIELDS
    assert _cu_constant(fl_cu, "BP_WARPS") == flash_ops.BF16_PREFILL_WARPS


@pytest.mark.parametrize("M,I,N,wpt,n_bits", [
    (1, 3072, 8192, 8, 8), (4, 3072, 3072, 8, 8), (16, 8192, 3072, 8, 8),
    (4, 1000, 300, 2, 8), (3, 70, 13, 8, 8), (16, 33, 7, 8, 4),
])
def test_cim_decode_geometry_covers_each_row_once(M, I, N, wpt, n_bits):
    """Decode form: the (cluster rank, slice) row sets, in the order the
    kernel reduces them, cover every row of I exactly once; each thread
    visits its rows in increasing order; the blocks cover every column
    of n_pad, and the shared memory fits."""
    n_pad = -(-N // wpt) * wpt
    geom = cim_ops.cim_geometry(M, I, N, I, n_pad, wpt, n_bits, 8 * wpt,
                                True, 132, True)
    assert geom.form == 0 and geom.mt >= M and geom.gy == 8
    assert geom.smem <= cim_ops.SMEM_MAX
    parts = _cim_decode_rows(geom)
    assert len(parts) == 8 * (cim_ops.THREADS // geom.tile)
    flat = [i for rows in parts for i in rows]
    assert sorted(flat) == list(range(I))
    assert all(rows == sorted(rows) for rows in parts)
    # Rank-major order: a rank's rows all come before the next rank's.
    ks = cim_ops.THREADS // geom.tile
    firsts = [min(sum(parts[r * ks:(r + 1) * ks], []), default=None)
              for r in range(8)]
    firsts = [f for f in firsts if f is not None]
    assert firsts == sorted(firsts)
    assert geom.gx * 8 * geom.tile >= n_pad > (geom.gx - 1) * 8 * geom.tile
    assert geom.fast == int(wpt % 8 == 0 and n_pad % 8 == 0)


@pytest.mark.parametrize("M,I,N", [(17, 3072, 8192), (512, 3072, 3072),
                                   (512, 8192, 3072), (40, 70, 13)])
def test_cim_prefill_geometry_covers_each_output_once(M, I, N):
    n_pad = -(-N // 8) * 8
    geom = cim_ops.cim_geometry(M, I, N, I, n_pad, 8, 8, 64, True, 132,
                                True)
    assert geom.form == 1 and geom.smem <= cim_ops.SMEM_MAX
    tiles, slabs = _cim_prefill_tiles(geom)
    hits = np.zeros((M, N), np.int32)
    for (r0, r1), (c0, c1) in tiles:
        hits[r0:r1, c0:c1] += 1
    assert (hits == 1).all()
    assert [i for a, b in slabs for i in range(a, b)] == list(range(I))


@pytest.mark.parametrize("M", [1, 4, 8, 16, 128, 512])
@pytest.mark.parametrize("I,N,rows", [(3072, 8192, 64), (8192, 3072, 64),
                                      (640, 384, 16), (1000, 300, 16)])
@pytest.mark.parametrize("ext", [1, 2, 4, 7])   # gain, col_pos, noise, all
def test_cim_geometry_with_nonideal_operands(M, I, N, rows, ext):
    """A deployment carrying a gain (1), a col_pos (2), read noise (4) or
    all three is read through the folded forms: the ideal form's choice
    by M, rows of ld = n_pad rounded up to 8 floats, every row of I and
    column of ld covered once, shared memory that fits, noise drawn
    where it is armed, x bf16 changing nothing else.  Its fold's blocks
    cover (i_pad, ld) once, and the col_pos tiles a fold block touches
    (cp_ti x cp_tn) cover what the fold kernel indexes."""
    wpt = 8
    n_pad = -(-N // wpt) * wpt
    i_pad = -(-I // rows) * rows
    noise, colp = bool(ext & 4), bool(ext & 2)
    geom = cim_ops.cim_geometry(M, I, N, i_pad, n_pad, wpt, 8, 64, True, 132,
                                True, True, True, noise)
    ideal = cim_ops.cim_geometry(M, I, N, i_pad, n_pad, wpt, 8, 64, True,
                                 132, True)
    assert geom.smem <= cim_ops.SMEM_MAX and geom.xbf16 == 1
    assert geom.noise == int(noise) and geom.fast == 0
    assert geom.ld % 8 == 0 and n_pad <= geom.ld < n_pad + 8
    assert geom.form == ideal.form + 2
    if geom.form == cim_ops.FORM_DECODE_FOLDED:
        flat = [i for part in _cim_decode_rows(geom) for i in part]
        assert sorted(flat) == list(range(I))
        assert geom.gx * 8 * geom.tile >= geom.ld \
            > (geom.gx - 1) * 8 * geom.tile
    else:
        tiles, slabs = _cim_prefill_tiles(geom)
        hits = np.zeros((M, N), np.int32)
        for (r0, r1), (c0, c1) in tiles:
            hits[r0:r1, c0:c1] += 1
        assert (hits == 1).all()
        assert [i for a, b in slabs for i in range(a, b)] == list(range(I))
        # A split of I fills idle SMs, a cluster of at most 8, each rank
        # with a slab and 64 / gz of a thread's sums to add.
        assert geom.gz in (1, 2, 4, 8) and ideal.gz == 1
        blocks = geom.gx * geom.gy
        assert geom.gz == 1 or blocks * geom.gz <= 132
        assert blocks * 2 * geom.gz > 132 or geom.gz == 8 \
            or -(-I // cim_ops.PREFILL_BK) < 2 * geom.gz
    fold = cim_ops.fold_geometry(i_pad, n_pad, wpt, 8, 64, False, True,
                                 rows if colp else 0)
    assert fold.form == cim_ops.FORM_FOLD and fold.ld == geom.ld
    assert fold.smem <= cim_ops.SMEM_MAX and fold.I == i_pad
    assert fold.gy * fold.rps >= i_pad > (fold.gy - 1) * fold.rps
    cw = cim_ops.FOLD_COLS
    assert fold.gx * cw >= fold.ld > (fold.gx - 1) * cw
    if colp:
        assert fold.n_ti == i_pad // rows
        for k0 in range(0, i_pad, fold.rps):
            k1 = min(k0 + fold.rps, i_pad) - 1
            assert k1 // rows - k0 // rows < fold.cp_ti
        for n0 in range(0, n_pad, cw):
            n1 = min(n0 + cw, n_pad) - 1
            assert n1 // wpt - n0 // wpt < fold.cp_tn
    else:
        assert fold.cp_ti == fold.cp_tn == 0


def test_cim_geometry_dispatch_by_rows():
    g = lambda M: cim_ops.cim_geometry(M, 256, 64, 256, 64, 8, 8, 64, False,
                                       132, True)
    assert [g(M).form for M in (1, 4, 16, 17, 512)] == [0, 0, 0, 1, 1]
    # A decode-sized M whose x slab would not fit goes to the prefill form.
    big = cim_ops.cim_geometry(16, 1 << 17, 64, 1 << 17, 64, 8, 8, 64,
                               False, 132, True)
    assert big.form == 1


@pytest.mark.parametrize("G", [1, 3, 32, 40])
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("I,N", [(320, 200), (330, 900), (3072, 8192),
                                 (8192, 3072), (33, 7)])
def test_cim_batched_geometry_covers_each_output_once(G, M, I, N):
    """The batched folded decode form: its persistent clusters' items
    cover every (member, output column) exactly once, each cluster's
    ranks every row of I once in rank order, each rank with a slab; a
    split of I (a cluster of gy blocks) exactly where the items alone
    would leave blocks of BATCHED_BLOCKS a SM idle; the grid no wider
    than the card holds at once; shared memory that fits BATCHED_BLOCKS
    blocks a SM (228 KB an SM, 1 KB of it reserved a block)."""
    sm = 132
    n_pad = -(-N // 8) * 8
    geom = cim_ops.batched_geometry(G, M, I, N, I, n_pad, 8, 8, 64, False,
                                    sm, False, True)
    assert geom.form == cim_ops.FORM_DECODE_BATCHED and geom.gz == G
    assert geom.M == M and geom.ld == n_pad and geom.tile == \
        cim_ops.BATCHED_BN
    per_cluster, ranks = _cim_batched_work(geom)
    hits = np.zeros((G, N), np.int32)
    for items in per_cluster:
        assert items
        for z, nb in items:
            hits[z, nb:min(nb + geom.tile, N)] += 1
    assert (hits == 1).all()
    assert all(ranks) and [i for r in ranks for i in r] == list(range(I))
    items = G * -(-N // cim_ops.BATCHED_BN)
    slots = cim_ops.BATCHED_BLOCKS * sm
    assert geom.gx % geom.gy == 0 and geom.gx <= slots
    assert geom.gy in (1, 2, 4, 8)
    if geom.gy > 1:
        assert items * geom.gy <= slots
    assert geom.gy == 8 or items * 2 * geom.gy > slots \
        or -(-I // cim_ops.BATCHED_BK) < 2 * geom.gy
    assert geom.smem <= cim_ops.SMEM_MAX
    assert cim_ops.BATCHED_BLOCKS * (geom.smem + 1024) <= 228 * 1024
    bf = cim_ops.batched_geometry(G, M, I, N, I, n_pad, 8, 8, 64, False, sm,
                                  True, False)
    assert bf.xbf16 == 1 and bf.noise == 0
    assert (bf.gx, bf.gy, bf.smem) == (geom.gx, geom.gy, geom.smem)


def test_cim_batched_geometry_split_by_shape():
    """A split of I only where members x column tiles leave SMs idle:
    phi3's probe groups (32 members, 3072 and 8192 wide) run unsplit,
    one or three small members split 8 ways, 32 small members 4 ways; a
    group of 17 rows a member is refused."""
    g = lambda G, I, N: cim_ops.batched_geometry(
        G, 16, I, N, I, -(-N // 8) * 8, 8, 8, 64, False, 132)
    assert [g(32, I, N).gy for I, N in ((3072, 3072), (3072, 8192),
                                        (8192, 3072))] == [1, 1, 1]
    assert [g(G, 320, 200).gy for G in (1, 3, 32, 40)] == [8, 8, 4, 2]
    assert g(40, 330, 900).gy == 1 and g(1, 40, 200).gy == 2
    assert g(32, 3072, 8192).gx == 2 * 132
    with pytest.raises(ValueError):
        cim_ops.batched_geometry(3, 17, 320, 200, 320, 200, 8, 8, 64, False,
                                 132)


def _grouped_slots(offsets, cap, slots):
    """kernel.cu's slot_expert: slot z computes the z-th expert, in
    ascending order, that has a row: (expert, first row, rows), or None."""
    live = [(e, offsets[e], min(offsets[e + 1] - offsets[e], cap))
            for e in range(len(offsets) - 1)]
    live = [t for t in live if t[2] > 0]
    return [live[z] if z < len(live) else None for z in range(slots)]


_DECODE_FORMS = (cim_ops.FORM_GROUPED_DECODE,
                 cim_ops.FORM_GROUPED_FOLDED_DECODE)


def _grouped_writes(geom, offsets, A):
    """The times each grouped form's blocks write each y element (A, N),
    and for each (item, pass) the rows of I that each rank (the decode
    forms' cluster, a split prefill form's; one block elsewhere) sums, in
    rank order: the kernels' index loops restated (the folded forms' are
    the ideal forms' over the fold; the folded general form's blocks take
    expert slots)."""
    N, I = geom.N, geom.I
    hits = np.zeros((A, N), np.int32)
    spans = []
    if geom.form in (cim_ops.FORM_GROUPED, cim_ops.FORM_GROUPED_FOLDED):
        bm, bn = cim_ops.GROUPED_BM, geom.tile
        items = ([(offsets[e], min(offsets[e + 1] - offsets[e], geom.M))
                  for e in range(geom.gz)]
                 if geom.form == cim_ops.FORM_GROUPED else
                 [s[1:] for s in _grouped_slots(offsets, geom.M, geom.gz)
                  if s is not None])
        for a0, rows in items:
            for by in range(geom.gy):
                r0 = a0 + by * bm
                if r0 >= a0 + rows:
                    continue
                for bx in range(geom.gx):
                    hits[r0:min(r0 + bm, a0 + rows),
                         bx * bn:(bx + 1) * bn] += 1
                    spans.append([list(range(I))])
        return hits, spans
    slots = _grouped_slots(offsets, geom.M, geom.gz)
    tid = np.arange(cim_ops.THREADS)
    for item in slots:
        if item is None:
            continue
        _, a0, rows = item
        for bx in range(geom.gx):
            nb = bx * geom.tile
            if geom.form in _DECODE_FORMS:
                bk, rb, S = cim_ops.GROUPED_DECODE_BK, geom.mt, geom.gy
                n = -(-I // bk)
                ranks = []
                for r in range(S):
                    s0, s1 = n * r // S, n * (r + 1) // S
                    assert (s1 - s0) * bk <= geom.rps      # the x slab fits
                    ranks.append([i for s in range(s0, s1)
                                  for i in range(s * bk, min(s * bk + bk, I))])
                for c0 in range(0, rows, rb):
                    rc = min(rb, rows - c0)
                    spans.append(ranks)
                    for r in range(S):
                        for base in range(r * cim_ops.THREADS, rc * geom.tile,
                                          S * cim_ops.THREADS):
                            q = base + tid
                            q = q[q < rc * geom.tile]
                            col = nb + q % geom.tile
                            ok = col < N
                            np.add.at(hits, (a0 + c0 + q[ok] // geom.tile,
                                             col[ok]), 1)
            else:
                # Output i = 4t + u of lane (gq, tq) of warp w: row 8t +
                # 2tq + u % 2, column 16w + 2gq + (u % 4) // 2; rank r of
                # gy stores the outputs [r share, (r + 1) share), i < 4 nt.
                bk, S = cim_ops.GROUPED_PREFILL_BK, geom.gy
                per, n = 8 * cim_ops.GROUPED_PREFILL_NT, -(-I // bk)
                share = 4 * cim_ops.GROUPED_PREFILL_NT // S
                ranks = [[i for s in range(n * r // S, n * (r + 1) // S)
                          for i in range(s * bk, min(s * bk + bk, I))]
                         for r in range(S)]
                for c0 in range(0, rows, per):
                    rc = min(per, rows - c0)
                    pairs = -(-rc // 16)          # specialised: 1-4 or 8
                    nt = 2 * (pairs if pairs <= 4 else 8)
                    spans.append(ranks)
                    i, w, gq, tq = np.meshgrid(
                        np.arange(4 * nt), np.arange(8), np.arange(8),
                        np.arange(4), indexing="ij")
                    for r in range(S):
                        mine = (i >= r * share) & (i < (r + 1) * share)
                        m = (8 * (i // 4) + 2 * tq + i % 2)[mine]
                        col = (nb + 16 * w + 2 * gq + i % 4 // 2)[mine]
                        ok = (m < rc) & (col < N)
                        np.add.at(hits, (a0 + c0 + m[ok], col[ok]), 1)
    return hits, spans


def _grouped_counts(routing, E, cap, rng):
    """Rows an expert for each routing of the grouped tests."""
    if routing == "decode":            # 4 tokens top-4: one row an expert
        counts = np.zeros(E, np.int64)
        counts[rng.choice(E, min(E, 14), replace=False)] = 1
        counts[:2] += 1
    elif routing == "one expert":
        counts = np.zeros(E, np.int64)
        counts[3] = cap
    elif routing == "at cap":
        counts = rng.integers(0, cap // 2, E)
        counts[min(7, E - 1)] = cap
    elif routing == "straddle":        # 1..9 rows: every row bucket, 2 passes
        counts = np.arange(E) % 10
    else:                              # "prefill" / "dropped": uneven loads
        counts = rng.poisson(34, E)
        counts[0] = cap + 30
    return counts


@pytest.mark.parametrize("E,I,N,spec,cap,routing", [
    (60, 2048, 1408, (64, 64, 8), 16, "decode"),
    (60, 1408, 2048, (64, 64, 8), 16, "decode"),
    (60, 2048, 1408, (64, 64, 8), 32, "at cap"),
    (60, 2048, 1408, (64, 64, 8), 128, "prefill"),
    (60, 1408, 2048, (64, 64, 8), 128, "at cap"),
    (60, 2048, 1408, (64, 64, 8), 128, "one expert"),
    (12, 200, 72, (16, 16, 8), 9, "straddle"),
    (12, 200, 72, (16, 16, 8), 300, "dropped"),
    (6, 200, 72, (16, 16, 2), 16, "decode"),
    (6, 200, 72, (16, 16, 2), 128, "at cap"),
])
@pytest.mark.parametrize("xbf16", [False, True])
def test_cim_grouped_geometry_covers_each_output_once(E, I, N, spec, cap,
                                                      routing, xbf16):
    """Each grouped form (decode, prefill, general) writes every (expert,
    row below the capacity, column) of y exactly once and no other
    element; each (item, pass) sums every row of I exactly once, over
    the decode form's ranks in rank order, each rank with a slab; the
    decode form splits I over a cluster of at most 8 blocks; the shared
    memory fits (the decode form GROUPED_DECODE_BLOCKS blocks a SM, the
    bf16 prefill form two, 228 KB an SM less 1 KB a block), and the
    decode form's ring holds the warps' sums."""
    rows, cols, bits = spec
    wpt = cols // bits
    n_pad = -(-N // wpt) * wpt
    counts = _grouped_counts(routing, E, cap,
                             np.random.default_rng(len(routing) + cap))
    offsets = np.concatenate([[0], np.cumsum(counts)]).tolist()
    A = offsets[-1] + 1
    geom = cim_ops.grouped_geometry(E, cap, I, N, n_pad, wpt, bits, cols,
                                    False, True, xbf16, A)
    fast = wpt % 8 == 0
    want = (cim_ops.FORM_GROUPED if not fast else cim_ops.FORM_GROUPED_DECODE
            if cap <= cim_ops.GROUPED_DECODE_MAX_CAP
            else cim_ops.FORM_GROUPED_PREFILL)
    assert geom.form == want and geom.experts == E and geom.M == cap
    assert geom.gz == (min(E, A) if fast else E)
    assert geom.smem <= cim_ops.SMEM_MAX
    hits, spans = _grouped_writes(geom, offsets, A)
    done = np.zeros((A, N), bool)
    for e in range(E):
        done[offsets[e]:offsets[e] + min(counts[e], cap)] = True
    assert (hits[done] == 1).all() and (hits[~done] == 0).all()
    assert spans and all(all(len(r) > 0 for r in ranks) and
                         [i for r in ranks for i in r] == list(range(I))
                         for ranks in spans)
    if geom.form == cim_ops.FORM_GROUPED_DECODE:
        assert geom.gy in (1, 2, 4, 8) and geom.mt == \
            cim_ops.GROUPED_DECODE_RB
        assert cim_ops.GROUPED_DECODE_BLOCKS * (geom.smem + 1024) \
            <= 228 * 1024
        ring = 4 * geom.off_t
        slices = cim_ops.THREADS // (geom.tile // 8)
        assert slices * geom.mt * geom.tile * 4 <= ring
        assert geom.off_p % 4 == 0 and geom.off_p - geom.off_t >= \
            wpt << bits
    if geom.form == cim_ops.FORM_GROUPED_PREFILL:
        assert geom.gy in (1, 2, 4, 8)
        # A split's sums, [64][256] floats, fit in the ring.
        assert geom.smem - 4 * (wpt << bits) >= 64 * cim_ops.THREADS * 4
        if xbf16:
            assert 2 * (geom.smem + 1024) <= 228 * 1024


def test_cim_grouped_form_by_capacity():
    """The grouped forms' choice: the decode form up to a capacity of
    GROUPED_DECODE_MAX_CAP = 32 (qwen2-moe's decode step, cap 16, and
    ContinuousEngine(capacity=8) x top-4, cap 32), the tensor-core prefill
    form above (qwen2-moe's prefill, cap 128); the general form off the
    16-byte path (wpt not a multiple of 8, or codes off 16 bytes); the
    decode form's I split 8 ways at qwen2-moe's 2048 and 1408 and less
    for a short I; min(E, A) expert slots."""
    g = lambda cap, A=None, I=2048, wpt=8, aligned=True: \
        cim_ops.grouped_geometry(60, cap, I, 1408, 1408, wpt, 8, 8 * wpt,
                                 False, aligned, True, A)
    assert cim_ops.GROUPED_DECODE_MAX_CAP == 32
    assert [g(c).form for c in (1, 16, 32, 33, 128, 512)] == [
        cim_ops.FORM_GROUPED_DECODE] * 3 + [cim_ops.FORM_GROUPED_PREFILL] * 3
    assert g(16, aligned=False).form == cim_ops.FORM_GROUPED
    assert g(128, wpt=2).form == cim_ops.FORM_GROUPED
    assert [g(16, I=I).gy for I in (2048, 1408, 256, 128, 64, 32)] == [
        8, 8, 4, 2, 1, 1]
    assert (g(16, 17).gz, g(128, 2049).gz, g(32).gz) == (17, 60, 60)
    assert g(16, 17).gx == g(128).gx == 11
    # The prefill form splits I only where the rows fill few experts: one
    # expert at the capacity (A = 129) 8 ways, qwen2-moe's prefill (2,048
    # rows, at least 16 experts' 11 column tiles) not at all.
    assert [g(128, A).gy for A in (129, 257, 513, 2049)] == [8, 8, 4, 1]
    assert g(128, 129, I=64).gy == 1


def _folded_geometry(E, I, N, cap, routing, xbf16, form):
    """A grouped folded launch at the routing of the grouped tests:
    (geometry, offsets, rows an expert, A)."""
    counts = _grouped_counts(routing, E, cap,
                             np.random.default_rng(len(routing) + cap))
    offsets = np.concatenate([[0], np.cumsum(counts)]).tolist()
    A = offsets[-1] + 1
    return (cim_ops.grouped_folded_geometry(E, cap, I, N, N, xbf16, True, A,
                                            form=form),
            offsets, counts, A)


_FOLDED_CASES = [
    (60, 2048, 1408, 16, "decode"), (60, 1408, 2048, 16, "decode"),
    (60, 2048, 1408, 32, "at cap"), (60, 2048, 1408, 128, "prefill"),
    (60, 1408, 2048, 128, "at cap"), (60, 2048, 1408, 128, "one expert"),
    (12, 200, 72, 9, "straddle"), (12, 200, 72, 300, "dropped"),
    (6, 200, 30, 16, "decode")]


@pytest.mark.parametrize("E,I,N,cap,routing", _FOLDED_CASES)
@pytest.mark.parametrize("form", [None, cim_ops.FORM_GROUPED_FOLDED,
                                  cim_ops.FORM_GROUPED_FOLDED_DECODE,
                                  cim_ops.FORM_GROUPED_FOLDED_PREFILL],
                         ids=["auto", "general", "decode", "prefill"])
@pytest.mark.parametrize("xbf16", [False, True])
def test_cim_grouped_folded_geometry_covers_each_output_once(
        E, I, N, cap, routing, form, xbf16):
    """Each grouped folded form (its own choice, or forced) writes every
    (expert, row below the capacity, column) of y exactly once and no
    other element; each (item, pass) sums every row of I exactly once,
    over the ranks of a split in rank order, each rank with a slab; the
    split is a cluster of at most 8 blocks; rows of ld = n_pad rounded up
    to 8 floats; min(E, A) expert slots."""
    geom, offsets, counts, A = _folded_geometry(E, I, N, cap, routing, xbf16,
                                                form)
    want = form if form is not None else (
        cim_ops.FORM_GROUPED_FOLDED_DECODE
        if cap <= cim_ops.GROUPED_FOLDED_DECODE_MAX_CAP
        else cim_ops.FORM_GROUPED_FOLDED_PREFILL)
    assert geom.form == want and geom.experts == E and geom.M == cap
    assert geom.gz == min(E, A) and geom.ld == cim_ops.folded_ld(N)
    assert geom.smem <= cim_ops.SMEM_MAX and len(geom.array) == 28
    if geom.form != cim_ops.FORM_GROUPED_FOLDED:
        assert geom.gy in (1, 2, 4, 8)
    hits, spans = _grouped_writes(geom, offsets, A)
    done = np.zeros((A, N), bool)
    for e in range(E):
        done[offsets[e]:offsets[e] + min(counts[e], cap)] = True
    assert (hits[done] == 1).all() and (hits[~done] == 0).all()
    assert spans and all(all(len(r) > 0 for r in ranks) and
                         [i for r in ranks for i in r] == list(range(I))
                         for ranks in spans)


def _folded_draws(geom, offsets):
    """The read-noise counters (expert, row of I, column // 4) that one
    call of a grouped folded form draws, with their counts: the decode
    form's Philox call for each of a thread's two 4-column pieces of a row
    (columns from 4 (t % 16) and 64 + 4 (t % 16) of the item, those past
    ld not drawn), once a pass; the prefill form's one call for each four
    columns of each slab row of I, once a pass; kernel.cu's loops
    restated."""
    E, I, S = geom.experts, geom.I, geom.gy
    W = -(-geom.ld // 4)
    draws = np.zeros((E, I * W), np.int64)
    tid = np.arange(cim_ops.THREADS)
    for item in _grouped_slots(offsets, geom.M, geom.gz):
        if item is None:
            continue
        e, _, rows = item
        rs, cs = [], []
        for bx in range(geom.gx):
            nb = bx * geom.tile
            decode = geom.form == cim_ops.FORM_GROUPED_FOLDED_DECODE
            bk = (cim_ops.GROUPED_DECODE_BK if decode
                  else cim_ops.GROUPED_PREFILL_BK)
            per = geom.mt if decode else 8 * cim_ops.GROUPED_PREFILL_NT
            n = -(-I // bk)
            for _ in range(0, rows, per):
                for r in range(S):
                    if decode:        # thread t: rows t // 16 + 16 j
                        k_lo = n * r // S * bk
                        k_hi = min(n * (r + 1) // S * bk, I)
                        j, t, h = np.meshgrid(
                            np.arange(-(-(k_hi - k_lo) // 16)), tid,
                            np.arange(2), indexing="ij")
                        i = k_lo + t // 16 + 16 * j
                        col = nb + 4 * (t % 16) + 64 * h
                        ok = (i < k_hi) & (col < geom.ld)
                    else:             # thread t: rows t // 32 + 8 it
                        kt, it, t = np.meshgrid(
                            np.arange(n * r // S, n * (r + 1) // S),
                            np.arange(4), tid, indexing="ij")
                        i = kt * bk + t // 32 + 8 * it
                        col = nb + 4 * (t % 32)
                        ok = (col < geom.ld) & (i < I)
                    rs.append(i[ok])
                    cs.append(col[ok] >> 2)
        draws[e] = np.bincount(np.concatenate(rs) * W + np.concatenate(cs),
                               minlength=I * W)
    return draws.reshape(E, I, W)


@pytest.mark.parametrize("E,I,N,cap,routing", [
    (60, 2048, 1408, 128, "prefill"), (60, 1408, 2048, 128, "at cap"),
    (60, 2048, 1408, 128, "one expert"), (12, 200, 72, 300, "dropped"),
    (60, 2048, 1408, 16, "decode"), (12, 200, 72, 9, "straddle")])
def test_cim_grouped_folded_noise_drawn_once(E, I, N, cap, routing):
    """Each weight's read noise is drawn once a pass of the form its
    geometry takes: at qwen2-moe's capacity 128 (the prefill form, every
    expert's rows in one pass) each (hit expert, row of I, group of four
    columns of the fold) counter exactly once a call, and none of an
    expert without rows; at decode (up to 4 rows a pass) once for each
    pass of the expert's rows, as at a capacity of 300 on the prefill
    form (128 rows a pass)."""
    geom, offsets, counts, A = _folded_geometry(E, I, N, cap, routing, True,
                                                None)
    draws = _folded_draws(geom, offsets)
    per = (geom.mt if geom.form == cim_ops.FORM_GROUPED_FOLDED_DECODE
           else 8 * cim_ops.GROUPED_PREFILL_NT)
    for e in range(E):
        passes = -(-min(counts[e], cap) // per)
        assert (draws[e] == passes).all(), (e, passes)
    if cap == 128:
        assert geom.form == cim_ops.FORM_GROUPED_FOLDED_PREFILL
        assert draws.max() == 1


@pytest.mark.parametrize("I,N", [(2048, 1408), (1408, 2048), (200, 72),
                                 (5632, 2048)])
@pytest.mark.parametrize("xbf16", [False, True])
def test_cim_grouped_folded_shared_memory_fits(I, N, xbf16):
    """Each new grouped folded form's shared memory fits the blocks a SM
    it is built for (228 KB an SM less 1 KB a block): the decode form
    GROUPED_FOLDED_DECODE_BLOCKS, the prefill form two with bf16 x and
    one with f32 x; the decode form's rings (32 bytes a thread a stage)
    hold the row slices' sums and end where the x slab starts; the
    prefill form's ring holds a split's sums, [64][256] floats, and its
    stages keep 16-byte rows."""
    dec = cim_ops.grouped_folded_geometry(60, 16, I, N, N, xbf16, True, 17)
    assert dec.form == cim_ops.FORM_GROUPED_FOLDED_DECODE
    assert cim_ops.GROUPED_FOLDED_DECODE_BLOCKS * (dec.smem + 1024) \
        <= 228 * 1024
    ring = cim_ops.GROUPED_FOLDED_DECODE_STAGES * cim_ops.THREADS * 32
    slices = cim_ops.THREADS // (dec.tile // 8)
    assert 4 * dec.off_p == ring >= slices * dec.mt * dec.tile * 4
    assert dec.smem == 4 * (dec.off_p + dec.rps * dec.mt + dec.mt * dec.tile)
    pre = cim_ops.grouped_folded_geometry(60, 128, I, N, N, xbf16, True,
                                          2049)
    assert pre.form == cim_ops.FORM_GROUPED_FOLDED_PREFILL
    assert (2 if xbf16 else 1) * (pre.smem + 1024) <= 228 * 1024
    assert pre.smem >= 4 * cim_ops.GROUPED_PREFILL_NT * cim_ops.THREADS * 4
    stage = pre.smem // cim_ops.GROUPED_FOLDED_PREFILL_STAGES
    wld = (cim_ops.GROUPED_FOLDED_PREFILL_WLDB if xbf16
           else cim_ops.GROUPED_FOLDED_PREFILL_WLD)
    assert stage % 16 == 0 and (wld * 4) % 16 == 0
    # The k rows a lane reads in a k step (bf16: 2tq, 2tq + 1; f32: tq,
    # tq + 4) start on banks 8 tq apart, so a half-warp's float2 reads
    # of 8 columns each meet no bank twice.
    rows = [(2 * tq, 2 * tq + 1) if xbf16 else (tq, tq + 4)
            for tq in range(4)]
    for h in (0, 1):
        banks = [(rows[tq][h] * wld + 2 * gq + u) % 32
                 for tq in range(4) for gq in range(4) for u in (0, 1)]
        assert len(set(banks)) == 32


def test_cim_grouped_folded_form_by_capacity():
    """The grouped folded forms' choice: the decode form up to a capacity
    of GROUPED_FOLDED_DECODE_MAX_CAP (qwen2-moe's decode step, cap 16, and
    ContinuousEngine(capacity=8) x top-4, cap 32), the tensor-core
    prefill form above (qwen2-moe's prefill, cap 128); the general form
    where the decode form's x slab does not fit (a very long I), for a
    noiseless read at cap <= 32 whose slots x column tiles fill the
    decode form's blocks on the card (the cap-32 down product: 33 x 16 >=
    3 x 132), and wherever it is forced; a forced decode form that does
    not fit raises, as does a form that is not a grouped folded form.
    The decode form's I split 4 ways at qwen2-moe's 2048 and 1408, less
    for a short I (four slabs of 16 rows a rank), 8 ways where a split
    of 4 would leave an x slab too long for three blocks a SM; the
    prefill form's only where the rows fill few experts; min(E, A)
    expert slots."""
    g = lambda cap, A=None, I=2048, bf=True, form=None: \
        cim_ops.grouped_folded_geometry(60, cap, I, 1408, 1408, bf, True, A,
                                        form=form)
    assert cim_ops.GROUPED_FOLDED_DECODE_MAX_CAP == 32
    assert [g(c).form for c in (1, 16, 32, 33, 128, 512)] == [
        cim_ops.FORM_GROUPED_FOLDED_DECODE] * 3 + [
        cim_ops.FORM_GROUPED_FOLDED_PREFILL] * 3
    assert g(16, I=100_000).form == cim_ops.FORM_GROUPED_FOLDED
    assert g(16, I=100_000).gy == 1
    for f in cim_ops.GROUPED_FOLDED_FORMS:
        assert g(16, form=f).form == g(128, form=f).form == f
    with pytest.raises(ValueError, match="does not fit"):
        g(16, I=100_000, form=cim_ops.FORM_GROUPED_FOLDED_DECODE)
    with pytest.raises(ValueError, match="not a grouped folded form"):
        g(16, form=cim_ops.FORM_GROUPED_DECODE)
    assert [g(16, I=I).gy for I in (2048, 1408, 256, 128, 64, 32, 12000)
            ] == [4, 4, 4, 2, 1, 1, 8]
    down = lambda noise, A: cim_ops.grouped_folded_geometry(
        60, 32, 1408, 2048, 2048, True, noise, A).form
    assert (down(False, 33), down(True, 33), down(False, 17)) == (
        cim_ops.FORM_GROUPED_FOLDED, cim_ops.FORM_GROUPED_FOLDED_DECODE,
        cim_ops.FORM_GROUPED_FOLDED_DECODE)
    assert (g(16, 17).gz, g(128, 2049).gz, g(32).gz) == (17, 60, 60)
    assert g(16, 17).gx == g(128).gx == 11
    assert [g(128, A).gy for A in (129, 257, 513, 2049)] == [8, 8, 4, 1]
    assert [g(128, A, bf=False).gy for A in (129, 257, 2049)] == [8, 4, 1]
    assert g(128, 129, I=64).gy == 1


@pytest.mark.parametrize("C", [1, 31, 32, 100, 160, 1000])
def test_flash_geometry_covers_each_key_once(C):
    parts = _flash_decode_parts(C)
    assert len(parts) == 4 * flash_ops.DECODE_WARPS
    assert sorted(c for p in parts for c in p) == list(range(C))
    assert all(p == sorted(p) for p in parts)
    for Sq, form, gx in ((1, 0, 1), (16, 0, 16), (17, 1, 1), (128, 1, 2)):
        geom = flash_ops.flash_geometry(Sq)
        assert (geom.form, geom.gx) == (form, gx)


def _flash_bf16_decode_keys(geom, C):
    """The keys each lane group of the bf16 decode form sums, in the
    order the partials merge: cluster ranks 0..split-1, then groups
    0..gph-1 of a head; each list in the group's order of visits.  Rank
    r owns [r * kpr, (r + 1) * kpr); its group u takes keys k0 + u + gph
    t, in rounds of BF16_ROUND keys."""
    gph = flash_ops.groups_per_head(geom.heads)
    out = []
    for rank in range(geom.gx):
        k0 = min(rank * geom.kpr, C)
        k1 = min(k0 + geom.kpr, C)
        nk = [max(0, -(-(k1 - k0 - u) // gph)) for u in range(gph)]
        rounds = -(-max(nk) // flash_ops.BF16_ROUND) if nk else 0
        for u in range(gph):
            out.append([k0 + u + gph * t
                        for r in range(rounds)
                        for t in range(r * flash_ops.BF16_ROUND,
                                       (r + 1) * flash_ops.BF16_ROUND)
                        if t < nk[u]])
    return out


@pytest.mark.parametrize("G", [1, 2, 3, 12])
@pytest.mark.parametrize("C", [1, 31, 160, 1000, 4096])
def test_flash_bf16_decode_split_covers_each_key_once(C, G):
    """The bf16 decode form: every key once, in rank order, for every
    query head of a KV head; within the card's shared memory; a cluster
    of at most 8 blocks."""
    Dh, Hkv = 96, 2
    geom = flash_ops.flash_geometry(1, True, 4, G * Hkv, Hkv, C, Dh)
    assert geom.form == flash_ops.FORM_DECODE_BF16
    parts = _flash_bf16_decode_keys(geom, C)
    assert sorted(c for p in parts for c in p) == list(range(C))
    assert all(p == sorted(p) for p in parts)
    gph = flash_ops.groups_per_head(geom.heads)
    ranks = [sorted(c for p in parts[r * gph:(r + 1) * gph] for c in p)
             for r in range(geom.gx)]
    flat = [c for r in ranks for c in r]
    assert flat == sorted(flat)                  # rank order
    # Query heads: head chunks of ``heads`` cover the G heads once.
    n_hc = geom.gy // Hkv
    heads = [hc * geom.heads + i for hc in range(n_hc)
             for i in range(min(geom.heads, G - hc * geom.heads))]
    assert heads == list(range(G))
    assert 1 <= geom.gx <= flash_ops.BF16_MAX_SPLIT
    assert geom.smem == flash_ops.decode_bf16_smem(96)
    assert geom.smem <= 227 * 1024 // 2          # two blocks a SM
    # The whole slab in flight where a group's keys fit its rounds:
    # phi3's decode (C = 160) is one block, 5 keys a group in 3 rounds of
    # 2; the long cache a cluster of 8 blocks of 512 keys.
    per_group = max(len(p) for p in parts)
    if C <= flash_ops.BF16_DECODE_KEYS:
        assert geom.gx == 1
        if G == 1:
            assert per_group <= flash_ops.BF16_ROUND * flash_ops.BF16_ROUNDS
    if C == 4096:
        assert (geom.gx, geom.kpr) == (8, 512)


@pytest.mark.parametrize("B,Sq,H", [(4, 128, 32), (1, 128, 32), (3, 70, 4),
                                   (2, 17, 6), (64, 1000, 32)])
def test_flash_bf16_prefill_geometry_covers_each_query_once(B, Sq, H):
    """The bf16 prefill form: warp w of block x owns rows x * QB + 16 w
    .. + 15, every query row once."""
    geom = flash_ops.flash_geometry(Sq, True, B, H, H, 160, 96)
    assert geom.form == flash_ops.FORM_PREFILL_BF16
    warps = flash_ops.BF16_PREFILL_WARPS
    assert geom.threads == 32 * warps
    qb = 16 * warps
    rows = [x * qb + 16 * w + r for x in range(geom.gx)
            for w in range(warps) for r in range(16)]
    assert [r for r in rows if r < Sq] == list(range(Sq))
    assert (geom.gy, geom.gz) == (H, B)
    assert geom.smem <= 227 * 1024


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _pieces(p: torch.Tensor, n: int) -> list[torch.Tensor]:
    """p as n bf16 pieces, largest first: each the rounding of what the
    pieces before it leave (kernel.cu's split3)."""
    out = []
    for _ in range(n):
        out.append(_bf16(p))
        p = p - out[-1]
    return out


def test_bf16_three_pieces_are_exact():
    """hi + mid + lo == P bit for bit for P in (0, 1] over 60 binades;
    lo is itself a bf16 value (its rounding changes nothing)."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy((rng.random(200_000) * 2.0 ** -rng.integers(
        0, 60, 200_000)).astype(np.float32))
    p = p[p > 0]
    hi, mid, lo = _pieces(p, 3)
    assert torch.equal(hi + mid + lo, p)
    assert torch.equal((hi.double() + mid.double() + lo.double()),
                       p.double())
    assert torch.equal(_bf16(p - hi - mid), p - hi - mid)
    assert not torch.equal(hi + mid, p)           # two pieces lose bits


def test_bf16_qk_products_are_exact():
    """Q.K^T in one bf16 product: every product of two bf16 values is
    exact in f32 (8 + 8 significant bits), so the tensor core sums the
    same terms as the reference's f32 arithmetic on the widened values;
    only the order of the f32 additions differs, within f32's rounding of
    the sum."""
    q, k, _ = (_bf16(torch.from_numpy(a)) for a in _qkv(1, 64, 64, 1, 1,
                                                          96, 4))
    q, k = q[0, :, 0], k[0, :, 0]
    terms = q[:, None, :] * k[None, :, :]
    assert torch.equal(terms.double(), q.double()[:, None, :]
                       * k.double()[None, :, :])
    exact = q.double() @ k.double().T
    s32 = q @ k.T
    assert ((s32.double() - exact).abs()
            <= 96 * 2.0 ** -24 * terms.abs().sum(-1).double()).all()


def test_bf16_pieces_meet_the_flash_bound_and_fewer_do_not():
    """phi3's prefill (B=4, Sq=128, C=160 with 32 EMPTY_POS slots, H=32,
    Dh=96), q, k, v rounded to bf16, V x 16: O = P.V with P in three
    bf16 pieces (products exact, f32 sums, the small pieces first) meets
    |o - y| <= 2e-5 (1 + |y|) against the float64 attention; one or two
    pieces do not."""
    q, k, v = (_bf16(torch.from_numpy(a))
               for a in _qkv(4, 128, 160, 32, 32, 96, 0))
    v = v * 16
    kpos = torch.full((160,), EMPTY_POS, dtype=torch.int32)
    kpos[:128] = torch.arange(128, dtype=torch.int32)
    qpos = torch.arange(128, dtype=torch.int32)
    valid = kpos[None, :] <= qpos[:, None]
    s = torch.einsum("bqhd,bchd->bhqc", q, k) * 96 ** -0.5
    s = torch.where(valid, s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    qd, kd, vd = q.double(), k.double(), v.double()
    sd = torch.einsum("bqhd,bchd->bhqc", qd, kd) * 96 ** -0.5
    sd = torch.where(valid, sd, torch.tensor(-1e30, dtype=torch.float64))
    pd = torch.exp(sd - sd.amax(-1, keepdim=True))
    y = torch.einsum("bhqc,bchd->bhqd", pd, vd) / pd.sum(-1, keepdim=True)

    def excess(n):
        o = torch.zeros_like(y, dtype=torch.float32)
        for piece in reversed(_pieces(p, n)):
            o = o + torch.einsum("bhqc,bchd->bhqd", piece, v)
        return ((o / l).double() - y).abs().sub(2e-5 * (1 + y.abs())).max()

    assert excess(3) <= 0
    assert excess(2) > 0
    assert excess(1) > 0


# ---------------- why the tensor-core kernels pay for 3xTF32 ---------------

def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), nearest, ties away from
    zero: cvt.rna.tf32.f32, by bit operations."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(t):
    hi = _tf32_rna(t)
    return hi, _tf32_rna(t - hi)


def _mm3(a, b):
    """a @ b in 3xTF32: each product of TF32 parts exact in f32, sums in
    f32, the small products first."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def test_tf32_rounding_is_rna():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -12], dtype=torch.float32)
    assert _tf32_rna(x).tolist() == [1.0 + 2 ** -10, 1.0,
                                     -(1.0 + 2 ** -10), 1.0 + 2 ** -10]


def test_3xtf32_meets_the_cim_bound_and_one_pass_does_not():
    """At I = 8192 (phi3's ffn_w_down) the card bound max|kernel - plain|
    <= 1e-5 max|plain| holds for 3xTF32 and fails for one TF32 pass."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((8192, 256)) * 0.02)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 8192)).astype(np.float32))
    dep, _ = deploy(w, CrossbarSpec(64, 64, 8), "mdm")
    w_eff = cim_effective_weights(dep.codes, dep.pos, dep.scale,
                                  n_bits=8, wpt=8, cols=64, eta=dep.eta,
                                  reversed_df=dep.reversed_df)
    plain = x @ w_eff
    tol = 1e-5 * plain.abs().max()
    assert (_mm3(x, w_eff) - plain).abs().max() <= tol
    assert (_tf32_rna(x) @ _tf32_rna(w_eff) - plain).abs().max() > tol


def _attention(q, k, v, qpos, kpos, mm):
    """Masked softmax attention, B x H heads, products through ``mm``."""
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * q.shape[-1] ** -0.5
    valid = kpos[None, :] <= qpos[:, None]
    s = torch.where(valid, s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm(p, v.transpose(1, 2)) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2)


def test_3xtf32_meets_the_flash_bound_and_one_pass_does_not():
    """phi3 prefill (B=4, Sq=128, C=160 with 32 EMPTY_POS slots, H=32,
    Dh=96): |kernel - plain| <= 2e-5 (1 + |plain|) holds for 3xTF32 and
    fails for one TF32 pass."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 128, 160, 32, 32, 96, 0))
    kpos = torch.full((160,), EMPTY_POS, dtype=torch.int32)
    kpos[:128] = torch.arange(128, dtype=torch.int32)
    qpos = torch.arange(128, dtype=torch.int32)
    plain = flash_attention_plain(q, k, v, qpos, kpos)
    excess = lambda o: ((o - plain).abs() - 2e-5 * (1 + plain.abs())).max()
    assert excess(_attention(q, k, v, qpos, kpos, _mm3)) <= 0
    one = lambda a, b: _tf32_rna(a) @ _tf32_rna(b)
    assert excess(_attention(q, k, v, qpos, kpos, one)) > 0


# ------------- manhattan_score: the vector form's integer arithmetic --------

from repro_torch.kernels.manhattan_score import ops as score_ops
from repro_torch.kernels.slstm_scan import ops as scan_ops


def _bytes(w, e):
    return (w >> np.uint32(8 * e)) & np.uint32(0xFF)


def _dp4a(a, b, c):
    """__dp4a on uint32 arrays: c + the sum of the four byte products."""
    return c + sum(_bytes(a, e) * _bytes(b, e) for e in range(4))


def _vcmpne4_zero(w):
    """__vcmpne4(w, 0) & 0x01010101: 1 in each byte that is nonzero."""
    return sum(((_bytes(w, e) != 0).astype(np.uint32) << np.uint32(8 * e))
               for e in range(4))


def _score_vector_form(masks, nf_unit, reverse=False, row_position=None):
    """kernel.cu's vector form restated in numpy: each row read as
    16-byte chunks of four little-endian words, bytes normalised with
    vcmpne4, counts and column sums by dp4a against 0x01010101 and the
    packed column indices, the row's chunks summed (its lanes'
    shuffles), s_rev = n (C - 1) - s, then the integer distance."""
    T, R, C = masks.shape
    assert C in score_ops.VECTOR_COLS
    words = np.ascontiguousarray(masks).view("<u4").reshape(T, R, C // 4)
    col0 = 4 * np.arange(C // 4, dtype=np.uint32)
    idx = col0 * np.uint32(0x01010101) + np.uint32(0x03020100)
    b = _vcmpne4_zero(words)
    zero = np.zeros_like(words)
    n = _dp4a(b, np.uint32(0x01010101), zero).sum(-1, dtype=np.int64)
    s = _dp4a(b, idx, zero).sum(-1, dtype=np.int64)
    if reverse:
        s = n * (C - 1) - s
    p = (np.arange(R)[None, :] if row_position is None
         else row_position.astype(np.int64))
    dist = (p * n + s).sum(-1)
    return ((n + s).astype(np.float32), n.astype(np.float32),
            np.float32(nf_unit) * dist.astype(np.float32))


@pytest.mark.parametrize("t,r,c,seed", [
    (3, 64, 64, 0), (5, 32, 32, 1), (4, 16, 16, 2), (2, 8, 128, 3),
    (2, 4, 256, 4), (6, 64, 16, 5),
])
def test_manhattan_vector_form_arithmetic_matches_reference(t, r, c, seed):
    """The vector form's arithmetic on masks with bytes 0, 1, 2 and 255
    equals the JAX reference on their 0/1 normalisation, bit for bit, in
    the planner's three variants: raw, reversed (the reference on the
    mirrored masks) and reversed and placed (on the mirrored, permuted
    masks)."""
    rng = np.random.default_rng(seed)
    m = rng.choice(np.array([0, 1, 2, 255], np.uint8), size=(t, r, c),
                   p=[0.6, 0.2, 0.1, 0.1])
    ones = (m != 0).astype(np.uint8)
    mirrored = ones[..., ::-1].copy()
    perm = np.stack([rng.permutation(r) for _ in range(t)])
    position = np.argsort(perm, -1).astype(np.int32)
    placed = np.take_along_axis(mirrored, perm[..., None], axis=1)
    cases = [(dict(), j_score(jnp.asarray(ones), nf_unit=NF_UNIT)),
             (dict(reverse=True), j_score(jnp.asarray(mirrored),
                                          nf_unit=NF_UNIT))]
    s_rev, n_rev, _ = cases[1][1]
    _, _, nf_placed = j_score(jnp.asarray(placed), nf_unit=NF_UNIT)
    cases.append((dict(reverse=True, row_position=position),
                  (s_rev, n_rev, nf_placed)))
    for kw, want in cases:
        got = _score_vector_form(m, NF_UNIT, **kw)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(w))
        # The plain version, on the CPU, counts any nonzero byte as 1 too.
        tp = manhattan_score(
            torch.from_numpy(m), NF_UNIT, reverse=kw.get("reverse", False),
            row_position=(None if "row_position" not in kw
                          else torch.from_numpy(kw["row_position"])),
            device=CPU)
        for a, w in zip(tp, got):
            np.testing.assert_array_equal(a.numpy(), w)


def test_manhattan_score_form_by_shape_and_alignment():
    """16-byte loads where a row is whole chunks of a power-of-two lane
    group and packed indices fit a byte; bytes elsewhere."""
    vec, byte = score_ops.VECTOR_FORM, score_ops.BYTE_FORM
    for c in (16, 32, 64, 128, 256):
        assert score_ops.score_form(c, True) == vec
        assert score_ops.score_form(c, False) == byte
    for c in (4, 8, 48, 70, 80, 96, 512):
        assert score_ops.score_form(c, True) == byte
    # kernel.cu takes form 1 as the vector form, anything else as bytes.
    cu = Path(score_ops.__file__).with_name("kernel.cu").read_text()
    assert "if (form == 1) {" in cu and (byte, vec) == (0, 1)


# ------------------------ slstm_scan launch geometry ------------------------

def test_slstm_geometry_constants_mirror_the_kernel():
    cu = Path(scan_ops.__file__).with_name("kernel.cu")
    assert _cu_constant(cu, "CLUSTER") == scan_ops.CLUSTER
    assert _cu_constant(cu, "COLG") == scan_ops.MAX_PER
    assert _cu_constant(cu, "KS") == scan_ops.KS
    assert _cu_constant(cu, "LANES") == scan_ops.LANES
    assert _cu_constant(cu, "MAX_LANES") == scan_ops.MAX_LANES
    assert _cu_constant(cu, "RR") == scan_ops.REG_ROWS
    assert _cu_constant(cu, "SMEM_MAX") == scan_ops.SMEM_MAX
    assert scan_ops.KS * scan_ops.MAX_PER == scan_ops.THREADS
    fields = re.search(r"struct Geom \{\s*int ([^;]*);",
                       cu.read_text()).group(1)
    assert tuple(f.strip() for f in fields.split(",")) == \
        scan_ops._GEOM_FIELDS


def _scan_tiers(geom, Dh):
    """kernel.cu's split of R[h]: for each block rank, its dims, and for
    each k slice, its register, shared and L2 rows."""
    ranks = []
    for rank in range(scan_ops.CLUSTER):
        d0 = min(Dh, rank * geom.per)
        ranks.append(range(d0, min(Dh, d0 + geom.per)))
    slices = []
    for s in range(scan_ops.KS):
        k0 = min(Dh, s * geom.kper)
        k1 = min(Dh, k0 + geom.kper)
        nreg = min(geom.reg_rows, k1 - k0)
        nsm = min(geom.sm_rows, k1 - k0 - nreg)
        slices.append((range(k0, k0 + nreg), range(k0 + nreg, k0 + nreg + nsm),
                       range(k0 + nreg + nsm, k1)))
    return ranks, slices


@pytest.mark.parametrize("B", [1, 2, 4, 5, 8, 9, 33])
def test_slstm_geometry_fits_and_covers_every_head_dim(B):
    """For every Dh a multiple of 4 up to 512: the shared memory fits a
    block, the blocks' dims cover [0, Dh) once in multiples of 4, the
    slices' register, shared and L2 rows cover [0, Dh) once, the lane
    groups cover B."""
    for Dh in range(4, scan_ops.MAX_HEAD_DIM + 1, 4):
        g = scan_ops.slstm_geometry(B, Dh)
        assert g.smem <= scan_ops.SMEM_MAX
        assert 0 < g.per <= scan_ops.MAX_PER and g.per % 4 == 0
        assert 0 <= g.reg_rows <= scan_ops.REG_ROWS and g.sm_rows >= 0
        assert g.lanes <= scan_ops.MAX_LANES and g.lanes_p % 4 == 0
        assert g.lanes_p >= g.lanes and g.groups * g.lanes >= B
        assert (g.groups - 1) * g.lanes < B
        ranks, slices = _scan_tiers(g, Dh)
        dims = [d for r in ranks for d in r]
        assert dims == list(range(Dh))
        assert all(len(r) % 4 == 0 for r in ranks)
        rows = [k for tiers in slices for tier in tiers for k in tier]
        assert rows == list(range(Dh))
        ncols = 4 * g.per
        box = -(-g.sm_rows * g.per // 32) * 32       # 128-byte TMA boxes
        assert g.smem == 4 * (scan_ops.KS * 4 * box
                              + 2 * Dh * g.lanes_p
                              + scan_ops.KS * scan_ops.LANES * ncols
                              + g.per * g.lanes_p) + scan_ops.MBAR_BYTES
        # As many shared rows as fit, the rest from L2.
        if g.reg_rows + g.sm_rows < g.kper:
            other = (2 * Dh * g.lanes_p + scan_ops.KS * scan_ops.LANES * ncols
                     + g.per * g.lanes_p)
            assert scan_ops._smem(other, g.sm_rows + 1, g.per) \
                > scan_ops.SMEM_MAX



def test_slstm_geometry_keeps_xlstm_r_on_chip():
    """At xlstm-1.3b's decode and prefill shape (B = 4, Dh = 512) no row
    of R is read from L2: 10 rows a slice in registers, 22 in shared
    memory; with 5-8 lanes two rows a slice come from L2."""
    g = scan_ops.slstm_geometry(4, 512)
    assert (g.per, g.kper, g.reg_rows, g.sm_rows) == (32, 32, 10, 22)
    _, slices = _scan_tiers(g, 512)
    assert all(len(l2) == 0 for _, _, l2 in slices)
    g8 = scan_ops.slstm_geometry(8, 512)
    assert g8.sm_rows == 20 and g8.groups == 1
    assert scan_ops.slstm_geometry(9, 512).groups == 2


def test_slstm_tiled_sum_matches_the_plain_step():
    """One step's h @ R summed as kernel.cu sums it (per block rank and
    gate column, slice by slice in order, each slice's register, shared
    and L2 rows in order) equals the plain version's product within the
    card bound."""
    rng = np.random.default_rng(3)
    B, Dh = 3, 100
    g = scan_ops.slstm_geometry(B, Dh)
    h = rng.standard_normal((B, Dh)).astype(np.float32)
    r = (rng.standard_normal((Dh, 4 * Dh)) * 0.1).astype(np.float32)
    ranks, slices = _scan_tiers(g, Dh)
    pre = np.zeros((B, 4 * Dh), np.float32)
    for dims in ranks:
        cols = [q * Dh + d for q in range(4) for d in dims]
        total = np.zeros((B, len(cols)), np.float32)
        for tiers in slices:
            acc = np.zeros((B, len(cols)), np.float32)
            for tier in tiers:
                for k in tier:
                    acc = acc + h[:, k:k + 1] * r[k, cols]
            total = total + acc
        pre[:, cols] = total
    plain = (torch.from_numpy(h) @ torch.from_numpy(r)).numpy()
    assert (np.abs(pre - plain) <= 1e-5 * (1 + np.abs(plain))).all()


@pytest.mark.parametrize("B,Dh", [(4, 2), (4, 6), (4, 516), (4, 0), (0, 64)])
def test_slstm_geometry_refuses_what_the_kernel_does_not_take(B, Dh):
    with pytest.raises(ValueError, match="slstm_scan kernel takes"):
        scan_ops.slstm_geometry(B, Dh)


# ------------------------ line_solve launch geometry ------------------------

from repro_torch.kernels.line_solve import ops as line_ops

LINE_SIDES = (1, 2, 3, 10, 17, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129,
              200, 255, 256)


def test_line_geometry_mirrors_the_kernel():
    """The Python geometry mirrors kernel.cu: the Geom struct's fields in
    order, the forms' numbers and the threads a block the kernel allows."""
    text = Path(line_ops.__file__).with_name("kernel.cu").read_text()
    fields = re.search(r"struct Geom \{\s*int ([^;]*);", text).group(1)
    assert tuple(f.strip() for f in fields.split(",")) == line_ops.GEOM_FIELDS
    assert re.search(r"constexpr int FAST = 0, STREAM = 1;", text)
    assert line_ops.FORMS == ("fast", "stream")
    assert _cu_constant(Path(line_ops.__file__).with_name("kernel.cu"),
                        "MAX_THREADS") == 16 * 32 == 2 * line_ops.MAX_SIDE
    assert re.search(rf"J > {line_ops.MAX_SIDE} \|\| K > {line_ops.MAX_SIDE}",
                     text)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", LINE_SIDES)
def test_line_geometry_fits_every_crossbar(J, dtype):
    """Every crossbar up to 256x256 gets a launch whose shared memory fits
    a block: the fast form where its planes fit (factor in registers for
    the compiled squares; an odd pitch, or K for short aligned rows),
    else the stream form; a second slot only where it fits too."""
    word = 8 if dtype == torch.float64 else 4
    for K in range(1, line_ops.MAX_SIDE + 1):
        geom = line_ops.line_geometry(J, K, dtype)
        assert 0 < geom["smem"] <= line_ops.MAX_SMEM
        assert geom["threads"] == 32 * (-(-J // 32) + -(-K // 32)) <= 512
        assert geom["f64"] == (word == 8) and geom["grid"] == 0
        reg = J == K and J in line_ops.REG_LENGTHS[dtype]
        planes = 3 if reg else 5
        vec = 16 // word
        short = K <= line_ops.SHORT_ROW and K % vec == 0
        pitch = K if short else K | 1
        if planes * J * pitch * word <= line_ops.MAX_SMEM:
            assert line_ops.FORMS[geom["form"]] == "fast"
            assert geom["reg_len"] == (J if reg else 0)
            assert geom["pitch"] == pitch and geom["stages"] == 1
            assert geom["smem"] == planes * J * pitch * word
            assert geom["vec_load"] == (vec if short else 1)
            assert geom["vec_store"] == (vec if K % vec == 0 else 1)
            try:
                two = line_ops.line_geometry(J, K, dtype, stages=2)
            except ValueError:
                assert (planes + 3) * J * pitch * word > line_ops.MAX_SMEM
            else:
                assert two["smem"] == (planes + 3) * J * pitch * word
        else:
            assert line_ops.FORMS[geom["form"]] == "stream"
            assert geom["chunk"] == min(K, 128 // word)
            assert geom["reg_len"] == 0
            assert geom["smem"] == 4 * J * (geom["chunk"] + 1) * word


@pytest.mark.parametrize("J,K", [(257, 4), (4, 257), (0, 8), (300, 300)])
def test_line_geometry_refuses_past_the_limit(J, K):
    with pytest.raises(ValueError, match="at most 256x256"):
        line_ops.line_geometry(J, K, torch.float64)


def test_line_geometry_forms_on_request():
    """Forced forms and the checks on them: the stream form at any side,
    a fast form that does not fit and registers off the compiled squares
    refused."""
    g = line_ops.line_geometry(64, 64, torch.float64, form="stream")
    assert line_ops.FORMS[g["form"]] == "stream" and g["chunk"] == 16
    assert line_ops.line_geometry(128, 10, torch.float64,
                                  form="stream")["chunk"] == 10
    assert line_ops.line_geometry(128, 128, torch.float32)["reg_len"] == 128
    assert line_ops.FORMS[line_ops.line_geometry(
        128, 128, torch.float64)["form"]] == "stream"
    with pytest.raises(ValueError, match="shared memory"):
        line_ops.line_geometry(128, 128, torch.float64, form="fast")
    with pytest.raises(ValueError, match="registers"):
        line_ops.line_geometry(64, 32, torch.float64, registers=True)
    with pytest.raises(ValueError, match="shared memory"):
        line_ops.line_geometry(64, 64, torch.float64, registers=False,
                               stages=2)
    g = line_ops.line_geometry(64, 64, torch.float32, registers=False)
    assert g["reg_len"] == 0 and g["smem"] == 5 * 64 * 65 * 4
    with pytest.raises(ValueError, match="form"):
        line_ops.line_geometry(8, 8, torch.float64, form="slow")
