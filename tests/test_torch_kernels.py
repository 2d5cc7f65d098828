"""The port's kernels against the JAX reference (plain versions, CPU).

CPU parity bounds are the reference's own for the same function:
``manhattan_score`` rtol 1e-6 (tests/test_kernels.py), ``cim_mvm`` the
three-way rtol 1e-5 + atol 1e-6 (tests/test_cim_dispatch.py), flash
attention rtol = atol = 2e-5 (tests/test_kernels_perf.py).  The JAX
Pallas kernels run in interpret mode, as the reference's tests run them.
The CUDA kernels against their plain versions: tests/test_torch_cuda.py.
"""
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
from repro_torch.kernels.cim_mvm.ops import cim_mvm, deploy
from repro_torch.kernels.cim_mvm.ref import cim_mvm_ref
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
    import dataclasses

    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(3))
    dep, _ = deploy(w, CrossbarSpec(16, 16, 8))
    x = torch.randn(2, 16)
    for extra in ({"gain": torch.ones_like(dep.codes, dtype=torch.float32)},
                  {"col_pos": torch.zeros((1, 1, 16), dtype=torch.int32)},
                  {"sigma_read": 0.01}):
        with pytest.raises(NotImplementedError):
            cim_mvm(x, dataclasses.replace(dep, **extra), device=CPU)


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
