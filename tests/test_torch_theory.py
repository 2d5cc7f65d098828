"""Theorem 1 (bit-level structured sparsity) on the port: the reference's
property tests of ``tests/test_theory.py``, and ``repro_torch.core.theory``
held against ``repro.core.theory`` on the same inputs.

Inputs are drawn with numpy from a seed (the reference's tests draw with
``jax.random``); the port runs on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as jtheory
from repro.core.bitslice import bitslice as j_bitslice
from repro_torch.core import theory
from repro_torch.core.bitslice import bitslice

DENSITIES = [
    (lambda m: m.exponential(1.0), 1.0),
    (lambda m: m.exponential(3.0), 3.0),
    (lambda m: m.half_normal(0.5), np.sqrt(2 / np.pi) / 0.5),
    (lambda m: m.half_laplace(0.7), 1 / 0.7),
]


def _pk(make, k, **kw):
    return float(theory.p_k_quadrature(make(theory), k, device="cpu", **kw))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("make,f0", DENSITIES)
def test_theorem1_bound_quadrature(k, make, f0):
    """|p_k - 1/2| <= f(0)/2^(1+k) and p_k < 1/2, by quadrature; and the
    reference's quadrature of the same density at rtol 1e-5."""
    p = _pk(make, k)
    assert p < 0.5
    assert abs(p - 0.5) <= theory.theorem1_bound(f0, k) + 5e-4
    assert theory.theorem1_bound(f0, k) == jtheory.theorem1_bound(f0, k)
    want = float(jtheory.p_k_quadrature(make(jtheory), k))
    np.testing.assert_allclose(p, want, rtol=1e-5)


@pytest.mark.parametrize("sigma", [0.05, 0.3, 1.0, 2.0])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_theorem1_bound_empirical_halfnormal(sigma, k):
    """Sampled |w| ~ half-normal respects the bound within sampling
    noise; the port's estimate is the reference's on the same samples."""
    rng = np.random.default_rng(int(sigma * 1e4) + k)
    w = np.abs(rng.standard_normal(200_000) * sigma).astype(np.float32)
    p = float(theory.p_k_empirical(torch.from_numpy(w), k))
    assert p == float(jtheory.p_k_empirical(jnp.asarray(w), k))
    bound = theory.theorem1_bound(float(np.sqrt(2 / np.pi) / sigma), k)
    assert p < 0.5 + 0.01
    assert abs(p - 0.5) <= bound + 0.01


def test_pk_approaches_half():
    ps = [_pk(lambda m: m.exponential(1.0), k) for k in (1, 4, 8)]
    assert abs(ps[2] - 0.5) < abs(ps[0] - 0.5)
    assert abs(ps[2] - 0.5) < 1e-2


@pytest.mark.parametrize("n_bits", [4, 8])
def test_empirical_bit_densities_increase_with_k(n_bits):
    """The structured sparsity MDM exploits, bit for bit the reference's
    densities of the same weights."""
    w = (np.random.default_rng(0).standard_normal((512, 512)) * 0.1
         ).astype(np.float32)
    dens = theory.empirical_bit_densities(torch.from_numpy(w), n_bits)
    want = np.asarray(jtheory.empirical_bit_densities(jnp.asarray(w),
                                                      n_bits))
    assert dens.numpy().tobytes() == want.tobytes()
    d = dens.numpy()
    assert d[0] < d[-1]
    assert np.all(d < 0.55)
    if n_bits == 8:
        assert d[0] < 0.1


def test_bit_indicator_matches_bitslice_and_reference():
    """bit_indicator and bitslice agree on the quantised values, and the
    indicator is the reference's bit for bit."""
    w = np.random.default_rng(1).uniform(size=1000).astype(np.float32)
    n_bits = 6
    sliced = bitslice(torch.from_numpy(w), n_bits, scale=torch.tensor(1.0))
    q = np.clip(np.round(w * 2 ** n_bits) / 2 ** n_bits, 0,
                1 - 2.0 ** -n_bits).astype(np.float32)
    jsl = j_bitslice(jnp.asarray(w), n_bits, scale=jnp.asarray(1.0))
    for k in range(1, n_bits + 1):
        ind = theory.bit_indicator(torch.from_numpy(q), k)
        assert ind.dtype == torch.int32
        np.testing.assert_array_equal(ind.numpy(), sliced.bits[:, k - 1])
        np.testing.assert_array_equal(
            ind.numpy(), np.asarray(jtheory.bit_indicator(jnp.asarray(q), k)))
        np.testing.assert_array_equal(sliced.bits[:, k - 1],
                                      np.asarray(jsl.bits[:, k - 1]))


@pytest.mark.parametrize("make,_", DENSITIES)
def test_densities_match_reference(make, _):
    w = np.linspace(0.0, 8.0, 257, dtype=np.float32)
    got = make(theory)(torch.from_numpy(w)).numpy()
    want = np.asarray(make(jtheory)(jnp.asarray(w)))
    # atol: XLA flushes the f32 subnormals of the far tail to zero.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-37)


def test_quadrature_needs_a_named_device():
    """The grid runs on the card by default; without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        theory.p_k_quadrature(theory.exponential(1.0), 1)
