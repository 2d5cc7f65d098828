"""The port's recurrent mixers and its sLSTM-scan and bit-plane packing
kernels against the JAX reference (plain versions, CPU).

Bounds.  ``slstm_scan`` rtol 1e-5, atol 1e-6 on the reference's six
sweep cases (tests/test_kernels_perf.py); ``bitslice_pack`` exact on
its eight (tests/test_kernels.py), for int16 and int32 codes; the JAX
Pallas kernels run in interpret mode, as the reference's tests run them.
The mixers are held to max|port - reference| <= 1e-5 * max|reference|
per output, with the reference's own per-element rtol 1e-5 beside it:
both sides are f32 from the same weights and differ in summation order
(XLA's fused dots and scan against torch's matmuls and loop), which
moves outputs by ~1e-6 of their scale (a scratch run measured at most
2.9e-6 on outputs of scale 2.5), so a normwise bound is the honest one.
The CUDA kernels against their plain versions: tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitslice_pack import bitslice_pack as j_pack
from repro.kernels.bitslice_pack.ref import bitslice_pack_ref
from repro.kernels.slstm_scan import slstm_scan as j_scan
from repro.kernels.slstm_scan.ref import slstm_scan_ref
from repro.models import recurrent as jrec
from repro_torch.kernels.bitslice_pack import bitslice_pack
from repro_torch.kernels.bitslice_pack.ref import bitslice_pack_plain
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.kernels.slstm_scan.ref import slstm_scan_plain
from repro_torch.models import recurrent as trec

CPU = "cpu"
MIXER_RTOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    """Port vs reference at the mixer bound (see the module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=MIXER_RTOL,
        atol=MIXER_RTOL * max(float(np.abs(want).max()), 1e-30))


# ------------------------------ slstm_scan -------------------------------

SLSTM_CASES = [
    (1, 3, 1, 4, 0),        # minimal dims, t < chunk
    (5, 70, 4, 16, 1),      # strategy maxima, t spans many chunks
    (2, 16, 2, 8, 2),       # t == chunk exactly
    (3, 17, 1, 16, 3),      # one past a chunk boundary
    (1, 33, 4, 4, 42),
    (4, 15, 2, 8, 99),      # one short of a chunk boundary
]


def slstm_inputs(b, t, h, dh, seed):
    """The reference sweep's inputs and scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, t, h, 4 * dh, scale=0.5),
            _rand(rng, h, dh, 4 * dh, scale=0.1),
            _rand(rng, b, h, dh, scale=0.1),
            _rand(rng, b, h, dh, scale=0.1))


@pytest.mark.parametrize("b,t,h,dh,seed", SLSTM_CASES)
def test_slstm_scan_matches_reference(b, t, h, dh, seed):
    args = slstm_inputs(b, t, h, dh, seed)
    got = slstm_scan(*map(torch.from_numpy, args), device=CPU)
    j = [jnp.asarray(a) for a in args]
    kern = j_scan(*j, block_b=2, chunk=16, interpret=True)
    exact = slstm_scan_ref(*j)
    for ref in (kern, exact):
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,t,h,dh,seed", SLSTM_CASES[:4])
@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_slstm_scan_bf16_matches_reference(b, t, h, dh, seed, state):
    """bf16 gx and R (the reference's default dtype) with an f32 state
    (the serving form) or a bf16 one: the plain version against the
    reference's Pallas kernel in interpret mode on the same inputs,
    compared in f32.  Both widen bf16 exactly and compute in f32; the
    reference writes f32 outputs, the port the state's dtype, so with a
    bf16 state the port's outputs carry one more rounding (2^-8
    relative) beside the f32 bound."""
    args = slstm_inputs(b, t, h, dh, seed)
    dt = torch.bfloat16 if state == "bf16" else torch.float32
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in args[:2]] + \
        [torch.from_numpy(a).to(dt) for a in args[2:]]
    got = slstm_scan(*targs, device=CPU)
    jdt = jnp.bfloat16 if state == "bf16" else jnp.float32
    j = [jnp.asarray(a, jnp.bfloat16) for a in args[:2]] + \
        [jnp.asarray(a, jdt) for a in args[2:]]
    kern = j_scan(*j, block_b=2, chunk=16, interpret=True)
    rtol = 1e-5 if state == "f32" else 2.0 ** -8
    for a, r in zip(got, kern):
        assert a.dtype == dt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r, np.float32), rtol=rtol,
                                   atol=1e-6)


def test_slstm_scan_wrapper_checks_and_empty_sequence():
    gx, r, h0, c0 = map(torch.from_numpy, slstm_inputs(2, 0, 2, 4, 0))
    hs, hT, cT = slstm_scan(gx, r, h0, c0, device=CPU)
    assert hs.shape == (2, 0, 2, 4)
    assert torch.equal(hT, h0) and torch.equal(cT, c0)
    with pytest.raises(ValueError):
        slstm_scan(gx, r[:, :3], h0, c0, device=CPU)


# ----------------------------- bitslice_pack -----------------------------

PACK_CASES = [
    (1, 1, 4, False, 0),    # minimal dims
    (130, 70, 12, True, 1),  # strategy maxima
    (128, 64, 8, False, 2),  # power-of-two block fit
    (129, 65, 8, True, 3),  # one past the block
    (17, 33, 4, True, 4),
    (64, 1, 12, False, 5),
    (1, 70, 8, True, 42),
    (100, 23, 4, False, 99),
]


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("i,n,n_bits,rev,seed", PACK_CASES)
def test_bitslice_pack_matches_reference(i, n, n_bits, rev, seed, dtype):
    codes = np.random.default_rng(seed).integers(
        -(2 ** n_bits) + 1, 2 ** n_bits, (i, n)).astype(dtype)
    got = bitslice_pack(torch.from_numpy(codes), n_bits, rev, device=CPU)
    assert got.dtype == torch.uint8 and got.shape == (i, n, n_bits)
    jc = jnp.asarray(codes)
    for ref in (j_pack(jc, n_bits, rev, interpret=True),
                bitslice_pack_ref(jc, n_bits, rev)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bitslice_pack_planes_and_refusals():
    codes = torch.tensor([[5, -6], [0, 255]], dtype=torch.int16)
    planes = bitslice_pack_plain(codes, 8)
    assert planes[0, 0].tolist() == [0, 0, 0, 0, 0, 1, 0, 1]   # |5|, MSB first
    assert planes[0, 1].tolist() == [0, 0, 0, 0, 0, 1, 1, 0]   # |-6|
    assert torch.equal(bitslice_pack_plain(codes, 8, True), planes.flip(-1))
    with pytest.raises(TypeError):
        bitslice_pack(codes.to(torch.int64), 8, device=CPU)
    with pytest.raises(ValueError):
        bitslice_pack(codes, 0, device=CPU)


# ------------------------------- mixers ----------------------------------

def mlstm_params(rng, D, H, Di):
    Dh = Di // H
    return {"w_up": _rand(rng, D, 2 * Di, scale=D ** -0.5),
            "wq": _rand(rng, Di, H, Dh, scale=Di ** -0.5),
            "wk": _rand(rng, Di, H, Dh, scale=Di ** -0.5),
            "wv": _rand(rng, Di, H, Dh, scale=Di ** -0.5),
            "w_if": _rand(rng, Di, 2 * H, scale=0.3),
            "b_if": _rand(rng, 2 * H),
            "w_down": _rand(rng, Di, D, scale=Di ** -0.5)}


def _both(p, *arrays):
    """(jax params, torch params, jax arrays, torch arrays); None stays."""
    conv = lambda f, a: None if a is None else (
        tuple(f(x) for x in a) if isinstance(a, tuple) else f(a))
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()},
            [conv(jnp.asarray, a) for a in arrays],
            [conv(torch.from_numpy, a) for a in arrays])


@pytest.mark.parametrize("S,with_state,chunk", [
    (37, False, 16),        # prompt longer than the chunk, padded tail
    (37, True, 16),         # carried state through three chunks
    (32, True, 16),         # whole chunks
    (8, True, 16),          # one partial chunk
])
def test_mlstm_mixer_matches_reference(S, with_state, chunk):
    rng = np.random.default_rng(S + chunk)
    D, H, Di = 64, 2, 128
    p = mlstm_params(rng, D, H, Di)
    x = _rand(rng, 2, S, D)
    st = ((_rand(rng, 2, H, Di // H, Di // H, scale=0.1),
           _rand(rng, 2, H, Di // H, scale=0.1)) if with_state else None)
    jp, tp, (jx, jst), (tx, tst) = _both(p, x, st)
    jy, jstate = jrec.mlstm_mixer(jp, jx, jst, chunk=chunk)
    ty, tstate = trec.mlstm_mixer(tp, tx, tst, chunk=chunk)
    for a, b in zip((ty,) + tstate, (jy,) + jstate):
        _close(a.numpy(), b)


def test_mlstm_decode_matches_reference():
    rng = np.random.default_rng(5)
    D, H, Di = 64, 2, 128
    p = mlstm_params(rng, D, H, Di)
    x = _rand(rng, 3, 1, D)
    st = (_rand(rng, 3, H, Di // H, Di // H, scale=0.1),
          _rand(rng, 3, H, Di // H, scale=0.1))
    jp, tp, (jx, jst), (tx, tst) = _both(p, x, st)
    jy, jstate = jrec.mlstm_decode(jp, jx, jst)
    ty, tstate = trec.mlstm_decode(tp, tx, tst)
    assert ty.shape == (3, 1, D)
    for a, b in zip((ty,) + tstate, (jy,) + jstate):
        _close(a.numpy(), b)


@pytest.mark.parametrize("S,with_state", [(37, True), (1, True),
                                          (12, False)])
def test_slstm_mixer_matches_reference(S, with_state):
    rng = np.random.default_rng(S)
    D, H = 64, 2
    Dh = D // H
    p = {"w_gates": _rand(rng, D, H, 4 * Dh, scale=D ** -0.5),
         "r_gates": _rand(rng, H, Dh, 4 * Dh, scale=0.1),
         "b_gates": _rand(rng, H, 4 * Dh, scale=0.1),
         "w_out": _rand(rng, D, D, scale=D ** -0.5)}
    x = _rand(rng, 2, S, D)
    st = ((_rand(rng, 2, H, Dh, scale=0.1), _rand(rng, 2, H, Dh, scale=0.1))
          if with_state else None)
    jp, tp, (jx, jst), (tx, tst) = _both(p, x, st)
    jy, jstate = jrec.slstm_mixer(jp, jx, jst)
    for fn in (trec.slstm_mixer, trec.slstm_decode) if S == 1 else (
            trec.slstm_mixer,):
        ty, tstate = fn(tp, tx, tst, scan=slstm_scan_plain)
        for a, b in zip((ty,) + tstate, (jy,) + jstate):
            _close(a.numpy(), b)
    # The default scan is the kernel wrapper, which runs the plain
    # version on CPU tensors.
    ty, _ = trec.slstm_mixer(tp, tx, tst)
    _close(ty.numpy(), jy)
