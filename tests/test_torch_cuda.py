"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere (the CUDA kernels have
no CPU mode).  They import no JAX, so on a machine without it they run
with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bounds: cim_mvm max|kernel - plain| <= 1e-5 * max|plain|, normwise, as
in chip_smoke.py.  This test first held the per-element bound rtol 1e-5
+ atol 1e-6 of the CPU parity tests; on the H100 9 of its 16 cases
failed it, the largest miss 3.1e-6 absolute on an output near zero with
|y| ~ 3 elsewhere in the row.  The kernel's W' is bit-identical to the
plain version's and only the f32 summation order differs from cuBLAS's,
which moves outputs near zero by ~1e-6 of the output scale, so the
bound was made normwise.  A wrong eta, pos or M1 still misses it by
orders of magnitude.  Flash attention rtol = atol = 2e-5 (the
reference's), manhattan_score and bitslice_pack exact (integer work).
slstm_scan |kernel - plain| <= 1e-5 (1 + |plain|): the kernel sums
h @ R in another order than the plain version's matmul and uses CUDA's
expf/tanhf (a few ulps), and the recurrence carries those ulps on over
the steps; a wrong gate, column or state misses it by orders of
magnitude.  A narrow ContinuousEngine: tokens exact across two batch
compositions and against the plain versions' path (greedy).
sample_tokens_batch: uniforms exact on both devices, tokens exact where
the top two Gumbel-perturbed scores are more than 1e-5 apart (CUDA's
and the CPU's log may differ by an ulp).  line_solve (the circuit
solver's line preconditioner): max|kernel - plain| <= 1e-12 * max|plain|
in f64 and 1e-5 * max|plain| in f32 (the kernel rounds every step as the
plain version does, so they agree bit for bit; the bounds are what a
reordering would be held to), and the kernel-preconditioned batched
solve against the dense oracle at the reference's rtol 1e-7.
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.mdm import MODES
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.kernels.cim_mvm.ops import cim_mvm, deploy, fold
from repro_torch.kernels.cim_mvm.ref import cim_mvm_plain, folded_weights
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    EMPTY_POS,
    flash_attention_plain,
)
from repro_torch.kernels.manhattan_score.ops import manhattan_score
from repro_torch.kernels.bitslice_pack.ops import bitslice_pack
from repro_torch.kernels.bitslice_pack.ref import bitslice_pack_plain
from repro_torch.kernels.manhattan_score.ref import manhattan_score_plain
from repro_torch.kernels.slstm_scan.ops import slstm_scan
from repro_torch.kernels.line_solve.ops import line_solve
from repro_torch.kernels.line_solve.ops import occupancy as line_occupancy
from repro_torch.kernels.line_solve.ref import line_solve_plain
from repro_torch.kernels.slstm_scan.ref import slstm_scan_plain

NF_UNIT = 2.5 / 300e3


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only there")
    return torch.device("cuda")


def _qkv(B, Sq, Skv, H, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, H, Dh), f(B, Skv, Hkv, Dh), f(B, Skv, Hkv, Dh)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("I,N,M", [(70, 13, 5), (256, 192, 1),
                                   (256, 192, 40), (640, 96, 8)])
def test_cim_mvm_kernel_vs_plain(cuda, mode, I, N, M):
    g = torch.Generator(device=cuda).manual_seed(I + N + M)
    w = torch.randn((I, N), generator=g, device=cuda) * 0.2
    x = torch.randn((M, I), generator=g, device=cuda)
    dep, _ = deploy(w, CrossbarSpec(64, 64, 8), mode)
    y = cim_mvm(x, dep, device=cuda)
    y_plain = cim_mvm_plain(x, dep)
    err = (y - y_plain).abs().max().item()
    assert err <= 1e-5 * y_plain.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 64, 64, 4, 2, 32, 0),
                                  (1, 40, 72, 6, 3, 16, 24),
                                  (2, 1, 96, 4, 4, 96, 0),
                                  (2, 33, 50, 4, 4, 128, 0)])
def test_flash_kernel_vs_plain(cuda, case):
    B, Sq, Skv, H, Hkv, Dh, win = case
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _qkv(B, Sq, Skv, H, Hkv, Dh, 0))
    qpos = torch.arange(Sq, dtype=torch.int32, device=cuda) + max(0, Skv - Sq)
    kpos = torch.arange(Skv, dtype=torch.int32, device=cuda)
    out = flash_attention(q, k, v, q_positions=qpos, k_positions=kpos,
                          window=win, device=cuda)
    ref = flash_attention_plain(q, k, v, qpos, kpos, window=win)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec", [(64, 64, 8), (16, 16, 8)])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 512])
@pytest.mark.parametrize("I", [1000, 1001])
def test_cim_mvm_kernel_both_forms(cuda, mode, spec, M, I):
    """Both sides of the decode/prefill dispatch (M <= 16 | M > 16), I
    and N not multiples of any tile; spec (16, 16, 8) has wpt = 2 and
    n_pad % 8 != 0, the kernels' general (not 16-byte) code path; an odd
    I makes the prefill form stage x a float at a time (no 16-byte rows)."""
    N = 300
    g = torch.Generator(device=cuda).manual_seed(M + spec[0] + I)
    w = torch.randn((I, N), generator=g, device=cuda) * 0.2
    x = torch.randn((M, I), generator=g, device=cuda)
    dep, _ = deploy(w, CrossbarSpec(*spec), mode)
    y = cim_mvm(x, dep, device=cuda)
    y_plain = cim_mvm_plain(x, dep)
    err = (y - y_plain).abs().max().item()
    assert err <= 1e-5 * y_plain.abs().max().item(), err


@pytest.mark.cuda
def test_kernels_are_bit_identical_across_calls(cuda):
    """No atomics and fixed reduction orders: a second call on the same
    inputs gives the same bits, for both forms of cim_mvm and flash
    attention, both forms of manhattan_score and slstm_scan."""
    g = torch.Generator(device=cuda).manual_seed(5)
    dep, _ = deploy(torch.randn((3072, 1024), generator=g, device=cuda)
                    * 0.02, CrossbarSpec(64, 64, 8), "mdm")
    for M in (4, 512):
        x = torch.randn((M, 3072), generator=g, device=cuda)
        assert torch.equal(cim_mvm(x, dep, device=cuda),
                           cim_mvm(x, dep, device=cuda))
    for Sq in (1, 128):
        q, k, v = (torch.from_numpy(a).to(cuda)
                   for a in _qkv(4, Sq, 160, 8, 8, 96, Sq))
        kpos = torch.arange(160, dtype=torch.int32, device=cuda)
        qpos = torch.arange(160 - Sq, 160, dtype=torch.int32, device=cuda)
        a = flash_attention(q, k, v, q_positions=qpos, k_positions=kpos,
                            device=cuda)
        b = flash_attention(q, k, v, q_positions=qpos, k_positions=kpos,
                            device=cuda)
        assert torch.equal(a, b)
    for shape in ((64, 64, 64), (9, 13, 70)):
        m = torch.from_numpy(_byte_masks(shape, 6)).to(cuda)
        for a, b in zip(manhattan_score(m, NF_UNIT, device=cuda),
                        manhattan_score(m, NF_UNIT, device=cuda)):
            assert torch.equal(a, b)
    rng = np.random.default_rng(6)
    f = lambda s, *shape: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(cuda)
    args = (f(0.5, 4, 128, 4, 2048), f(0.02, 4, 512, 2048),
            f(0.1, 4, 4, 512), f(0.1, 4, 4, 512))
    for a, b in zip(slstm_scan(*args, device=cuda),
                    slstm_scan(*args, device=cuda)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("Sq", [3, 70])
@pytest.mark.parametrize("Dh", [20, 33, 96, 128])
def test_flash_kernel_forms_and_masks(cuda, Dh, Sq, window):
    """Decode (Sq = 3) and prefill (Sq = 70) forms against the plain
    version: Sq and C = 100 not multiples of the tiles, EMPTY_POS slots,
    GQA (H / Hkv = 2), per-lane positions with one lane fully masked,
    Dh not a multiple of 8 (20) or of 4 (33)."""
    B, C, H, Hkv = 3, 100, 4, 2
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _qkv(B, Sq, C, H, Hkv, Dh, Dh + Sq))
    kpos = torch.full((B, C), EMPTY_POS, dtype=torch.int32, device=cuda)
    qpos = torch.zeros((B, Sq), dtype=torch.int32, device=cuda)
    for b, n in enumerate((0, 77, 100)):
        kpos[b, :n] = torch.arange(n, dtype=torch.int32)
        qpos[b] = torch.arange(n - Sq, n, dtype=torch.int32)
    kpos[2, 5] = EMPTY_POS                 # an evicted slot mid-ring
    out = flash_attention(q, k, v, q_positions=qpos, k_positions=kpos,
                          window=window, device=cuda)
    ref = flash_attention_plain(q, k, v, qpos, kpos, window=window)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    assert (out[0] == 0).all()


MASK_BYTES = np.array([0, 1, 2, 255], dtype=np.uint8)


def _byte_masks(shape, seed):
    """Masks whose nonzero bytes are 1, 2 or 255 (all count as 1)."""
    return np.random.default_rng(seed).choice(MASK_BYTES, size=shape,
                                              p=[0.6, 0.2, 0.1, 0.1])


def _score_both(m, variant, seed):
    rev = variant != "plain"
    pos = None
    if variant == "placed":
        rng = np.random.default_rng(seed)
        pos = torch.from_numpy(np.argsort(rng.random(m.shape[:2]), -1)
                               .astype(np.int32)).to(m.device)
    got = manhattan_score(m, NF_UNIT, reverse=rev, row_position=pos,
                          device=m.device)
    want = manhattan_score_plain(m, NF_UNIT, rev, pos)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "reverse", "placed"])
@pytest.mark.parametrize("t,r,c", [(1, 64, 64), (33, 64, 64),
                                   (20_000, 64, 64), (7, 32, 32),
                                   (5, 16, 16), (3, 13, 70)])
def test_manhattan_score_kernel_vs_plain(cuda, t, r, c, variant):
    """The vector form (C in 16..256, aligned) and the byte form (C = 70)
    in the planner's three variants, bit for bit."""
    m = torch.from_numpy(_byte_masks((t, r, c), t + r + c)).to(cuda)
    for a, b in zip(*_score_both(m, variant, t)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "reverse", "placed"])
@pytest.mark.parametrize("r,c", [(13, 70), (64, 64)])
def test_manhattan_score_kernel_on_unaligned_views(cuda, r, c, variant):
    """Masks that do not start on 16 bytes (``masks[1:]`` of a 13x70
    population; a 64x64 population one byte into its buffer) take the
    byte form, bit for bit."""
    if (r, c) == (13, 70):
        m = torch.from_numpy(_byte_masks((9, r, c), 3)).to(cuda)[1:]
    else:
        buf = torch.from_numpy(_byte_masks((5 * r * c + 1,), 4)).to(cuda)
        m = buf[1:].view(5, r, c)
    assert m.data_ptr() % 16
    for a, b in zip(*_score_both(m, variant, 5)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernel_per_lane_positions_and_masked_rows(cuda):
    """(B, S) positions with EMPTY_POS slots, and a fully masked row
    (returns 0, not NaN), kernel vs plain."""
    B, Sq, C, H, Dh = 3, 2, 40, 4, 96
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _qkv(B, Sq, C, H, H, Dh, 9))
    kpos = torch.full((B, C), EMPTY_POS, dtype=torch.int32, device=cuda)
    qpos = torch.zeros((B, Sq), dtype=torch.int32, device=cuda)
    for b, n in enumerate((0, 17, 40)):
        kpos[b, :n] = torch.arange(n, dtype=torch.int32)
        qpos[b] = torch.arange(n - Sq, n, dtype=torch.int32)
    out = flash_attention(q, k, v, q_positions=qpos, k_positions=kpos,
                          device=cuda)
    ref = flash_attention_plain(q, k, v, qpos, kpos)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    assert (out[0] == 0).all()


SLSTM_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,dh,seed", [
    (1, 3, 1, 4, 0), (5, 70, 4, 16, 1), (2, 16, 2, 8, 2), (3, 17, 1, 16, 3),
    (1, 33, 4, 4, 42), (4, 15, 2, 8, 99),   # the reference's sweep
    (4, 1, 4, 512, 7), (4, 20, 4, 512, 8),   # xlstm-1.3b decode, prefill
    (4, 128, 4, 512, 9),                      # the path's prefill
    (5, 9, 4, 512, 10),      # two lane passes, rows read from L2
    (2, 7, 3, 100, 11),      # blocks with fewer dims and none
    (9, 3, 2, 64, 12),       # two lane groups (clusters) a head
])
def test_slstm_scan_kernel_vs_plain(cuda, b, t, h, dh, seed):
    rng = np.random.default_rng(seed)
    f = lambda s, *shape: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(cuda)
    gx, r = f(0.5, b, t, h, 4 * dh), f(0.1, h, dh, 4 * dh)
    h0, c0 = f(0.1, b, h, dh), f(0.1, b, h, dh)
    got = slstm_scan(gx, r, h0, c0, device=cuda)
    want = slstm_scan_plain(gx, r, h0, c0)
    for a, w in zip(got, want):
        assert ((a - w).abs() <= SLSTM_TOL * (1 + w.abs())).all(), \
            (a - w).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("i,n,n_bits,rev,seed", [
    (1, 1, 4, False, 0), (130, 70, 12, True, 1), (128, 64, 8, False, 2),
    (129, 65, 8, True, 3), (17, 33, 4, True, 4), (64, 1, 12, False, 5),
    (1, 70, 8, True, 42), (100, 23, 4, False, 99),
])
def test_bitslice_pack_kernel_vs_plain(cuda, i, n, n_bits, rev, seed, dtype):
    codes = torch.from_numpy(np.random.default_rng(seed).integers(
        -(2 ** n_bits) + 1, 2 ** n_bits, (i, n))).to(dtype).to(cuda)
    got = bitslice_pack(codes, n_bits, rev, device=cuda)
    assert torch.equal(got, bitslice_pack_plain(codes, n_bits, rev))


@pytest.mark.cuda
def test_kernel_launches_are_counted(cuda):
    from repro_torch.kernels import runtime

    dep, _ = deploy(torch.randn((64, 16), device=cuda), CrossbarSpec())
    runtime.reset_launch_counts()
    cim_mvm(torch.randn((2, 64), device=cuda), dep, device=cuda)
    assert runtime.launch_counts()["cim_mvm"] == 1
    folded = fold(dataclasses.replace(dep, gain=torch.ones_like(
        dep.codes, dtype=torch.float32)))
    assert runtime.launch_counts()["cim_fold"] == 1
    cim_mvm(torch.randn((2, 64), device=cuda), folded, device=cuda)
    assert runtime.launch_counts()["cim_mvm"] == 2
    z = torch.zeros((2, 3, 1, 16), device=cuda)
    slstm_scan(z, torch.zeros((1, 4, 16), device=cuda),
               torch.zeros((2, 1, 4), device=cuda),
               torch.zeros((2, 1, 4), device=cuda), device=cuda)
    bitslice_pack(torch.ones((4, 4), dtype=torch.int16, device=cuda), 8,
                  device=cuda)
    counts = runtime.launch_counts()
    assert counts["slstm_scan"] == 1 and counts["bitslice_pack"] == 1


def _narrow_engine(cuda, tmp_path, **kw):
    from repro_torch.configs import CimConfig, ModelConfig
    from repro_torch.deploy import PlanCache
    from repro_torch.models.model import init_params
    from repro_torch.serve import ContinuousEngine

    cfg = ModelConfig(name="narrow", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype="float32",
                      cim=CimConfig(enabled=True, rows=32, cols=32, n_bits=8))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    return ContinuousEngine(cfg, params, capacity=4, max_seq=48,
                            max_prompt=24, device=cuda,
                            plan_cache=PlanCache(str(tmp_path)), **kw)


@pytest.mark.cuda
def test_continuous_engine_on_the_card(cuda, tmp_path):
    """A narrow ContinuousEngine: per-request tokens bit-identical across
    two submission orders (so two batch compositions), and greedy
    tokens equal to the plain versions' path."""
    from repro_torch.models.model import PLAIN

    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 256, int(rng.integers(3, 25))),
             int(rng.integers(4, 12)), 0.0 if i % 2 == 0 else 0.8, 100 + i)
            for i in range(7)]

    def serve(order, ops=None):
        eng = _narrow_engine(cuda, tmp_path)
        if ops is not None:
            eng.ops = ops
        rids = {i: eng.submit(reqs[i][0], max_tokens=reqs[i][1],
                              temperature=reqs[i][2], seed=reqs[i][3])
                for i in order}
        out = eng.run()
        assert eng.traces == {"prefill": 1, "decode": 1}
        return {i: out[r] for i, r in rids.items()}

    a = serve(range(7))
    b = serve(reversed(range(7)))
    assert a == b
    plain = serve(range(7), PLAIN)
    for i in range(0, 7, 2):
        assert a[i] == plain[i], i


@pytest.mark.cuda
def test_sample_tokens_batch_cpu_equals_card(cuda):
    """The same uniforms on both; where the top two Gumbel-perturbed
    scores are more than 1e-5 apart, the same token."""
    from repro_torch.serve.engine import sample_tokens_batch, sample_uniforms

    rng = np.random.default_rng(0)
    B, V = 64, 32064
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, B))
    counts = torch.from_numpy(rng.integers(0, 200, B))
    temps = torch.from_numpy(rng.uniform(-0.5, 1.5, B).astype(np.float32))
    u = sample_uniforms(seeds, counts, V)
    assert torch.equal(sample_uniforms(seeds.to(cuda), counts.to(cuda),
                                       V).cpu(), u)
    cpu = sample_tokens_batch(logits, seeds, counts, temps)
    card = sample_tokens_batch(*(t.to(cuda) for t in (logits, seeds, counts,
                                                      temps))).cpu()
    scores = torch.where(temps[:, None] > 0,
                         logits / temps.clamp(min=1e-6)[:, None]
                         - torch.log(-torch.log(u)), logits)
    top2 = scores.topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    assert clear.sum() > B // 2
    assert torch.equal(cpu[clear], card[clear])


def _nonideal_dep(cuda, I, N, spec, ops, seed, mode="mdm"):
    """A deployment of a random (I, N) matrix carrying the nonideal
    operands named in ``ops``: a log-normal gain, random per-tile bitline
    permutations, read noise at sigma_read 0.05 (tag 3); not folded."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((I, N), generator=g, device=cuda) * 0.2
    dep, _ = deploy(w, CrossbarSpec(*spec), mode)
    extra = {}
    if ops in ("gain", "all"):
        extra["gain"] = torch.exp(0.1 * torch.randn(
            dep.codes.shape, generator=g, device=cuda))
    if ops in ("colpos", "all"):
        ti, tn = dep.codes.shape[0] // spec[0], dep.pos.shape[1]
        extra["col_pos"] = torch.argsort(torch.rand(
            (ti, tn, spec[1]), generator=g, device=cuda), dim=-1).to(
                torch.int32)
    if ops in ("noise", "all"):
        extra.update(noise_tag=torch.tensor(3, dtype=torch.int32),
                     sigma_read=0.05)
    return dataclasses.replace(dep, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("ops", ["gain", "colpos", "noise", "all"])
@pytest.mark.parametrize("spec", [(64, 64, 8), (16, 64, 8), (16, 16, 8)])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 128, 512])
def test_cim_mvm_nonideal_operands_vs_plain(cuda, ops, spec, M):
    """Gain, column permutation and in-kernel read noise through the
    fold kernel and the folded forms (decode M <= 16, prefill), on the
    fold's 16-byte path (wpt 8) and its general one (spec (16, 16, 8):
    wpt 2); rows 16 make a fold block span two tiles of col_pos.  The
    kernel reads the folded deployment, the plain version expands the
    unfolded one.  Same normwise bound as the ideal form: W' * gain is
    bit-identical and the noise differs in the normals' last bits (the
    kernel's SFU log / sincos against CUDA's log / cos in the plain
    version)."""
    I, N = 640, 384
    dep = _nonideal_dep(cuda, I, N, spec, ops, M + spec[0] + spec[1])
    x = torch.randn((M, I), generator=torch.Generator(device=cuda)
                    .manual_seed(M), device=cuda)
    with pytest.raises(ValueError, match="fold"):
        cim_mvm(x, dep, read_seed=11, device=cuda)
    folded = fold(dep)
    y = cim_mvm(x, folded, read_seed=11, device=cuda)
    y_plain = cim_mvm_plain(x, dep, 11)
    err = (y - y_plain).abs().max().item()
    assert err <= 1e-5 * y_plain.abs().max().item(), err
    if ops in ("noise", "all"):
        # The noise is drawn: another seed gives another y.
        y2 = cim_mvm(x, folded, read_seed=12, device=cuda)
        assert not torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("ops", ["gain", "colpos", "all"])
@pytest.mark.parametrize("spec,N", [((64, 64, 8), 384), ((16, 64, 8), 384),
                                    ((16, 16, 8), 384), ((16, 16, 8), 13),
                                    ((32, 32, 4), 100)])
@pytest.mark.parametrize("mode", MODES)
def test_cim_fold_kernel_is_exact(cuda, ops, spec, N, mode):
    """The fold kernel against its plain version, bit for bit: the
    16-byte path (wpt 8) and the general one (wpt 2, and N = 13, whose
    rows pad from n_pad 14 to ld 16 with zeros), K = 4, all four modes
    (two with reversed dataflow), col_pos tiles of 64 and of 16 rows."""
    dep = _nonideal_dep(cuda, 200, N, spec, ops, N + spec[0], mode)
    got = fold(dep).folded
    assert torch.equal(got, folded_weights(dep))
    assert torch.equal(got.cpu(), folded_weights(dataclasses.replace(
        dep, **{f: None if getattr(dep, f) is None
                else getattr(dep, f).cpu()
                for f in ("codes", "pos", "scale", "gain", "col_pos")})))


@pytest.mark.cuda
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("M", [4, 128, 512])
def test_cim_occupancy_of_every_form(cuda, M, folded):
    """The occupancy query (CUDA's occupancy calculator in the built
    library) at a launch's geometry: at least one resident block a SM for
    every form and the fold, clusters for a cluster launch (the decode
    forms, a split folded prefill) and for no other, and no error left
    behind for the next launch."""
    from repro_torch.kernels.cim_mvm.ops import (
        FORM_DECODE,
        FORM_DECODE_FOLDED,
        _sm_count,
        cim_geometry,
        fold_geometry,
        occupancy,
    )

    spec = (64, 64, 8)
    I, N = 1024, 2048
    dep = _nonideal_dep(cuda, I, N, spec, "all" if folded else "none", M)
    geoms = [cim_geometry(M, I, N, *dep.codes.shape, dep.wpt, dep.n_bits,
                          dep.cols, dep.reversed_df, _sm_count(0), True,
                          True, folded, folded)]
    if folded:
        geoms.append(fold_geometry(*dep.codes.shape, dep.wpt, dep.n_bits,
                                   dep.cols, dep.reversed_df, True,
                                   spec[0]))
    for geom in geoms:
        occ = occupancy(geom)
        assert occ["blocks_per_sm"] >= 1, (geom.form, occ)
        cluster = geom.form in (FORM_DECODE, FORM_DECODE_FOLDED) \
            or geom.gz > 1
        assert (occ["clusters"] is not None) == cluster, (geom.form, occ)
        assert not cluster or occ["clusters"] >= 1
    x = torch.randn((M, I), device=cuda).to(torch.bfloat16)
    run = fold(dep) if folded else dep
    y = cim_mvm(x, run, read_seed=11, device=cuda)
    y_plain = cim_mvm_plain(x, dep, 11)
    assert (y - y_plain).abs().max().item() \
        <= 1e-5 * y_plain.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 128])
def test_cim_mvm_read_noise_is_a_function_of_seed_tag_and_position(cuda, M):
    """Row r of y is the same at M and at M = 1 (every row sees the
    same W' in one read; the decode and prefill forms draw the same
    eps), and two calls with one seed are bit-identical."""
    dep = fold(_nonideal_dep(cuda, 640, 384, (64, 64, 8), "all", 5))
    x = torch.randn((M, 640), generator=torch.Generator(device=cuda)
                    .manual_seed(3), device=cuda)
    y = cim_mvm(x, dep, read_seed=9, device=cuda)
    assert torch.equal(y, cim_mvm(x, dep, read_seed=9, device=cuda))
    y1 = cim_mvm(x[:1], dep, read_seed=9, device=cuda)
    err = (y[:1] - y1).abs().max().item()
    assert err <= 1e-5 * y1.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 128])
def test_cim_mvm_read_noise_is_finite_at_every_draw(cuda, M):
    """16 noisy reads of a 3072 x 8192 folded deployment draw ~2e8
    uniforms u1; about one in 2^24 rounds to exactly 1 (ln u1 = 0), so
    these reads meet that case ~12 times: every output stays finite."""
    dep = fold(_nonideal_dep(cuda, 3072, 8192, (64, 64, 8), "noise", 2))
    x = torch.randn((M, 3072), generator=torch.Generator(device=cuda)
                    .manual_seed(M), device=cuda)
    for seed in range(16):
        assert torch.isfinite(cim_mvm(x, dep, read_seed=seed,
                                      device=cuda)).all(), seed


@pytest.mark.cuda
@pytest.mark.parametrize("ops", ["none", "all"])
@pytest.mark.parametrize("M", [1, 8, 128])
def test_cim_mvm_bf16_x(cuda, ops, M):
    """bf16 x is read as it is: the same y as its exact f32 widening (the
    folded prefill form skips the product with x's lo part, exactly zero
    for bf16 x, and runs it for f32 x)."""
    dep = _nonideal_dep(cuda, 640, 384, (64, 64, 8), ops, 7)
    if ops == "all":
        dep = fold(dep)
    x = torch.randn((M, 640), device=cuda).to(torch.bfloat16)
    y = cim_mvm(x, dep, read_seed=4, device=cuda)
    assert y.dtype == torch.float32
    y32 = cim_mvm(x.to(torch.float32), dep, read_seed=4, device=cuda)
    assert torch.equal(y, y32)
    y_plain = cim_mvm_plain(x, dep, 4)
    err = (y - y_plain).abs().max().item()
    assert err <= 1e-5 * y_plain.abs().max().item(), err


# bf16 outputs: both sides compute in f32 and round once; results that
# straddle a rounding boundary differ by one bf16 ulp (2^-7 relative).
BF16_RTOL = 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 64, 64, 4, 2, 32, 0),
                                  (1, 40, 72, 6, 3, 16, 24),
                                  (2, 1, 96, 4, 4, 96, 0),
                                  (4, 4, 160, 32, 32, 96, 0),
                                  (2, 33, 50, 4, 4, 128, 0),
                                  (1, 70, 70, 2, 2, 20, 0),
                                  (2, 1, 160, 6, 2, 96, 0),
                                  (2, 3, 100, 24, 2, 96, 0),
                                  (2, 1, 4096, 8, 4, 96, 0),
                                  (2, 70, 100, 4, 2, 96, 17)])
def test_flash_kernel_bf16_vs_plain(cuda, case):
    """bf16 q, k, v in both forms (decode Sq <= 16, prefill), Dh = 20 on
    the per-value load path, GQA decode with G = 3 and G = 12 (two head
    chunks of a KV head), the long-cache decode split over a cluster (C =
    4096), a prefill with a window: against the plain version on the same
    bf16 inputs, and bit-identical across two calls.  (The bf16 forms run
    bf16 tensor-core products, k16 steps, so they no longer equal the f32
    kernel on the widened inputs bit for bit.)"""
    B, Sq, Skv, H, Hkv, Dh, win = case
    q, k, v = (torch.from_numpy(a).to(cuda).to(torch.bfloat16)
               for a in _qkv(B, Sq, Skv, H, Hkv, Dh, 1))
    qpos = torch.arange(Sq, dtype=torch.int32, device=cuda) + max(0, Skv - Sq)
    kpos = torch.arange(Skv, dtype=torch.int32, device=cuda)
    run = lambda: flash_attention(q, k, v, q_positions=qpos,
                                  k_positions=kpos, window=win, device=cuda)
    out = run()
    assert out.dtype == torch.bfloat16
    ref = flash_attention_plain(q, k, v, qpos, kpos, window=win)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_RTOL,
                               atol=2e-5)
    assert torch.equal(out, run())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("Sq", [3, 70])
@pytest.mark.parametrize("Dh", [1, 20, 33, 96, 128])
def test_flash_kernel_bf16_forms_and_masks(cuda, Dh, Sq, window):
    """The bf16 forms over what the f32 test covers: Sq and C = 100 not
    multiples of the tiles, EMPTY_POS slots, GQA (H / Hkv = 2), per-lane
    positions with one lane fully masked (exactly 0), Dh from 1 to 128."""
    B, C, H, Hkv = 3, 100, 4, 2
    q, k, v = (torch.from_numpy(a).to(cuda).to(torch.bfloat16)
               for a in _qkv(B, Sq, C, H, Hkv, Dh, Dh + Sq + 1))
    kpos = torch.full((B, C), EMPTY_POS, dtype=torch.int32, device=cuda)
    qpos = torch.zeros((B, Sq), dtype=torch.int32, device=cuda)
    for b, n in enumerate((0, 77, 100)):
        kpos[b, :n] = torch.arange(n, dtype=torch.int32)
        qpos[b] = torch.arange(n - Sq, n, dtype=torch.int32)
    kpos[2, 5] = EMPTY_POS                 # an evicted slot mid-ring
    out = flash_attention(q, k, v, q_positions=qpos, k_positions=kpos,
                          window=window, device=cuda)
    ref = flash_attention_plain(q, k, v, qpos, kpos, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_RTOL,
                               atol=2e-5)
    assert (out[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [160, 4096])
def test_flash_kernel_bf16_per_lane_decode_dead_lanes(cuda, C):
    """The continuous engine's decode in bf16: one query a lane at its
    own clock over a ring of C slots, two lanes dead (every slot
    EMPTY_POS) that give exactly 0; C = 4096 runs the cluster split."""
    B, H, Dh = 8, 8, 96
    q, k, v = (torch.from_numpy(a).to(cuda).to(torch.bfloat16)
               for a in _qkv(B, 1, C, H, H, Dh, C))
    filled = [0, 0, 17, 40, 77, C // 2, C - 10, C - 1]
    kpos = torch.full((B, C), EMPTY_POS, dtype=torch.int32, device=cuda)
    for b, n in enumerate(filled):
        kpos[b, :n] = torch.arange(n, dtype=torch.int32)
    qpos = torch.tensor([max(n - 1, 0) for n in filled], dtype=torch.int32,
                        device=cuda)[:, None]
    out = flash_attention(q, k, v, q_positions=qpos, k_positions=kpos,
                          device=cuda)
    ref = flash_attention_plain(q, k, v, qpos, kpos)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_RTOL,
                               atol=2e-5)
    assert (out[:2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,dh,seed", [
    (1, 3, 1, 4, 0), (5, 70, 4, 16, 1), (4, 1, 4, 512, 7),
    (4, 128, 4, 512, 9), (5, 9, 4, 512, 10), (2, 7, 3, 100, 11),
    (9, 3, 2, 64, 12),
])
@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_slstm_scan_kernel_bf16_vs_plain(cuda, b, t, h, dh, seed, state):
    """bf16 gx and R (the serving form: the state f32), and everything
    bf16 (outputs rounded to bf16 at the store), against the plain
    version on the same inputs."""
    rng = np.random.default_rng(seed)
    f = lambda s, *shape: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(cuda)
    gx = f(0.5, b, t, h, 4 * dh).to(torch.bfloat16)
    r = f(0.1, h, dh, 4 * dh).to(torch.bfloat16)
    st = torch.float32 if state == "f32" else torch.bfloat16
    h0, c0 = f(0.1, b, h, dh).to(st), f(0.1, b, h, dh).to(st)
    got = slstm_scan(gx, r, h0, c0, device=cuda)
    want = slstm_scan_plain(gx, r, h0, c0)
    rtol = SLSTM_TOL if state == "f32" else BF16_RTOL
    for a, w in zip(got, want):
        assert a.dtype == st
        a, w = a.float(), w.float()
        assert ((a - w).abs() <= SLSTM_TOL + rtol * w.abs()).all(), \
            (a - w).abs().max().item()


def _stacked_nonideal(cuda, G, I, N, seed, noise):
    """G folded deployments of random (I, N) matrices with gain and
    col_pos (and read noise at non-consecutive tags 5 + 7g), stacked."""
    from repro_torch.deploy.lifetime import stack_deployments

    deps = []
    for g in range(G):
        dep = _nonideal_dep(cuda, I, N, (64, 64, 8),
                            "all" if noise else "gain", seed + g)
        if noise:
            dep = dataclasses.replace(
                dep, noise_tag=torch.tensor(5 + 7 * g, dtype=torch.int32))
        deps.append(fold(dep))
    return stack_deployments(deps)


@pytest.mark.cuda
@pytest.mark.parametrize("G,I,N", [(1, 320, 200), (3, 330, 200),
                                   (32, 320, 200), (40, 330, 900)])
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cim_mvm_batched_vs_plain_loop(cuda, G, I, N, M, noise, dtype):
    """The batched folded decode form, one launch for the group, against
    its plain loop over the members: every member at the folded forms'
    normwise bound (1e-5 x max|y|); members read out of order (a
    reversed subset where G > 1), each with its own tag; two calls
    bit-identical; one launch counted.  The groups of 1, 3 and 32 at
    N = 200 leave SMs idle, so a cluster splits I (8, 8 and 4 ways); 39
    members of 8 column tiles (N = 900) do not.  I = 330 is no multiple
    of the 32-row slab, and its rows of x are not on 16 bytes (per-value
    staging); N is ragged against the 128-column tile."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cim_mvm.ops import (
        _sm_count,
        batched_geometry,
        cim_mvm_batched,
    )
    from repro_torch.kernels.cim_mvm.ref import cim_mvm_batched_plain

    st = _stacked_nonideal(cuda, G, I, N, 10 * G + M, noise)
    members = list(range(G))[::-1][:max(1, G - 1)]
    x = torch.randn((len(members), M, I), generator=torch.Generator(
        device=cuda).manual_seed(G + M), device=cuda).to(dtype)
    seed = 21 if noise else None
    geom = batched_geometry(len(members), M, I, N, *st.codes.shape[1:],
                            st.wpt, st.n_bits, st.cols, st.reversed_df,
                            _sm_count(0), dtype == torch.bfloat16, noise)
    assert (geom.gy > 1) == (N == 200)
    runtime.reset_launch_counts()
    y = cim_mvm_batched(x, st, seed, members, device=cuda)
    assert runtime.launch_counts()["cim_mvm_batched"] == 1
    want = cim_mvm_batched_plain(x, st, seed, members)
    for g in range(len(members)):
        err = (y[g] - want[g]).abs().max().item()
        assert err <= 1e-5 * want[g].abs().max().item(), (g, err)
    assert torch.equal(y, cim_mvm_batched(x, st, seed, members, device=cuda))
    if noise and len(members) > 1:      # each member its own tag's noise
        assert not torch.equal(
            y[0], cim_mvm_batched(x[:1], st, seed, members[1:2],
                                  device=cuda)[0])


@pytest.mark.cuda
def test_cim_mvm_batched_occupancy_and_refusals(cuda):
    """The batched form's occupancy and its refusals: M > 16, an unfolded
    stack.  A split of I runs in clusters; at phi3's largest probe group
    (32 members of 3072x8192, M = 16) there is no split and the form fits
    two blocks a SM, with and without noise, f32 and bf16 x."""
    from repro_torch.kernels.cim_mvm.ops import (
        _sm_count,
        batched_geometry,
        cim_mvm_batched,
        occupancy,
    )

    st = _stacked_nonideal(cuda, 3, 320, 200, 1, True)
    geom = batched_geometry(3, 16, 320, 200, *st.codes.shape[1:], st.wpt,
                            st.n_bits, st.cols, st.reversed_df, _sm_count(0),
                            False, True)
    assert geom.mt == 16 and geom.gz == 3 and geom.gy == 8
    occ = occupancy(geom)
    assert occ["blocks_per_sm"] >= 2 and occ["clusters"] >= 1
    for noise in (False, True):
        for bf16 in (False, True):
            big = batched_geometry(32, 16, 3072, 8192, 3072, 8192, 8, 8, 64,
                                   False, _sm_count(0), bf16, noise)
            occ = occupancy(big)
            assert big.gy == 1 and occ["clusters"] is None
            assert occ["blocks_per_sm"] >= 2, (noise, bf16, occ)
    with pytest.raises(ValueError):
        cim_mvm_batched(torch.zeros((3, 17, 320), device=cuda), st,
                        device=cuda)
    unfolded = dataclasses.replace(st)
    with pytest.raises(ValueError, match="folded"):
        cim_mvm_batched(torch.zeros((3, 4, 320), device=cuda), unfolded,
                        device=cuda)


@pytest.mark.cuda
def test_refold_after_recalibrate_is_bit_identical(cuda):
    """A lifetime-captured deploy on the card: recalibrate, reprogram and
    a plain age advance of members restacked through the fold kernel,
    every refreshed fold bit-identical to the fold's plain version of its
    new gain, and the refresh at the deploy's age rebuilding the
    deployed fold bit for bit (the cells drawn again on the card)."""
    import numpy as np

    from repro_torch.configs import CimConfig, ModelConfig
    from repro_torch.deploy import deploy_model_params, restack_group
    from repro_torch.models.model import init_params
    from repro_torch.nonideal import NonidealModel

    cfg = ModelConfig(name="narrow", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype="float32",
                      cim=CimConfig(enabled=True, rows=32, cols=32, n_bits=8))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    model = NonidealModel(p_stuck_off=0.01, sigma_program=0.05,
                          sigma_corr=0.05, drift_nu=0.05, drift_time=10.0,
                          sigma_relax=0.08, sigma_read=0.01)
    lifetime: dict = {}
    cim, _ = deploy_model_params(params, cfg, device=cuda, nonideal=model,
                                 lifetime=lifetime)
    deployed = {k: d.folded.clone() for k, d in cim["slot0_attn"].items()}
    for lt in lifetime.values():
        lt.stale = True
    for pname in deployed:
        assert torch.equal(restack_group(lifetime, "slot0_attn",
                                         pname).folded, deployed[pname])
    up = [lifetime[f"slot0_attn/ffn_w_up/{r}"] for r in range(2)]
    up[0].recalibrate(np.linspace(0.9, 1.1, up[0].dep.out_dim))
    up[1].reprogram()
    restack_group(lifetime, "slot0_attn", "ffn_w_up")
    for lt in lifetime.values():
        lt.advance(1e4)
    for pname in deployed:
        restack_group(lifetime, "slot0_attn", pname)
    for lt in lifetime.values():
        assert torch.equal(lt.dep.folded, folded_weights(lt.dep)), lt.name


def _line_inputs(T, J, K, dtype, device):
    rng = np.random.default_rng(J * K + T)
    g = np.where(rng.random((T, J, K)) < 0.3, 1 / 300e3, 1 / 3e6)
    g[0, 0, 0] = 0.0                        # an open cell
    r = rng.standard_normal((T, 2, J, K))
    return (torch.tensor(a, dtype=dtype, device=device) for a in (g, r))


# Every form in both dtypes: the factor in registers (64x64, 32x32; 128x128
# in f32), in shared memory (the other fast shapes), the stream form
# (128x128 in f64, 256x256).  T=None: one tile more than two rounds of the
# persistent grid.
@pytest.mark.cuda
@pytest.mark.parametrize("T,J,K", [(7, 64, 64), (5, 32, 32), (3, 128, 10),
                                   (4, 3, 5), (2, 17, 40), (3, 40, 17),
                                   (2, 128, 128), (1, 256, 256), (2, 256, 3),
                                   (2, 3, 256), (None, 64, 64),
                                   (None, 100, 100)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_line_solve_kernel_vs_plain(cuda, T, J, K, dtype, tol):
    if T is None:
        occ = line_occupancy(J, K, dtype)
        T = 2 * torch.cuda.get_device_properties(
            0).multi_processor_count * occ["blocks_per_sm"] + 1
    g, r = _line_inputs(T, J, K, dtype, cuda)
    z = line_solve(g, r, 0.4)
    want = line_solve_plain(g, r, 0.4)
    err = (z - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err
    assert torch.equal(z, line_solve(g, r, 0.4))     # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fast", "stream"])
@pytest.mark.parametrize("J,K", [(64, 64), (9, 33), (33, 9)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_line_solve_forms_agree_bit_for_bit(cuda, form, J, K, dtype):
    """Each form (forced) keeps the plain version's rounding, bit for bit:
    on the fast one, one and two slots, a 16-byte pitch, and the factor
    in registers or in shared planes."""
    from repro_torch.kernels.line_solve.ops import launch, line_geometry

    g, r = _line_inputs(3 * 132 + 5, J, K, dtype, cuda)
    want = line_solve_plain(g, r, 0.4)
    geoms = [line_geometry(J, K, dtype, form=form)]
    vec = 2 if dtype == torch.float64 else 4
    for s, p, f in itertools.product((1, 2), (None, -(-K // vec) * vec),
                                     (True, False)):
        if form == "fast" and (not f or J == K):
            try:
                geoms.append(line_geometry(J, K, dtype, form=form, stages=s,
                                           pitch=p, registers=f))
            except ValueError:          # more shared memory than a block has
                continue
    for geom in geoms:
        assert torch.equal(launch(g, r, 0.4, geom), want), geom


@pytest.mark.cuda
def test_line_solve_refusals_and_occupancy(cuda):
    from repro_torch.kernels.line_solve.ops import MAX_SMEM, line_geometry

    for J, K in ((257, 4), (4, 257)):
        g = torch.zeros((1, J, K), dtype=torch.float64, device=cuda)
        with pytest.raises(ValueError, match="256"):
            line_solve(g, g[:, None].expand(1, 2, J, K), 0.4)
    g = torch.zeros((1, 128, 128), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        line_solve(g.half(), g.half()[:, None].expand(1, 2, 128, 128), 0.4)
    # The 64x64 fast forms keep the factor in registers: three planes a
    # slot; one slot in f64 (two fit a block, but then one block a SM),
    # two in f32 (its registers hold it to two blocks a SM either way).
    for dtype, stages in ((torch.float64, 1), (torch.float32, 2)):
        occ = line_occupancy(64, 64, dtype)
        word = 8 if dtype == torch.float64 else 4
        assert occ["form"] == "fast" and occ["reg_len"] == 64
        assert occ["stages"] == stages and occ["threads"] == 128
        assert occ["smem_bytes"] == 3 * stages * 64 * 65 * word
        assert occ["blocks_per_sm"] == 2
        assert occ["sweeping_warps_per_sm"] == 8
    occ = line_occupancy(128, 128, torch.float64)
    assert occ["form"] == "stream" and occ["blocks_per_sm"] >= 1
    assert line_occupancy(128, 128, torch.float32)["form"] == "fast"
    for dtype in (torch.float64, torch.float32):
        assert line_geometry(256, 256, dtype)["smem"] <= MAX_SMEM


def _dense_currents_on_card(active, spec, device):
    """``column_currents_dense``'s nodal system, stamped and solved on the
    card in f64 (at 128x128 it is 32768 x 32768: 8.6 GB, ~1e13 flops, too
    large for the host oracle)."""
    J, K = active.shape
    JK, cw = J * K, 1.0 / spec.r
    f64 = torch.float64
    g = torch.where(torch.as_tensor(active, device=device).flatten() > 0,
                    1.0 / spec.r_on, 1.0 / spec.r_off).to(f64)
    idx = torch.arange(JK, device=device)
    w, bl, j, k = idx, JK + idx, idx // K, idx % K
    A = torch.zeros((2 * JK, 2 * JK), dtype=f64, device=device)
    b = torch.zeros(2 * JK, dtype=f64, device=device)

    def tie(a, c, cond):
        cond = torch.as_tensor(cond, dtype=f64, device=device).expand(
            a.shape)
        for p, q, s in ((a, a, 1), (c, c, 1), (a, c, -1), (c, a, -1)):
            A.index_put_((p, q), s * cond, accumulate=True)

    tie(w, bl, g)                                   # the devices
    src, gnd = k == 0, j == 0
    A.index_put_((w[src], w[src]), torch.full((J,), cw, dtype=f64,
                                              device=device), accumulate=True)
    b[w[src]] += cw * spec.v_read
    tie(w[~src], w[~src] - 1, cw)                   # wordline wires
    A.index_put_((bl[gnd], bl[gnd]), torch.full((K,), cw, dtype=f64,
                                                device=device),
                 accumulate=True)
    tie(bl[~gnd], bl[~gnd] - K, cw)                 # bitline wires
    x = torch.linalg.solve(A, b)
    return (cw * x[JK:].reshape(J, K)[0]).cpu().numpy()


@pytest.mark.cuda
def test_checked_solve_128x128_matches_dense_oracle(cuda):
    """The paper's 128x128 crossbar, checked F64 on the card (the stream
    form), against the dense nodal solve at the reference's rtol 1e-7;
    that solve is ``column_currents_dense``'s own system, held to it at
    16x16 at rtol 1e-8 (two LU solvers on a system of condition ~1e7:
    2.5e-9 apart on the H100)."""
    from repro_torch.crossbar import (
        column_currents_dense,
        measured_nf_batched_checked,
    )

    rng = np.random.default_rng(128)
    small = (rng.random((16, 16)) < 0.2).astype(np.float32)
    spec16 = CrossbarSpec(16, 16, 8)
    np.testing.assert_allclose(
        _dense_currents_on_card(small, spec16, cuda),
        column_currents_dense(small, np.full(16, spec16.v_read), spec16),
        rtol=1e-8)
    spec = CrossbarSpec(128, 128, 8)
    masks = (rng.random((2, 128, 128)) < 0.2).astype(np.float32)
    res, rep = measured_nf_batched_checked(
        torch.tensor(masks, device=cuda), spec, precision="f64", device=cuda)
    assert rep.n_failed == 0 and rep.escalations == 0
    for i in range(2):
        dense = _dense_currents_on_card(masks[i], spec, cuda)
        torch.cuda.empty_cache()
        np.testing.assert_allclose(res.currents[i].cpu().numpy(), dense,
                                   rtol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_batched_solve_on_card_matches_dense_oracle(cuda, precision):
    from repro_torch.crossbar import (
        column_currents_dense,
        measured_nf_batched_checked,
    )

    spec = CrossbarSpec(12, 12, 8)      # tests/test_solver.py's batch
    rng = np.random.default_rng(13)
    masks = (rng.random((6, 12, 12)) < np.array(
        [0.05, 0.1, 0.2, 0.3, 0.5, 0.8])[:, None, None]).astype(np.float32)
    res, rep = measured_nf_batched_checked(
        torch.tensor(masks, device=cuda), spec, precision=precision,
        device=cuda)
    assert rep.n_failed == 0 and rep.escalations == 0
    for i in range(6):
        dense = column_currents_dense(masks[i], np.full(12, spec.v_read),
                                      spec)
        np.testing.assert_allclose(res.currents[i].cpu().numpy(), dense,
                                   rtol=1e-7)


def _expert_bank(cuda, E, I, N, spec, seed):
    """E deployments of random (I, N) weights stacked over experts."""
    from repro_torch.kernels.cim_mvm.ops import CimDeployment

    g = torch.Generator(device=cuda).manual_seed(seed)
    deps = [deploy(torch.randn((I, N), generator=g, device=cuda) * 0.02,
                   CrossbarSpec(*spec), "mdm")[0] for _ in range(E)]
    stacked = {f: torch.stack([getattr(d, f) for d in deps]).contiguous()
               for f in ("codes", "pos", "scale")}
    return dataclasses.replace(deps[0], **stacked)


@pytest.mark.cuda
@pytest.mark.parametrize("I,N", [(2048, 1408), (1408, 2048), (200, 72)])
@pytest.mark.parametrize("routing", ["prefill", "decode", "empty", "at_cap",
                                     "dropped", "cap32", "straddle",
                                     "over128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cim_mvm_grouped_vs_plain(cuda, I, N, routing, dtype):
    """The grouped forms at qwen2-moe's expert shapes (E = 60: a prefill
    of 4 x 128 tokens top-4, capacity 128, on the tensor-core form, f32 x
    in three products and bf16 x in two; a decode step of 4 tokens; an
    expert with every row and the rest empty; one expert at exactly the
    capacity; rows past the capacity dropped; a continuous decode step
    of 8 tokens, capacity 32; experts of 0..9 rows at capacity 16,
    straddling every row bucket of the decode form and taking two of its
    passes; experts of 260 and 130 rows at capacity 300, three and two
    passes of the prefill form) and at a ragged shape (spec (16, 16, 8): wpt 2, the general
    form), against the plain version: max|kernel - plain| <= 1e-5 *
    max|plain|, rows no expert computes exactly 0, two calls
    bit-identical."""
    from repro_torch.kernels.cim_mvm import ops
    from repro_torch.kernels.cim_mvm.ops import cim_mvm_grouped
    from repro_torch.kernels.cim_mvm.ref import cim_mvm_grouped_plain

    ragged = I == 200
    E = 6 if ragged else 60
    spec = (16, 16, 8) if ragged else (64, 64, 8)
    dep = _expert_bank(cuda, E, I, N, spec, I + N)
    rng = np.random.default_rng(len(routing))
    T, K = {"prefill": (512, 4), "decode": (4, 4),
            "cap32": (8, 4)}.get(routing, (512, 4))
    cap = {"dropped": 40, "straddle": 16,
           "over128": 300}.get(routing, min(128, T * K))
    if routing in ("prefill", "decode", "dropped", "cap32"):
        probs = rng.random((T, E)) ** 3          # uneven loads
        top = np.argsort(-probs, axis=1, kind="stable")[:, :K]
        counts = np.bincount(top.reshape(-1), minlength=E)
        if routing != "dropped":
            counts = np.minimum(counts, cap)
    elif routing == "empty":
        counts = np.zeros(E, np.int64)
        counts[3] = cap
    elif routing == "straddle":
        counts = np.arange(E) % 10
    elif routing == "over128":
        counts = np.zeros(E, np.int64)
        counts[5], counts[min(9, E - 1)] = 260, 130
    else:                                        # "at_cap"
        counts = rng.integers(0, cap // 2, E)
        counts[min(7, E - 1)] = cap
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32, device=cuda)
    A = int(counts.sum()) + 1
    x = torch.randn((A, I), generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda).to(dtype)
    geom = ops.grouped_geometry(E, cap, I, N, dep.codes.shape[2], dep.wpt,
                                dep.n_bits, dep.cols, dep.reversed_df, True,
                                dtype == torch.bfloat16, A)
    assert geom.form == (ops.FORM_GROUPED if ragged
                         else ops.FORM_GROUPED_DECODE if cap <= 32
                         else ops.FORM_GROUPED_PREFILL)
    y = cim_mvm_grouped(x, dep, offsets, cap, device=cuda)
    want = cim_mvm_grouped_plain(x, dep, offsets, cap)
    err = (y - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    done = torch.zeros(A, dtype=torch.bool, device=cuda)
    for e in range(E):
        a = int(offsets[e])
        done[a:min(int(offsets[e + 1]), a + cap)] = True
    assert (y[~done] == 0).all()
    assert torch.equal(y, cim_mvm_grouped(x, dep, offsets, cap, device=cuda))


@pytest.mark.cuda
def test_cim_mvm_grouped_counts_and_occupancy(cuda):
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cim_mvm.ops import (
        GROUPED_DECODE_BLOCKS,
        cim_mvm_grouped,
        grouped_geometry,
        occupancy,
    )

    dep = _expert_bank(cuda, 4, 128, 64, (64, 64, 8), 1)
    offsets = torch.tensor([0, 2, 2, 5, 6], dtype=torch.int32, device=cuda)
    runtime.reset_launch_counts()
    cim_mvm_grouped(torch.randn((7, 128), device=cuda), dep, offsets, 4,
                    device=cuda)
    assert runtime.launch_counts()["cim_mvm_grouped"] == 1
    occ = occupancy(grouped_geometry(60, 128, 2048, 1408, 1408, 8, 8, 64,
                                     True, True, True))
    assert occ["blocks_per_sm"] >= 1 and occ["clusters"] is None
    # The decode form at qwen2-moe's decode step: a cluster of 8 splits I,
    # as many blocks a SM as it is built for.
    geom = grouped_geometry(60, 16, 2048, 1408, 1408, 8, 8, 64, False, True,
                            True, 17)
    occ = occupancy(geom)
    assert geom.gy == 8 and occ["clusters"] >= 1
    assert occ["blocks_per_sm"] >= GROUPED_DECODE_BLOCKS, occ


@functools.lru_cache(maxsize=2)
def _folded_bank(E, I, N, spec, seed):
    """E deployments of random (I, N) weights on imperfect devices (a
    gain, per-tile bitline permutations, read noise at sigma_read 0.05,
    expert e's tag 10 + e), each folded by the fold kernel, stacked over
    experts as ``repro_torch.deploy`` stacks an expert bank (its tags on
    the device too)."""
    cuda = torch.device("cuda")
    deps = [fold(dataclasses.replace(
        _nonideal_dep(cuda, I, N, spec, "all", seed + e),
        noise_tag=torch.tensor(10 + e, dtype=torch.int32)))
        for e in range(E)]
    bank = dataclasses.replace(deps[0], **{
        f: torch.stack([getattr(d, f) for d in deps]).contiguous()
        for f in ("codes", "pos", "scale", "gain", "col_pos", "noise_tag")})
    bank.folded = torch.stack([d.folded for d in deps]).contiguous()
    bank.device_tags = bank.noise_tag.to(cuda)
    return bank


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 4), (16, 4), (32, 8), (128, 512),
                                  (4, None), (300, "over128")],
                         ids=["cap1", "cap16", "cap32", "cap128", "ragged",
                              "over128"])
@pytest.mark.parametrize("noise", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("I,N,spec", [(2048, 1408, (64, 64, 8)),
                                      (200, 72, (16, 16, 8))],
                         ids=["qwen2-moe", "odd"])
@pytest.mark.parametrize("form", ["general", "decode", "prefill"])
def test_cim_mvm_grouped_folded_vs_plain(cuda, case, noise, dtype, I, N,
                                         spec, form):
    """Each grouped folded form (forced: the general form, the decode
    form, the prefill form) on expert banks folded from imperfect devices
    (qwen2-moe's gate shape with E = 60, and an odd shape with E = 6),
    routed as a decode step (4 or 8 tokens top-4) at capacity 1, 16 and
    32, as a prefill (512 tokens, capacity 128), ragged (experts of 0..9
    rows at capacity 4: empty experts and dropped rows) and with experts
    of 260 and 130 rows at capacity 300 (several passes of every form);
    with and without read noise, f32 and bf16 x, against the plain
    version: max|kernel - plain| <= 1e-5 * max|plain|, rows no expert
    computes exactly 0, two calls bit-identical; the geometry's own
    choice is the decode form up to capacity 32 (the general form for a
    noiseless read whose slots x column tiles fill the card), the prefill
    form above."""
    from repro_torch.kernels.cim_mvm import ops
    from repro_torch.kernels.cim_mvm.ref import cim_mvm_grouped_plain

    E = 60 if I == 2048 else 6
    bank = _folded_bank(E, I, N, spec, I + N)
    cap, T = case
    rng = np.random.default_rng(cap)
    if T is None:
        counts = np.arange(E) % 10
    elif T == "over128":
        counts = np.zeros(E, np.int64)
        counts[5], counts[min(9, E - 1)] = 260, 130
    else:
        probs = rng.random((T, E)) ** 3
        top = np.argsort(-probs, axis=1, kind="stable")[:, :4]
        counts = np.bincount(top.reshape(-1), minlength=E)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32, device=cuda)
    A = int(counts.sum()) + 1
    x = torch.randn((A, I), generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda).to(dtype)
    seed = 11 if noise else None
    forced = {"general": ops.FORM_GROUPED_FOLDED,
              "decode": ops.FORM_GROUPED_FOLDED_DECODE,
              "prefill": ops.FORM_GROUPED_FOLDED_PREFILL}[form]
    geo = (E, cap, I, N, bank.codes.shape[2], dtype == torch.bfloat16, noise,
           A)
    items = min(E, A) * -(-N // 128)
    assert ops.grouped_folded_geometry(*geo).form == (
        ops.FORM_GROUPED_FOLDED_PREFILL if cap > 32
        else ops.FORM_GROUPED_FOLDED_DECODE if noise or items < 3 * 132
        else ops.FORM_GROUPED_FOLDED)
    assert ops.grouped_folded_geometry(*geo, form=forced).form == forced
    run = lambda s=seed: ops.cim_mvm_grouped(x, bank, offsets, cap, s,
                                             device=cuda, form=forced)
    y = run()
    want = cim_mvm_grouped_plain(x, bank, offsets, cap, seed)
    err = (y - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    done = torch.zeros(A, dtype=torch.bool, device=cuda)
    for e in range(E):
        a = int(offsets[e])
        done[a:min(int(offsets[e + 1]), a + cap)] = True
    assert (y[~done] == 0).all()
    assert torch.equal(y, run())
    if noise:       # the noise is there: the noiseless read differs
        clean = run(None)
        assert (clean - y).abs().max().item() > 1e-3 * want.abs().max().item()


@pytest.mark.cuda
def test_cim_mvm_grouped_folded_counts_occupancy_and_refusal(cuda):
    """One launch counted under its own name, whichever form; each form's
    occupancy at qwen2-moe's decode step (cap 16, 17 rows) and prefill
    (cap 128, 2,049 rows) with bf16 x, with and without noise: the decode
    form in its cluster of 4 at GROUPED_FOLDED_DECODE_BLOCKS blocks a SM,
    the prefill form unsplit at two, the general form at one at least; a
    bank with a gain, col_pos and read noise but no fold raises on the
    card, as does a form forced on an unfolded bank."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cim_mvm.ops import (
        GROUPED_FOLDED_DECODE_BLOCKS,
        GROUPED_FOLDED_FORMS,
        cim_mvm_grouped,
        grouped_folded_geometry,
        occupancy,
    )

    bank = _folded_bank(6, 200, 72, (16, 16, 8), 272)
    offsets = torch.tensor([0, 2, 2, 5, 6, 6, 9], dtype=torch.int32,
                           device=cuda)
    x = torch.randn((10, 200), device=cuda)
    for form in (None, *GROUPED_FOLDED_FORMS):
        runtime.reset_launch_counts()
        cim_mvm_grouped(x, bank, offsets, 4, 3, device=cuda, form=form)
        counts = runtime.launch_counts()
        assert counts["cim_mvm_grouped_folded"] == 1
        assert counts["cim_mvm_grouped"] == 0
    for noise in (False, True):
        for form in GROUPED_FOLDED_FORMS:
            dec = grouped_folded_geometry(60, 16, 2048, 1408, 1408, True,
                                          noise, 17, form=form)
            pre = grouped_folded_geometry(60, 128, 2048, 1408, 1408, True,
                                          noise, 2049, form=form)
            od, op = occupancy(dec), occupancy(pre)
            assert od["blocks_per_sm"] >= 1 and op["blocks_per_sm"] >= 1
            if form == GROUPED_FOLDED_FORMS[1]:
                assert dec.gy == 4 and od["clusters"] >= 1
                assert od["blocks_per_sm"] >= GROUPED_FOLDED_DECODE_BLOCKS, od
            if form == GROUPED_FOLDED_FORMS[2]:
                assert pre.gy == 1 and op["blocks_per_sm"] >= 2, op
            if form == GROUPED_FOLDED_FORMS[0]:
                assert od["clusters"] is None
    with pytest.raises(ValueError, match="fold it first"):
        cim_mvm_grouped(x, dataclasses.replace(bank), offsets, 4, 3,
                        device=cuda)
    with pytest.raises(ValueError, match="folded bank only"):
        cim_mvm_grouped(x, _expert_bank(cuda, 6, 200, 72, (16, 16, 8), 1),
                        offsets, 4, device=cuda, form=GROUPED_FOLDED_FORMS[1])


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,C", [(128, 160), (1, 160)])
def test_flash_kernel_bf16_at_head_dim_128(cuda, Sq, C):
    """qwen2-moe's attention (16 heads of 128, bf16): the Dh = 128 bf16
    forms at the path's prefill and decode over a 160-slot cache whose
    unwritten slots hold EMPTY_POS, against the plain version."""
    q, k, v = (torch.from_numpy(a).to(cuda).to(torch.bfloat16)
               for a in _qkv(4, Sq, C, 16, 16, 128, 3))
    filled = 128 if Sq > 1 else C - 1
    qpos = torch.arange(filled - Sq, filled, dtype=torch.int32, device=cuda)
    kpos = torch.full((C,), EMPTY_POS, dtype=torch.int32, device=cuda)
    kpos[:filled] = torch.arange(filled, dtype=torch.int32, device=cuda)
    run = lambda: flash_attention(q, k, v, q_positions=qpos,
                                  k_positions=kpos, device=cuda)
    out = run()
    ref = flash_attention_plain(q, k, v, qpos, kpos)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_RTOL,
                               atol=2e-5)
    assert torch.equal(out, run())
