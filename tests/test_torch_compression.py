"""The port's int8 error-feedback gradient compression against the
reference's (CPU).

Bounds.  Quantisation: the int8 codes bit for bit and the scale equal to
the reference's on the same f32 input; the round trip within half a
step (the reference's bound, ``tests/test_compression.py:27``).
``psum_compressed`` over two gloo ranks: within ``max|g| / 100`` of the
uncompressed sum (the reference's bound, ``tests/test_compression.py:64``)
and equal, to f32 rounding (rtol 1e-6), to the sum the reference's
formula gives on the same payloads; each rank's residual is its own
payload's.  A two-rank training step with ``grad_compression="int8_ef"``:
replicas stay identical, the loss is the mean of the ranks' (rtol 1e-6).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.distributed.compression import (
    compress_decompress as j_compress_decompress,
)
from repro.distributed.compression import quantize_int8 as j_quantize
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.distributed import Mesh, ShardingCtx
from repro_torch.distributed.compression import (
    compress_decompress,
    dequantize_int8,
    psum_compressed,
    quantize_int8,
)
from repro_torch.models.model import init_params
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import make_train_step
from repro_torch.train.step import loss_and_grads


@pytest.mark.parametrize("seed", [0, 1, 17, 123, 999])
@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 37.5, 1e3])
def test_int8_matches_reference(seed, scale):
    x = (np.random.default_rng(seed).standard_normal(256) * scale).astype(
        np.float32)
    jq, js = j_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = (dequantize_int8(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-12


def test_error_feedback_matches_reference():
    """Fifty rounds of residual-fed compression: the port's transmitted
    values and residuals equal the reference's; the sent total tracks
    the true total within one quantisation step."""
    rng = np.random.default_rng(0)
    e, je = torch.zeros(512), jnp.zeros(512)
    sent, true = torch.zeros(512), torch.zeros(512)
    for _ in range(50):
        g = (rng.standard_normal(512) * 0.01).astype(np.float32)
        xq, e = compress_decompress(torch.from_numpy(g) + e)
        jxq, je = j_compress_decompress(jnp.asarray(g) + je)
        np.testing.assert_allclose(xq.numpy(), np.asarray(jxq), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-5,
                                   atol=1e-9)
        sent += xq
        true += torch.from_numpy(g)
    assert float((sent - true).abs().max()) < 1e-3


def _gloo(rank: int, store: str, fn: str, args: tuple, out: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        torch.save(globals()[fn](rank, *args), os.path.join(
            out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, fn: str, *args) -> list:
    mp.spawn(_gloo, args=(str(tmp_path / "store"), fn, args, str(tmp_path)),
             nprocs=2, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]


def _grads(rank: int) -> tuple[list, list]:
    """Rank ``rank``'s gradients and residuals: statistically homogeneous
    data-parallel gradients (a shared part plus 5% of the rank's own), so
    that the ranks' scales are close, the scheme's premise."""
    shared, own = (np.random.default_rng(s) for s in (10, 20 + rank))
    g, e = [], []
    for k, shape in enumerate(((64,), (8, 16), (3,))):
        x = shared.standard_normal(shape) + 0.05 * own.standard_normal(shape)
        g.append(torch.from_numpy((x * 10.0 ** -k).astype(np.float32)))
        e.append(torch.from_numpy((own.standard_normal(shape) * 1e-3
                                   * 10.0 ** -k).astype(np.float32)))
    return g, e


def _psum_rank(rank: int):
    g, e = _grads(rank)
    return psum_compressed(g, e)


def test_psum_compressed_two_gloo_ranks(tmp_path):
    got = _spawn(tmp_path, "_psum_rank")
    (g0, e0), (g1, e1) = _grads(0), _grads(1)
    for i in range(3):
        red0, red1 = got[0][0][i], got[1][0][i]
        assert torch.equal(red0, red1)
        exact = (g0[i] + e0[i]) + (g1[i] + e1[i])
        np.testing.assert_allclose(red0.numpy(), exact.numpy(), rtol=0,
                                   atol=float(exact.abs().max()) / 100)
        # The reference's formula on the same payloads.
        (q0, s0), (q1, s1) = (j_quantize(jnp.asarray((g[i] + e[i]).numpy()))
                              for g, e in ((g0, e0), (g1, e1)))
        want = (np.asarray(q0, np.int32) + np.asarray(q1, np.int32)).astype(
            np.float32) * ((s0 + s1) / 2)
        np.testing.assert_allclose(red0.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-12)
        for r, (g, e) in enumerate(((g0, e0), (g1, e1))):
            _, resid = compress_decompress(g[i] + e[i])
            np.testing.assert_allclose(got[r][1][i].numpy(), resid.numpy(),
                                       rtol=1e-6, atol=1e-12)


def _step_rank(rank: int):
    cfg = get_config("phi3-mini-3.8b", smoke=True).replace(dtype="float32")
    mesh = Mesh(("pod",), (2,), (torch.device("cpu"),), rank, 2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(params, use_error_feedback=True)
    step = make_train_step(cfg, TrainConfig(grad_compression="int8_ef",
                                            learning_rate=1e-3,
                                            warmup_steps=0),
                           ShardingCtx(mesh=mesh))
    toks = SyntheticTokenDataset(cfg.vocab_size, 16, 4, seed=1).batch_at(0)
    params, opt, m = step(params, opt, {"tokens": torch.from_numpy(toks)})
    return ({k: float(v) for k, v in m.items()}, tree_leaves(params),
            tree_leaves(opt.ef_error))


def test_compressed_train_step_two_gloo_ranks(tmp_path):
    """Each rank takes its half of the batch; both end with the same
    params, the mean loss, and a residual of their own payload."""
    got = _spawn(tmp_path, "_step_rank")
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)
    cfg = get_config("phi3-mini-3.8b", smoke=True).replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(
        SyntheticTokenDataset(cfg.vocab_size, 16, 4, seed=1).batch_at(0))
    halves = [loss_and_grads(params, cfg, {"tokens": toks[2 * r:2 * r + 2]})
              for r in (0, 1)]
    mean = (float(halves[0][1]["loss"]) + float(halves[1][1]["loss"])) / 2
    for r in (0, 1):
        np.testing.assert_allclose(got[r][0]["loss"], mean, rtol=1e-6)
        for g, ef in zip(halves[r][0], got[r][2]):
            np.testing.assert_allclose(ef.numpy(),
                                       compress_decompress(g)[1].numpy(),
                                       rtol=1e-5, atol=1e-9)
    assert any(float(x.abs().max()) > 0 for x in got[0][2])


def test_compression_needs_one_process_a_pod():
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    mesh = Mesh(("pod",), (2,), (torch.device("cpu"),) * 2)
    with pytest.raises(NotImplementedError, match="one process a pod"):
        make_train_step(cfg, TrainConfig(grad_compression="int8_ef"),
                        ShardingCtx(mesh=mesh))
    # Without the "pod" axis, or without int8_ef, nothing is compressed.
    make_train_step(cfg, TrainConfig(grad_compression="int8_ef"),
                    ShardingCtx(mesh=Mesh(("data",), (2,),
                                          (torch.device("cpu"),) * 2)))
    make_train_step(cfg, TrainConfig(), ShardingCtx(mesh=mesh))
