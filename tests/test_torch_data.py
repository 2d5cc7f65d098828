"""The port's data pipeline against the reference's (CPU).

Tolerances: none.  ``batch_at`` is bit-identical to the reference's for
the same (seed, step, shape), synthetic and memmapped; the reference's
own determinism contracts (``tests/test_data.py``) hold on the port.
"""
import numpy as np
import pytest

from repro.data import MemmapTokenDataset as JMemmap
from repro.data import SyntheticTokenDataset as JSynthetic
from repro.data import make_dataset as j_make_dataset
from repro_torch.data import (
    MemmapTokenDataset,
    SyntheticTokenDataset,
    make_dataset,
)


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("vocab,seq,batch", [(1000, 64, 8), (32064, 128, 4),
                                             (517, 1, 3)])
def test_synthetic_batches_bit_identical(seed, vocab, seq, batch):
    a = SyntheticTokenDataset(vocab, seq, batch, seed=seed)
    b = JSynthetic(vocab, seq, batch, seed=seed)
    for step in (0, 1, 7, 123456):
        x, y = a.batch_at(step), b.batch_at(step)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_memmap_batches_bit_identical(tmp_path, dtype):
    path = str(tmp_path / "toks.bin")
    (np.arange(10_000) * 7919 % 70_000).astype(dtype).tofile(path)
    a = MemmapTokenDataset(path, 1000, 64, 4, seed=2, dtype=dtype)
    b = JMemmap(path, 1000, 64, 4, seed=2, dtype=dtype)
    for step in (0, 3, 99):
        np.testing.assert_array_equal(a.batch_at(step), b.batch_at(step))
    short = str(tmp_path / "short.bin")
    np.zeros(10, np.uint16).tofile(short)
    with pytest.raises(ValueError):
        MemmapTokenDataset(short, 1000, 64, 4)


def test_make_dataset(tmp_path):
    kw = dict(vocab_size=300, seq_len=16, global_batch=2, seed=4)
    np.testing.assert_array_equal(
        make_dataset("synthetic", **kw).batch_at(5),
        j_make_dataset("synthetic", **kw).batch_at(5))
    path = str(tmp_path / "t.bin")
    np.arange(500, dtype=np.uint16).tofile(path)
    assert isinstance(make_dataset("memmap", path=path, **kw),
                      MemmapTokenDataset)
    with pytest.raises(KeyError):
        make_dataset("parquet", **kw)


# The reference's own contracts, on the port.

def test_synthetic_deterministic_in_step():
    a = SyntheticTokenDataset(1000, 64, 8, seed=7)
    b = SyntheticTokenDataset(1000, 64, 8, seed=7)
    np.testing.assert_array_equal(a.batch_at(5), b.batch_at(5))
    assert not np.array_equal(a.batch_at(5), a.batch_at(6))
    assert not np.array_equal(SyntheticTokenDataset(1000, 64, 8, 1).batch_at(0),
                              SyntheticTokenDataset(1000, 64, 8, 2).batch_at(0))


def test_synthetic_shapes_range_and_learnable():
    x = SyntheticTokenDataset(517, 32, 4).batch_at(0)
    assert x.shape == (4, 33) and x.dtype == np.int32
    assert x.min() >= 0 and x.max() < 517
    x = SyntheticTokenDataset(256, 128, 4, seed=0).batch_at(0).astype(np.int64)
    det = ((x[:, :-1] * 2654435761 + np.roll(x, 1, 1)[:, :-1] * 40503)
           % 256) == x[:, 1:]
    assert det.mean() > 0.5
