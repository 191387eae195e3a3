"""The port's data pipeline (``repro_torch.data``) against ``repro.data``.

Both are numpy: every window and batch must be byte-identical, over
several seeds, steps and host splits.
"""
import numpy as np
import pytest

from repro.configs import resolve as jresolve
from repro.data import pipeline as jpipe
from repro_torch.configs import resolve
from repro_torch.data import (ShardedLoader, SyntheticLM, TokenDataset,
                              make_loader)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_windows_byte_identical(seed):
    mine, theirs = SyntheticLM(1000, seed), jpipe.SyntheticLM(1000, seed)
    _same(mine.probs, theirs.probs)
    for offset, length in ((0, 63), (12345, 127), (2**40 + 3, 32),
                           (99, 1)):
        _same(mine.window(offset, length), theirs.window(offset, length))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("num_hosts", [1, 2])
def test_loader_batches_byte_identical(seed, num_hosts):
    cfg, jcfg = resolve("llama3.2-3b", smoke=True), \
        jresolve("llama3.2-3b", smoke=True)
    for host in range(num_hosts):
        mine = make_loader(cfg, 63, 4, seed=seed, host_index=host,
                           num_hosts=num_hosts)
        theirs = jpipe.make_loader(jcfg, 63, 4, seed=seed, host_index=host,
                                   num_hosts=num_hosts)
        for step in (0, 1, 11):
            for a, b in zip(mine.batch_at(step), theirs.batch_at(step)):
                _same(a, b)
            for a, b in zip(mine.batch_slice(step, 1, 2),
                            theirs.batch_slice(step, 1, 2)):
                _same(a, b)
        toks, labels = mine.batch_at(5)
        assert toks.shape == labels.shape == (4 // num_hosts, 63)
        np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])


def test_token_dataset_on_a_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 500, 4096).astype(
        np.uint16).tofile(path)
    mine, theirs = TokenDataset(str(path)), jpipe.TokenDataset(str(path))
    assert len(mine) == len(theirs) == 4096
    assert mine.vocab_size == theirs.vocab_size
    for offset in (0, 17, 4090, 10**6):
        _same(mine.window(offset, 31), theirs.window(offset, 31))
    cfg, jcfg = resolve("llama3.2-3b", smoke=True), \
        jresolve("llama3.2-3b", smoke=True)
    a = make_loader(cfg, 31, 2, path=str(path), seed=2)
    b = jpipe.make_loader(jcfg, 31, 2, path=str(path), seed=2)
    for x, y in zip(a.batch_at(3), b.batch_at(3)):
        _same(x, y)


def test_prefetch_yields_batch_at_in_order():
    loader = ShardedLoader(SyntheticLM(300, 1), 31, 2, seed=1)
    it = loader.prefetch(4, depth=2)
    for want_step in (4, 5, 6):
        step, toks, labels = next(it)
        assert step == want_step
        for a, b in zip((toks, labels), loader.batch_at(step)):
            _same(a, b)
    it.close()


def test_uneven_host_split_raises():
    loader = ShardedLoader(SyntheticLM(300, 1), 31, 3, num_hosts=2)
    with pytest.raises(ValueError, match="divide evenly"):
        loader.batch_at(0)
