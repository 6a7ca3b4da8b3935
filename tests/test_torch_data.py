"""The port's TokenStream yields the reference's token ids (exactly: both
are integer functions of the seed and the index), so a port trainer that
resumes from a reference checkpoint reads the same stream."""
import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefConfig
from repro.data.pipeline import TokenStream as RefStream
from repro_torch.data import pipeline as tp
from repro_torch.data.pipeline import DataConfig, TokenStream


@pytest.mark.parametrize("seed,index,vocab,batch,seq", [
    (0, 0, 512, 2, 16), (0, 1, 512, 2, 16), (7, 3, 100352, 4, 33),
    (123456, 99, 50000, 3, 9), (1, 2**20 + 5, 2**31 - 1, 2, 5),
    (42, 7, 3, 1, 64)])
def test_token_ids_equal_reference(seed, index, vocab, batch, seq):
    ref = RefStream(RefConfig(vocab, seq, batch, seed)).peek(index)
    got = TokenStream(DataConfig(vocab, seq, batch, seed)).peek(index)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy())
        assert got[k].dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_threefry_primitives_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), tp.prng_key(seed))
    k = jax.random.fold_in(key, 17)
    np.testing.assert_array_equal(np.asarray(k),
                                  tp.fold_in(tp.prng_key(seed), 17))
    np.testing.assert_array_equal(np.asarray(jax.random.split(k, 3)),
                                  tp.split(np.asarray(k), 3))
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(k, (5, 7), -3, 1000)),
        tp.randint(np.asarray(k), (5, 7), -3, 1000))


def test_stream_state_roundtrip():
    cfg = DataConfig(512, 8, 2, seed=3)
    s = TokenStream(cfg)
    first = [next(s)["tokens"] for _ in range(3)]
    resumed = TokenStream.from_state(cfg, s.state())
    assert resumed.position == 3
    assert (next(resumed)["tokens"] == next(s)["tokens"]).all()
    assert (TokenStream(cfg).peek(1)["tokens"] == first[1]).all()
