"""The serving read path of the port (``repro_torch.core.serve``) against
the reference's, on the CPU: ``load_tensor`` from the remote tier and
from a peer gives the reference's bytes as a ``torch.Tensor`` (bf16 as
``torch.bfloat16``) on the requested device, and the read cache hits,
misses, fetches and evicts as the reference's does on the same reads.
No tolerance: bytes and counters."""
import glob
import os
import shutil

import numpy as np
import pytest
import torch

import test_torch_faults as faults
from repro.core import serve as rserve
from repro.core import upload as rupload
from repro_torch.core import upload
from repro_torch.core.serve import ReadCache, load_tensor_remote
from repro_torch.core.upload import LocalObjectStore
from repro_torch.tree import flatten
from test_torch_tiers import engine, save_all, wipe_local


def _uploaded(tmp_path, writer="port", kind="striped", n_states=1):
    """A bucket holding ``n_states`` generations of the reduced stablelm
    state, written by ``writer`` (``kind`` "striped": over 4 writers and 2
    volumes, the later saves deltas; "keyframe": one writer, all full)."""
    bucket = str(tmp_path / "bucket")
    w = engine(writer, str(tmp_path / "w"), bucket, kind,
               backend="fastpersist-tiered")
    save_all(writer, w, [faults.np_state(s) for s in range(n_states)])
    w.wait_uploaded()
    w.close()
    wipe_local(w)
    return bucket


def _ref_bits(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_load_tensor_remote_equals_reference(tmp_path, writer):
    """Every record, straight off the bucket: the port's tensor has the
    reference's bytes, shape and dtype."""
    bucket = _uploaded(tmp_path, writer)
    want = dict(flatten(faults.np_state(0)))
    for name, arr in want.items():
        got = load_tensor_remote(LocalObjectStore(bucket), name)
        ref = rserve.load_tensor_remote(rupload.LocalObjectStore(bucket),
                                        name)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert tuple(got.shape) == tuple(np.shape(ref)), name
        assert faults.bits(got) == _ref_bits(ref) == _ref_bits(arr), name
        if arr.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16


def test_load_tensor_remote_places_on_device_and_stays_frugal(tmp_path):
    bucket = _uploaded(tmp_path)
    out = []
    name = ".params/embed"
    got = load_tensor_remote(bucket, name, device="meta", stats_out=out)
    assert got.device.type == "meta"
    st = out[-1]
    assert st.tensor_bytes == dict(flatten(faults.np_state()))[name].nbytes
    assert 0 < st.fetched_bytes < st.total_bytes
    assert glob.glob(str(tmp_path / "w" / "ckpt_*")) == []


@pytest.mark.parametrize("tier", ["remote", "peer"])
def test_engine_load_tensor_tiers_equal_reference(tmp_path, tier):
    """engine.load_tensor(tier=...) of both packages on one writer's
    tiers (a bucket and two peers): equal bytes; nothing hydrated."""
    bucket = str(tmp_path / "bucket")
    peers = [f"n{i}={tmp_path}/peer{i}@rack{i}" for i in range(2)]
    w = engine("ref", str(tmp_path / "w"), bucket, "striped", peers=peers,
               replication_factor=2)
    save_all("ref", w, [faults.np_state(3)])
    w.wait_uploaded()
    w.wait_replicated()
    w.close()
    port = engine("port", str(tmp_path / "p"), bucket, peers=peers,
                  backend="fastpersist", serve_cache_mb=8)
    ref = engine("ref", str(tmp_path / "r"), bucket, peers=peers,
                 backend="fastpersist", serve_cache_mb=8)
    for name, arr in flatten(faults.np_state(3)):
        got = port.load_tensor(name, tier=tier, device="cpu")
        assert faults.bits(got) == _ref_bits(
            ref.load_tensor(name, tier=tier)) == _ref_bits(arr), name
    assert port.steps() == [] and ref.steps() == []
    for a, b in zip(port.last_serve, ref.last_serve):
        assert (a.name, a.step, a.tensor_bytes, a.total_bytes, a.n_spans,
                a.fetched_bytes, a.cache_hit_bytes) == \
            (b.name, b.step, b.tensor_bytes, b.total_bytes, b.n_spans,
             b.fetched_bytes, b.cache_hit_bytes)
    port.close()
    ref.close()


def _cache_counters(c):
    s = c.stats
    return (s.hit_bytes, s.fetched_bytes, s.n_hits, s.n_misses,
            s.evictions, s.quarantined, c.cached_bytes)


@pytest.mark.parametrize("max_kb,block_kb", [(64 << 10, 1024), (96, 32)])
def test_cache_hits_and_misses_as_the_reference(tmp_path, max_kb,
                                                block_kb):
    """The same reads through a port and a reference cache of the same
    size: equal counters after every read, cold and warm, with and
    without evictions."""
    bucket = _uploaded(tmp_path, kind="keyframe", n_states=2)
    caches = (ReadCache(str(tmp_path / "pc"), max_kb << 10,
                        block_bytes=block_kb << 10),
              rserve.ReadCache(str(tmp_path / "rc"), max_kb << 10,
                               block_bytes=block_kb << 10))
    names = [".params/embed", ".opt/.m/embed", ".params/embed",
             ".params/layers/attn/wq", ".params/embed"]
    for step in (1, 2, 1):
        for name in names:
            po, ro = [], []
            a = load_tensor_remote(bucket, name, step=step,
                                   cache=caches[0], stats_out=po)
            b = rserve.load_tensor_remote(bucket, name, step=step,
                                          cache=caches[1], stats_out=ro)
            assert faults.bits(a) == _ref_bits(b)
            assert _cache_counters(caches[0]) == _cache_counters(caches[1])
            assert (po[0].fetched_bytes, po[0].cache_hit_bytes) == \
                (ro[0].fetched_bytes, ro[0].cache_hit_bytes)
    st = caches[0].stats
    assert st.n_hits > 0 and st.n_misses > 0
    assert (st.evictions > 0) == (max_kb < 1024)


def test_cache_backs_hydration_like_the_reference(tmp_path):
    """A cold hydration through the cache fetches every byte, a warm one
    after the local directory is lost fetches none — in both packages,
    with equal counters."""
    bucket = _uploaded(tmp_path)
    for pkg, hyd, cache_cls in (("p", upload.hydrate, ReadCache),
                                ("r", rupload.hydrate, rserve.ReadCache)):
        cache = cache_cls(str(tmp_path / f"{pkg}cache"), 64 << 20)
        root = str(tmp_path / pkg)
        hyd(bucket, root, cache=cache, readers=4)
        cold = cache.stats.fetched_bytes
        for p in glob.glob(os.path.join(root, "ckpt_*")):
            shutil.rmtree(p)
        hyd(bucket, root, cache=cache, readers=4)
        assert cache.stats.fetched_bytes == cold > 0
        assert cache.stats.hit_bytes >= cold
        if pkg == "p":
            port_counters = _cache_counters(cache)
        else:
            assert _cache_counters(cache) == port_counters


def test_load_tensor_refuses_delta_generations_like_the_reference(tmp_path):
    bucket = str(tmp_path / "bucket")
    w = engine("port", str(tmp_path / "w"), bucket, "chain")
    save_all("port", w, [faults.np_state(0),
                         faults.mutate(faults.np_state(0), 1)])
    w.wait_uploaded()
    w.close()
    with pytest.raises(NotImplementedError, match="delta"):
        load_tensor_remote(bucket, ".params/embed", step=2)
    with pytest.raises(NotImplementedError, match="delta"):
        rserve.load_tensor_remote(bucket, ".params/embed", step=2)
    with pytest.raises(KeyError):
        load_tensor_remote(bucket, "no.such.tensor", step=1)
