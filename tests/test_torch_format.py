"""Checkpoints cross-load between the port and the reference, bit-exact,
both ways: full saves, a v3 delta chain (``keyframe_every=2``) and a §13
striped delta (``delta_stripe_min_mb=0``), over (writers, volumes) ∈
{(1,1), (4,3)} × readers {1, 4}. Both packages write the same states;
their manifests (record names, offsets, dtypes, shapes), plans, delta
span tables, shard CRCs and COMMIT backends must agree. No tolerance:
this is a byte format."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.checkpointer import FastPersistConfig as RefFP
from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro.core.partition import Topology as RefTopology
from repro.models.registry import build_model as ref_build
from repro.train.steps import init_train_state as ref_init_state
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.partition import Topology
from repro_torch.tree import flatten

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)


def _np_state(seed=0):
    cfg = dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config("stablelm_1_6b")), **TINY)
    return jax.tree.map(np.asarray,
                        ref_init_state(ref_build(cfg),
                                       jax.random.PRNGKey(seed)))


def _mutate(tree, seed):
    """A copy of ``tree`` with a few blocks of some float leaves and the
    step counter changed (what one optimizer step leaves dirty)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, tree)
    for i, (_, a) in enumerate(flatten(out)):
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            if i % 3 == 0:
                flat = a.reshape(-1)
                idx = rng.choice(flat.size, max(1, flat.size // 500),
                                 replace=False)
                flat[idx] = (flat[idx].astype(np.float32) + 1).astype(
                    a.dtype)
        else:
            a += 1
    return out


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.detach().reshape(-1).contiguous().view(torch.uint8) \
            .numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _assert_equal_state(loaded: dict, expected_tree):
    want = dict(flatten(expected_tree))
    assert sorted(loaded) == sorted(want)
    for name, a in loaded.items():
        assert _bits(a) == _bits(want[name]), name


def _vols(root, n):
    return [os.path.join(root, f"vol{i}") for i in range(n)] if n > 1 \
        else None


def _engines(tmp_path, writers, volumes, **fp):
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    port = CheckpointEngine(CheckpointSpec(
        directory=pd, backend="fastpersist", volumes=_vols(pd + "_v", volumes),
        fp=FastPersistConfig(strategy="replica",
                             topology=Topology(dp_degree=writers), **fp)))
    ref = RefEngine(RefSpec(
        directory=rd, backend="fastpersist", volumes=_vols(rd + "_v", volumes),
        fp=RefFP(strategy="replica", topology=RefTopology(dp_degree=writers),
                 **fp)))
    return port, ref


def _meta(directory, step):
    d = os.path.join(directory, f"ckpt_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "COMMIT")) as f:
        commit = json.load(f)
    return manifest, commit


def _strip_nonces(delta):
    return {k: v for k, v in delta.items() if k not in ("gen", "base_gen")}


KINDS = {"full": dict(),
         "delta": dict(keyframe_every=2),
         "striped": dict(keyframe_every=2, delta_stripe_min_mb=0)}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writers,volumes", [(1, 1), (4, 3)])
@pytest.mark.parametrize("readers", [1, 4])
def test_cross_load_both_ways(tmp_path, kind, writers, volumes, readers):
    s1 = _np_state()
    states = [s1] if kind == "full" else [s1, _mutate(s1, 1)]
    port, ref = _engines(tmp_path, writers, volumes, **KINDS[kind])
    for step, s in enumerate(states, start=1):
        port.save(train_state_from_numpy(s, device="cpu"), step,
                  {"step": step}).wait()
        ref.save(s, step, {"step": step}).wait()
    last = len(states)
    pm, pc = _meta(port.directory, last)
    rm, rc = _meta(ref.directory, last)
    # the same byte format: records, plan, layout version, shard CRCs,
    # delta span table and COMMIT backend
    assert pm["records"] == rm["records"] and len(pm["records"]) == 49
    assert pm["total_bytes"] == rm["total_bytes"]
    assert pm["plan"] == rm["plan"]
    assert pm["layout_version"] == rm["layout_version"]
    assert pm.get("index") == rm.get("index")
    assert pc["backend"] == rc["backend"] == "fastpersist"
    assert pc["shards"] == rc["shards"]
    if kind != "full":
        assert pc["delta"] and rc["delta"]
        assert _strip_nonces(pc["delta"]) == _strip_nonces(rc["delta"])
        assert pc["delta"]["striped"] == (kind == "striped")
    # port-written → reference reader, reference-written → port reader
    got_ref, man = RefEngine(RefSpec(
        directory=port.directory, volumes=port.spec.volumes)).load(
        parallel=readers)
    _assert_equal_state(got_ref, states[-1])
    assert man.extras == {"step": last}
    got_port, man = CheckpointEngine(CheckpointSpec(
        directory=ref.directory, volumes=ref.spec.volumes)).load(
        parallel=readers)
    _assert_equal_state(got_port, states[-1])
    # and into the port's own tree structure
    like = train_state_from_numpy(s1, device="cpu")
    tree, _ = CheckpointEngine(CheckpointSpec(
        directory=ref.directory, volumes=ref.spec.volumes)).load(
        like=like, parallel=readers)
    _assert_equal_state(dict(flatten(tree)), states[-1])
    assert type(tree).__name__ == "TrainState"


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_baseline_backend_cross_loads(tmp_path, writer):
    s = _np_state(3)
    d = str(tmp_path / "ckpt")
    if writer == "port":
        CheckpointEngine(CheckpointSpec(d, backend="baseline")).save(
            train_state_from_numpy(s, device="cpu"), 5, {"step": 5})
        got, man = RefEngine(RefSpec(d)).load()
    else:
        RefEngine(RefSpec(d, backend="baseline")).save(s, 5, {"step": 5})
        got, man = CheckpointEngine(CheckpointSpec(d)).load()
    _assert_equal_state(got, s)
    assert _meta(d, 5)[1]["backend"] == "baseline"


def test_pipelined_backend_key_and_single_reader(tmp_path):
    """The async backend stamps the reference's registry key; the
    single-reader (non-parallel) load path reads it."""
    s = _np_state(4)
    d = str(tmp_path / "ckpt")
    eng = CheckpointEngine(CheckpointSpec(d, backend="fastpersist-pipelined"))
    eng.save(train_state_from_numpy(s, device="cpu"), 1, {"step": 1})
    eng.drain()
    assert _meta(d, 1)[1]["backend"] == "fastpersist-pipelined"
    got, _ = RefEngine(RefSpec(d)).load()
    _assert_equal_state(got, s)
    got, _ = CheckpointEngine(CheckpointSpec(d)).load()
    _assert_equal_state(got, s)


def test_load_tensor_reads_one_record(tmp_path):
    s = _np_state(5)
    d = str(tmp_path / "ckpt")
    eng = CheckpointEngine(CheckpointSpec(d, fp=FastPersistConfig(
        strategy="replica", topology=Topology(dp_degree=4))))
    eng.save(train_state_from_numpy(s, device="cpu"), 1)
    name = ".opt/.master/embed"
    t = eng.load_tensor(name)
    assert _bits(t) == _bits(dict(flatten(s))[name])
    assert tuple(t.shape) == dict(flatten(s))[name].shape
