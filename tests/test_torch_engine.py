"""Options of the reference's engine that later slices ported keep their
cases here, now held to the ported behaviour: quantized saves round-trip
and raise on a corrupted payload like every other save; each durability
tier option builds an engine whose tier works (upload, peers, serving
cache, the tiered backends), and the remote/peer loads, per-tensor
serving, owned reads and retention round-trip."""
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core.checkpointer import FastPersistConfig as RefFP
from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import (CheckpointEngine, CheckpointSpec,
                                     available_backends)
from repro_torch.train.trainer import CheckpointPolicy


def _state():
    return {"w": torch.arange(4096, dtype=torch.float32),
            "b": torch.ones(8, dtype=torch.bfloat16)}


def _flip_byte(step_dir):
    with open(os.path.join(step_dir, "shard_000.bin"), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("fp", [dict(quantize=True),
                                dict(delta_quantize=True, keyframe_every=2)])
def test_quantized_saves_raise(tmp_path, fp):
    """Quantized keyframes and q8 delta spans round-trip within the
    blockwise bound (amax/254 per block; ``w`` is one block), and a
    flipped payload byte raises instead of loading."""
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path),
                                          fp=FastPersistConfig(**fp)))
    state = _state()
    eng.save(state, 1)
    state["w"] = state["w"] * -0.5          # a q8 delta span for step 2
    eng.save(state, 2)
    got, man = eng.load(2, device="cpu")
    assert man.extras.get("quantized", False) == bool(fp.get("quantize"))
    err = (got["w"] - state["w"]).abs().max()
    assert 0 < err <= state["w"].abs().max() / 254
    assert torch.equal(got["b"], state["b"])
    _flip_byte(os.path.join(str(tmp_path), "ckpt_00000002"))
    with pytest.raises(IOError, match="corruption"):
        eng.load(2)


@pytest.mark.parametrize("spec", [dict(upload_store="bucket"),
                                  dict(peers=["p1"]),
                                  dict(serve_cache_mb=8),
                                  dict(backend="fastpersist-tiered"),
                                  dict(backend="fastpersist-tiered-pipelined")])
def test_durability_tiers_raise(tmp_path, spec):
    """Each tier option is ported: the engine builds, saves, reaches the
    tier's durability point and restores through it bit-exact."""
    spec = {k: (str(tmp_path / v) if k == "upload_store" else
                [str(tmp_path / p) for p in v] if k == "peers" else v)
            for k, v in spec.items()}
    if spec.get("backend", "").startswith("fastpersist-tiered"):
        spec["upload_store"] = str(tmp_path / "bucket")
    elif "upload_store" in spec:
        # any backend reads the remote tier; a tiered engine fills it
        CheckpointEngine(CheckpointSpec(
            str(tmp_path / "w"), backend="fastpersist-tiered",
            upload_store=spec["upload_store"])).save(
            _state(), 1).wait_uploaded()
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path / "d"), **spec))
    h = eng.save(_state(), 1)
    h.wait()
    tier = ("remote" if "upload_store" in spec else
            "peer" if "peers" in spec else "local")
    if "backend" in spec:
        assert h.wait_uploaded().committed and h.uploaded()
    if tier == "peer":
        assert h.wait_replicated().committed and h.replicated()
    eng.close()
    if tier != "local":
        shutil.rmtree(str(tmp_path / "d" / "ckpt_00000001"))
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path / "d"), **spec))
    got, _ = eng.load(tier=tier, device="cpu")
    assert torch.equal(got["w"], _state()["w"])
    assert torch.equal(got["b"], _state()["b"])
    if spec.get("serve_cache_mb"):
        assert eng.serve_cache is not None
    eng.close()


def test_registry_keys_are_the_reference_keys():
    from repro.core.engine import available_backends as ref_backends
    assert available_backends() == ref_backends()


def test_other_tiers_and_owned_reads_raise(tmp_path):
    """load(tier="remote"), load_tensor(tier="peer"), load(owned_only)
    and load_owned are ported: each returns the saved bytes."""
    eng = CheckpointEngine(CheckpointSpec(
        str(tmp_path / "d"), backend="fastpersist-tiered",
        upload_store=str(tmp_path / "bucket"),
        peers=[str(tmp_path / "p1")], replication_factor=1))
    eng.save(_state(), 1)
    eng.wait_uploaded()
    eng.wait_replicated()
    got, _ = eng.load(tier="remote", device="cpu")
    assert torch.equal(got["w"], _state()["w"])
    assert torch.equal(eng.load_tensor("w", tier="peer"), _state()["w"])
    a = eng.load(owned_only=True, reader_rank=0, n_readers=2)
    b = eng.load_owned(1, 2)
    assert a.nbytes + b.nbytes == a.manifest.total_bytes
    from repro_torch.core.checkpointer import allgather_owned
    from repro_torch.core.serializer import deserialize
    full = deserialize(a.manifest, allgather_owned([a, b]))
    assert torch.equal(full["w"], _state()["w"])
    got, _ = eng.load(device="cpu")
    assert torch.equal(got["w"], _state()["w"])
    eng.close()


def test_reference_quantized_checkpoint_raises_on_load(tmp_path):
    """The port loads the reference's quantized checkpoint to the values
    the reference loads, and raises on a corrupted one."""
    ref = RefEngine(RefSpec(str(tmp_path), fp=RefFP(quantize=True)))
    ref.save({"w": np.arange(4096, dtype=np.float32) / 7}, 1)
    want, _ = ref.load(1)
    got, man = CheckpointEngine(CheckpointSpec(str(tmp_path))).load(1)
    assert man.extras["quantized"]
    assert got["w"].numpy().tobytes() == np.asarray(want["w"]).tobytes()
    _flip_byte(os.path.join(str(tmp_path), "ckpt_00000001"))
    with pytest.raises(IOError, match="corruption"):
        CheckpointEngine(CheckpointSpec(str(tmp_path))).load(1)


def test_retention_raises(tmp_path):
    """Retention is ported: a policy is accepted and the trainer's
    manager keeps the window."""
    from repro_torch.core.retention import RetentionManager, RetentionPolicy
    pol = CheckpointPolicy(directory=str(tmp_path),
                           retention=RetentionPolicy(keep_last=1))
    assert pol.retention.keep_last == 1
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path)))
    mgr = RetentionManager(str(tmp_path), pol.retention)
    for step in (1, 2, 3):
        eng.save(_state(), step)
        mgr.after_commit()
    assert eng.steps() == [3] and mgr.deleted == [1, 2]


def test_restore_moves_to_device_and_copies(tmp_path):
    """``load(device=...)`` places every leaf; the engine's read arena is
    reused by the next load, so the trainer copies."""
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path)))
    eng.save(_state(), 1)
    like = {"w": torch.empty(4096, device="meta"),
            "b": torch.empty(8, dtype=torch.bfloat16, device="meta")}
    got, man = eng.load(like=like, parallel=2, device="cpu")
    assert got["b"].dtype == torch.bfloat16 and torch.equal(
        got["b"].float(), torch.ones(8))
    assert [r.name for r in man.records] == ["b", "w"]


@pytest.mark.parametrize("quantize", [False, True])
def test_old_signature_backend_still_loads(tmp_path, quantize):
    """A backend registered with the pre-restore-pipeline signature of
    ``read_payload_sharded`` (no ``parallel``, no ``device``) keeps
    working for plain loads and for ``load(device=...)``: the engine
    passes it neither and moves the result itself; a quantized payload
    is then dequantized on the host."""
    from repro_torch.core import engine as eng_mod

    class OldSigBackend(eng_mod.FastPersistBackend):
        def read_payload_sharded(self, directory, step, like=None,
                                 verify=True, marker=None,
                                 volume_roots=None):     # old shape
            return super().read_payload_sharded(
                directory, step, like=like, verify=verify,
                marker=marker, volume_roots=volume_roots)

    eng_mod.register_backend("old-sig", OldSigBackend, overwrite=True)
    try:
        state = _state()
        eng = CheckpointEngine(CheckpointSpec(
            str(tmp_path), backend="old-sig",
            fp=FastPersistConfig(quantize=quantize)))
        eng.save(state, 1).wait()
        plain, _ = eng.load(1, like=state)
        moved, man = eng.load(1, like=state, device="cpu")
        assert bool(man.extras.get("quantized")) == quantize
        for got in (plain, moved):
            assert got["b"].dtype == torch.bfloat16
            assert torch.equal(got["b"].float(), torch.ones(8))
            if quantize:                 # one block, amax 4095: bound 16.1
                assert (got["w"] - state["w"]).abs().max() <= 4095 / 254
            else:
                assert torch.equal(got["w"], state["w"])
    finally:
        eng_mod.unregister_backend("old-sig")
