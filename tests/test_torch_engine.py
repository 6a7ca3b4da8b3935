"""What the port's engine does not do yet says so: every option of the
reference outside the ported slices raises NotImplementedError naming
its ROADMAP.md item, instead of degrading silently. Quantized saves are
ported: their cases here hold that they round-trip and raise on a
corrupted payload like every other save."""
import os

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
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        CheckpointEngine(CheckpointSpec(str(tmp_path), **spec))


def test_registry_keys_are_the_reference_keys():
    from repro.core.engine import available_backends as ref_backends
    assert available_backends() == ref_backends()


def test_other_tiers_and_owned_reads_raise(tmp_path):
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path)))
    eng.save(_state(), 1)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        eng.load(tier="remote")
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        eng.load_tensor("w", tier="peer")
    with pytest.raises(NotImplementedError, match="queue A item 2"):
        eng.load(owned_only=True)
    with pytest.raises(NotImplementedError, match="queue A item 2"):
        eng.load_owned(0, 2)
    got, _ = eng.load(device="cpu")
    assert torch.equal(got["w"], _state()["w"])


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
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        CheckpointPolicy(directory=str(tmp_path), retention=object())


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
