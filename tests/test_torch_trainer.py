"""The slice as a whole: the port's Trainer on the CPU, checkpointing
every step through fastpersist-pipelined with keyframe_every=2 and
device-dirty snapshots, read back by the reference and resumed by both.

Tolerance: checkpoints are bytes, compared exactly. The step losses of a
reference Trainer and a port Trainer resumed from the same checkpoint
differ only by bf16 rounding in the forward pass (see
test_torch_model.py): within 1e-3 relative."""
import dataclasses
import gc
import shutil
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro.train.trainer import CheckpointPolicy as RefPolicy
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch import configs as pconfigs
from repro_torch.convert import to_numpy, train_state_from_numpy
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.partition import Topology
from repro_torch.launch import train as launch
from repro_torch.train.trainer import CheckpointPolicy, Trainer, TrainerConfig
from repro_torch.tree import flatten, leaves

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)


def _cfgs():
    ref = dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config("stablelm_1_6b")), **TINY)
    port = dataclasses.replace(
        pconfigs.reduced(pconfigs.get_config("stablelm_1_6b")), **TINY)
    return ref, port


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _port_trainer(cfg, d, steps):
    pol = CheckpointPolicy(
        directory=d, every=1, backend="fastpersist-pipelined",
        fp=FastPersistConfig(device_dirty=True, keyframe_every=2,
                             topology=Topology(dp_degree=2)))
    return Trainer(TrainerConfig(model=cfg, steps=steps, global_batch=2,
                                 seq_len=16, checkpoint=pol, log_every=100),
                   device="cpu")


def test_slice_trains_checkpoints_and_resumes(tmp_path):
    ref_cfg, cfg = _cfgs()
    d = str(tmp_path / "ckpt")
    tr = _port_trainer(cfg, d, steps=2)
    tr.run()
    live = {2: dict(flatten(to_numpy(tr.state)))}
    tr.cfg.steps = 3
    tr.run(start_step=2)
    live[3] = dict(flatten(to_numpy(tr.state)))
    assert [h.result().delta is not None for h in tr.saves] == \
        [False, True, False]
    # the reference engine reads the port's chain bit-equal to the live
    # state: step 2 is a v3 delta over the step-1 keyframe
    ref = RefEngine(RefSpec(d))
    for step in (2, 3):
        got, man = ref.load(step, parallel=4)
        assert man.extras["data"] == {"seed": 0, "position": step}
        assert sorted(got) == sorted(live[step])
        for name, a in got.items():
            assert _bits(a) == _bits(live[step][name]), (step, name)
    # a reference Trainer resumed from that checkpoint and the port's
    # trainer continued one step read the same batch and agree
    ref_dir = str(tmp_path / "ref_copy")
    shutil.copytree(d, ref_dir)
    rt = RefTrainer(RefTrainerConfig(
        model=ref_cfg, steps=4, global_batch=2, seq_len=16, log_every=100,
        checkpoint=RefPolicy(directory=ref_dir, every=100)))
    assert rt.restore() == 3 and rt.data.position == 3
    _, rmet = rt.run(start_step=3)
    tr.cfg.steps = 4
    _, pmet = tr.run(start_step=3)
    assert float(pmet["loss"]) == pytest.approx(float(rmet["loss"]),
                                                rel=1e-3)
    # restore() resumes at the same step, data position and state
    tr2 = _port_trainer(cfg, d, steps=4)
    assert tr2.restore() == 4
    assert tr2.data.position == tr.data.position == 4
    for (name, a), (_, b) in zip(flatten(to_numpy(tr2.state)),
                                 flatten(to_numpy(tr.state))):
        assert _bits(a) == _bits(b), name
    # ... and the restored trainer trains on
    tr2.cfg.steps = 5
    _, m = tr2.run(start_step=4)
    assert np.isfinite(float(m["loss"]))
    assert jax.tree.leaves(rt.state)             # reference state alive


def test_launcher_cli_on_cpu(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    args = ["--arch", "stablelm_1_6b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "8", "--ckpt-dir", d, "--every", "1",
            "--keyframe-every", "2", "--device-dirty", "--device", "cpu",
            "--dp", "2"]
    launch.main(args)
    out = capsys.readouterr().out
    assert "done: loss=" in out and "ckpt_stall=" in out
    launch.main(args[:4] + ["3"] + args[5:] + ["--restore"])
    out = capsys.readouterr().out
    assert "restored from step 2" in out and "done: loss=" in out


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """No silent fallback: asking for cuda without a card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(TrainerConfig(model=cfg, steps=1))
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--arch", "stablelm_1_6b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_state_from_numpy({"w": np.zeros(4, np.float32)})


@pytest.mark.parametrize("flags,error", [
    (["--peers", "n0=/x@rack0"], NotImplementedError),
    (["--upload-store", "/x"], NotImplementedError),
    (["--serve-cache-mb", "8"], NotImplementedError),
    (["--restore-tier", "peer"], NotImplementedError),
    (["--replication-factor", "2"], SystemExit),
    (["--failure-domain", "rack0"], SystemExit),
    (["--hydrate-readers", "8"], SystemExit),
])
def test_launcher_tier_flags_are_never_silent(tmp_path, monkeypatch, flags,
                                              error):
    """The durability tiers are ported: each tier flag reaches the
    trainer's checkpoint policy with the reference's meaning (``error``
    names what the flag did before the tiers were ported). The trainer
    is stubbed: the flags' end-to-end runs are in
    test_torch_tiered_trainer.py."""
    seen = {}

    class Probe:
        iter_times, ckpt_stall = [0.0], 0.0

        def __init__(self, cfg, device):
            seen["pol"], seen["device"] = cfg.checkpoint, device

        def restore(self, tier="local"):
            seen["tier"] = tier
            return 0

        def run(self, start_step=0):
            return None, {}

    monkeypatch.setattr(launch, "Trainer", Probe)
    flags = [f.replace("/x", str(tmp_path / "x")) for f in flags]
    launch.main(["--arch", "stablelm_1_6b", "--reduced", "--steps", "1",
                 "--device", "cpu", "--ckpt-dir", str(tmp_path), "--restore"]
                + flags)
    pol, flag, value = seen["pol"], flags[0], flags[1]
    got = {"--peers": pol.peers, "--upload-store": pol.upload_store,
           "--serve-cache-mb": pol.serve_cache_mb,
           "--restore-tier": seen["tier"],
           "--replication-factor": pol.replication_factor,
           "--failure-domain": pol.failure_domain,
           "--hydrate-readers": pol.hydrate_readers}[flag]
    want = {"--peers": [value], "--serve-cache-mb": 8,
            "--replication-factor": 2, "--hydrate-readers": 8}.get(
        flag, value)
    assert got == want
    assert pol.backend == ("fastpersist-tiered-pipelined"
                           if flag == "--upload-store"
                           else "fastpersist-pipelined")


@pytest.mark.parametrize("backend", ["none", "fastpersist",
                                     "fastpersist-pipelined"])
def test_dropped_state_is_freed_without_a_collection(tmp_path, backend):
    """ROADMAP C.29: with the collector off, a trainer that ran a step
    and a save frees its parameters and master weights as soon as it
    drops its state — nothing holds them in a reference cycle, and the
    pipelined engine's helper thread keeps no finished job."""
    _, cfg = _cfgs()
    pol = CheckpointPolicy(directory=str(tmp_path), backend=backend,
                           every=100,
                           fp=FastPersistConfig(topology=Topology(
                               dp_degree=2)))
    gc.collect()
    gc.disable()
    try:
        tr = Trainer(TrainerConfig(model=cfg, steps=1, global_batch=2,
                                   seq_len=16, checkpoint=pol,
                                   log_every=100), device="cpu")
        tr.run()
        if tr.engine is not None:
            tr._save(1)
            tr.saves[-1].wait()
        param = weakref.ref(leaves(tr.state.params)[0])
        master = weakref.ref(leaves(tr.state.opt.master)[0])
        tr.state = None
        assert param() is None and master() is None
    finally:
        gc.enable()
    if tr.engine is not None:
        tr.engine.close()
