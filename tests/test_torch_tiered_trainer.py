"""The slice as a whole on the CPU: a reduced stablelm_1_6b Trainer of
the port checkpoints every step through ``fastpersist-tiered-pipelined``
with device-dirty deltas, two peers in distinct failure domains, an
object store and retention ``keep_last=1``; it loses its local
directory and resumes from a peer, then (the peers gone too) from the
bucket — at the same step, data position and state as its own last
save, and as a reference Trainer restored from the same tiers. The
launcher drives the same tiers with ``--device cpu``. Checkpoints are
bytes: compared exactly."""
import dataclasses
import glob
import os
import shutil

import jax
import numpy as np
import pytest

from repro import configs as rconfigs
from repro.core.retention import RetentionPolicy as RefRetention
from repro.train.trainer import CheckpointPolicy as RefPolicy
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch import configs as pconfigs
from repro_torch.convert import to_numpy
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.partition import Topology
from repro_torch.core.retention import RetentionPolicy
from repro_torch.core.upload import LocalObjectStore, remote_steps
from repro_torch.launch import train as launch
from repro_torch.train.trainer import CheckpointPolicy, Trainer, TrainerConfig
from repro_torch.tree import flatten
from test_torch_faults import TINY


def _cfgs():
    ref = dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config("stablelm_1_6b")), **TINY)
    port = dataclasses.replace(
        pconfigs.reduced(pconfigs.get_config("stablelm_1_6b")), **TINY)
    return ref, port


def _tiers(tmp_path):
    return (str(tmp_path / "bucket"),
            [f"n{i}={tmp_path}/peer{i}@rack{i}" for i in range(2)])


def _trainer(cfg, tmp_path, steps, retention=True):
    bucket, peers = _tiers(tmp_path)
    pol = CheckpointPolicy(
        directory=str(tmp_path / "ckpt"), every=1, upload_store=bucket,
        peers=peers, replication_factor=2,
        failure_domain="rack-w", hydrate_readers=2,
        serve_cache_mb=8,
        retention=RetentionPolicy(keep_last=1) if retention else None,
        fp=FastPersistConfig(device_dirty=True, keyframe_every=2,
                             topology=Topology(dp_degree=2)))
    return Trainer(TrainerConfig(model=cfg, steps=steps, global_batch=2,
                                 seq_len=16, checkpoint=pol, log_every=100),
                   device="cpu")


def _wipe(root):
    for p in glob.glob(os.path.join(root, "ckpt_*")):
        shutil.rmtree(p)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _assert_same(a_tree, b_tree):
    a, b = dict(flatten(a_tree)), dict(flatten(b_tree))
    assert sorted(a) == sorted(b)
    for name in a:
        assert _bits(a[name]) == _bits(b[name]), name


def test_trainer_survives_the_lost_node_via_peer_then_remote(tmp_path):
    ref_cfg, cfg = _cfgs()
    tr = _trainer(cfg, tmp_path, steps=3)
    assert tr.engine.spec.backend == "fastpersist-tiered-pipelined"
    tr.run()
    live = to_numpy(tr.state)
    assert [h.result().delta is not None for h in tr.saves] == \
        [False, True, False]
    # retention pins every step until its upload and replication have
    # landed (and step 1 while its delta 2 is kept); once they have, it
    # keeps one local step while the tiers hold the whole history
    tr._retain.after_commit()
    assert tr.engine.steps() == [3]
    bucket, _ = _tiers(tmp_path)
    assert remote_steps(LocalObjectStore(bucket)) == [1, 2, 3]
    for i in range(2):
        assert remote_steps(LocalObjectStore(
            str(tmp_path / f"peer{i}"))) == [1, 2, 3]
    tr.engine.close()

    # the node is lost: a new trainer walks local → peer by itself
    _wipe(str(tmp_path / "ckpt"))
    t2 = _trainer(cfg, tmp_path, steps=4)
    assert t2.restore() == 3 and t2.data.position == 3
    _assert_same(to_numpy(t2.state), live)
    assert t2.engine.last_hydrate_stats.fetched_bytes > 0
    t2.engine.close()

    # lost again, and the peers with it: the bucket serves
    _wipe(str(tmp_path / "ckpt"))
    for i in range(2):
        shutil.rmtree(str(tmp_path / f"peer{i}"))
    t3 = _trainer(cfg, tmp_path, steps=4)
    with pytest.warns(UserWarning, match="falling back to the remote"):
        assert t3.restore(tier="peer") == 3
    _assert_same(to_numpy(t3.state), live)
    _wipe(str(tmp_path / "ckpt"))
    assert t3.restore(tier="remote") == 3
    _assert_same(to_numpy(t3.state), live)

    # the reference trainer restores the same state from the same bucket
    rt = RefTrainer(RefTrainerConfig(
        model=ref_cfg, steps=4, global_batch=2, seq_len=16, log_every=100,
        checkpoint=RefPolicy(directory=str(tmp_path / "ref"), every=100,
                             upload=bucket,
                             retention=RefRetention(keep_last=1))))
    assert rt.restore(tier="remote") == 3 and rt.data.position == 3
    _assert_same(jax.tree.map(np.asarray, rt.state), live)
    # ... and both train on to the same loss
    _, rmet = rt.run(start_step=3)
    _, pmet = t3.run(start_step=3)
    assert float(pmet["loss"]) == pytest.approx(float(rmet["loss"]),
                                                rel=1e-3)
    t3.engine.close()


def test_reference_trainer_tiers_restore_into_the_port(tmp_path):
    """The reverse: a reference Trainer replicates to the peers and
    uploads; the port's trainer restores that state from a peer."""
    ref_cfg, cfg = _cfgs()
    bucket, peers = _tiers(tmp_path)
    rt = RefTrainer(RefTrainerConfig(
        model=ref_cfg, steps=2, global_batch=2, seq_len=16, log_every=100,
        checkpoint=RefPolicy(directory=str(tmp_path / "ref"), every=1,
                             upload=bucket, replicate_peers=peers,
                             keyframe_every=2)))
    rt.run()
    want = jax.tree.map(np.asarray, rt.state)
    t = _trainer(cfg, tmp_path, steps=3, retention=False)
    assert t.engine.latest_step() is None
    assert t.restore() == 2 and t.data.position == 2
    _assert_same(to_numpy(t.state), want)
    assert t.engine.steps() == [1, 2]         # the chain came with it
    t.engine.close()


def test_automatic_fallback_without_any_tier_checkpoint_starts_fresh(
        tmp_path):
    _, cfg = _cfgs()
    t = _trainer(cfg, tmp_path, steps=1)
    assert t.restore() == 0
    with pytest.raises(FileNotFoundError):
        t.restore(tier="remote")              # forced: must not hide it
    t.engine.close()


def test_launcher_restores_from_the_peer_tier_on_cpu(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    peers = f"{tmp_path}/pa@rack0,{tmp_path}/pb@rack1"
    args = ["--arch", "stablelm_1_6b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "8", "--ckpt-dir", d, "--every", "1",
            "--keyframe-every", "2", "--device-dirty", "--device", "cpu",
            "--dp", "2", "--upload-store", str(tmp_path / "bucket"),
            "--peers", peers, "--replication-factor", "2",
            "--failure-domain", "rack-w", "--hydrate-readers", "2",
            "--serve-cache-mb", "64"]
    launch.main(args)
    assert "done: loss=" in capsys.readouterr().out
    assert remote_steps(LocalObjectStore(f"{tmp_path}/pa")) == [1, 2]
    shutil.rmtree(d)
    args[4] = "3"
    launch.main(args + ["--restore", "--restore-tier", "peer"])
    out = capsys.readouterr().out
    assert "restored from step 2" in out and "done: loss=" in out
    shutil.rmtree(d)
    launch.main(args + ["--restore", "--restore-tier", "remote"])
    assert "restored from step 3" in capsys.readouterr().out
