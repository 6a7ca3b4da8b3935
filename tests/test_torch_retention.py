"""Step retention of the port (``repro_torch.core.retention``) against the
reference's, on the CPU: ``collectable`` gives the reference's step sets
on the same directory — the rolling window, milestones, a keyframe that
a kept delta needs, and steps pinned because their upload is queued,
in flight or failed — and ``collect`` deletes the same steps on every
volume. No tolerance: step sets."""
import os
import shutil

import pytest

import test_torch_faults as faults
from repro.core import retention as rret
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.retention import (RetentionManager, RetentionPolicy,
                                        collect, collectable)
from test_torch_tiers import engine, save_all

POLICIES = {"last2": dict(keep_last=2), "last1": dict(keep_last=1),
            "milestones": dict(keep_last=1, keep_every=3)}


def _both(policy):
    return RetentionPolicy(**policy), rret.RetentionPolicy(**policy)


def _steps(root):
    return sorted(int(n.split("_")[1]) for n in os.listdir(root)
                  if n.startswith("ckpt_") and "." not in n)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("kind,writer", [("keyframe", "port"),
                                         ("chain", "port"),
                                         ("chain", "ref"),
                                         ("striped", "port")])
def test_collectable_and_collect_equal_reference(tmp_path, policy, kind,
                                                 writer):
    """Six saves (keyframes, or a keyframe every 3rd save with deltas
    between): the same collectable set, then the same deletions, across
    all volumes of a striped layout."""
    eng = engine(writer, str(tmp_path / "w"), kind=kind)
    s = faults.np_state()
    states = [s]
    for i in range(5):
        states.append(faults.mutate(states[-1], i))
    save_all(writer, eng, states)
    eng.close()
    shutil.copytree(str(tmp_path / "w"), str(tmp_path / "c"))
    vols = eng.volume_roots() if eng.spec.volumes else None
    pp, rp = _both(POLICIES[policy])
    want = rret.collectable(str(tmp_path / "c"), rp)
    assert collectable(str(tmp_path / "w"), pp) == want
    if kind != "keyframe":                  # keyframes 1, 4; deltas chain
        assert not set(want) & {4, 5, 6}
    assert collect(str(tmp_path / "w"), pp, vols) == want
    rret.collect(str(tmp_path / "c"), rp)
    assert _steps(str(tmp_path / "w")) == _steps(str(tmp_path / "c"))
    if vols:
        for v in vols:
            left = {n.split(".")[0] for n in os.listdir(v)}
            assert left == {f"ckpt_{s:08d}" for s in
                            _steps(str(tmp_path / "w"))}
    got, _ = engine("port", str(tmp_path / "w"), kind=kind).load()
    faults.assert_equal_state(got, states[-1])


@pytest.mark.parametrize("pinned", [(), (1,), (2, 3), (5,)])
def test_pinned_steps_and_their_chains_are_kept(tmp_path, pinned):
    """A pinned step (its upload queued, in flight or failed) is never
    collectable, and neither is any chain ancestor of it."""
    eng = engine("port", str(tmp_path / "w"), kind="chain")
    states = [faults.np_state()]
    for i in range(5):
        states.append(faults.mutate(states[-1], i))
    save_all("port", eng, states)
    eng.close()
    pp, rp = _both(dict(keep_last=1))
    got = collectable(str(tmp_path / "w"), pp, pinned=pinned)
    assert got == rret.collectable(str(tmp_path / "w"), rp, pinned=pinned)
    for p in pinned:
        assert p not in got
    if 5 in pinned:                          # 5's chain: 4 (keyframe)
        assert 4 not in got


def test_upload_pinning_holds_until_the_bucket_has_the_step(tmp_path):
    """Uploads blocked behind a closed gate: the manager deletes nothing
    (every step is pinned), then applies the policy once they land — as
    the reference's manager does on the same sequence."""
    store = faults.FlakyStore(str(tmp_path / "bucket"))
    store.hold_puts()
    eng = engine("port", str(tmp_path / "w"), store)
    retain = RetentionManager(eng.directory, RetentionPolicy(keep_last=1),
                              eng.volume_roots(), upload=eng.upload_manager)
    for step in (1, 2, 3):
        eng.save(train_state_from_numpy(faults.np_state(step),
                                        device="cpu"), step).wait()
        retain.after_commit()
    assert retain.deleted == [] and eng.steps() == [1, 2, 3]
    assert eng.upload_manager.unuploaded_steps() == [1, 2, 3]
    ref_pol = rret.RetentionPolicy(keep_last=1)
    assert rret.collectable(
        eng.directory, ref_pol,
        pinned=eng.upload_manager.unuploaded_steps()) == []
    store.release_puts()
    eng.wait_uploaded()
    retain.after_commit()
    assert retain.deleted == [1, 2] and eng.steps() == [3]
    eng.close()


def test_failed_upload_stays_pinned(tmp_path):
    store = faults.FlakyStore(str(tmp_path / "bucket"), fail_commits=True)
    eng = engine("port", str(tmp_path / "w"), store)
    retain = RetentionManager(eng.directory, RetentionPolicy(keep_last=1),
                              eng.volume_roots(), upload=eng.upload_manager)
    for step in (1, 2):
        h = eng.save(train_state_from_numpy(faults.np_state(step),
                                            device="cpu"), step)
        with pytest.raises(IOError):
            h.wait_uploaded()
        retain.after_commit()
    assert eng.upload_manager.unuploaded_steps() == [1, 2]
    assert retain.deleted == [] and eng.steps() == [1, 2]
    with pytest.raises(IOError):
        eng.wait_uploaded()
    eng.close()


def test_remote_and_peer_windows_prune_on_their_workers(tmp_path):
    bucket = str(tmp_path / "bucket")
    peers = [f"n{i}={tmp_path}/peer{i}@rack{i}" for i in range(2)]
    eng = engine("port", str(tmp_path / "w"), bucket, peers=peers,
                 replication_factor=2)
    retain = RetentionManager(
        eng.directory, RetentionPolicy(keep_last=1, remote_keep_last=2,
                                       peer_keep_last=1),
        eng.volume_roots(), upload=eng.upload_manager,
        peers=eng.peer_replicator)
    for step in (1, 2, 3, 4):
        h = eng.save(train_state_from_numpy(faults.np_state(step),
                                            device="cpu"), step)
        h.wait_uploaded()
        h.wait_replicated()
        retain.after_commit()
    eng.wait_uploaded()
    eng.wait_replicated()
    from repro_torch.core.upload import LocalObjectStore, remote_steps
    assert eng.steps() == [4]
    assert remote_steps(LocalObjectStore(bucket)) == [3, 4]
    assert all(remote_steps(LocalObjectStore(str(tmp_path / f"peer{i}")))
               == [4] for i in range(2))
    assert sorted(retain.remote_deleted) == [1, 2]
    eng.close()
