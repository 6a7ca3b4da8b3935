"""The object-store tier of the port (``repro_torch.core.upload``) against
the reference's, on the CPU: a generation either package uploads
hydrates and loads bit-exact through the other (a keyframe, a v3 delta
chain and a §13 striped chain), both give the same object keys and
``cas/<crc32>-<size>`` digests for the same shards, the remote COMMIT is
written last, a crash before it leaves nothing observable, retries are
idempotent, prune leaves no orphans, and hydration reuses intact local
shards and refuses corrupted remote ones. Checkpoints are bytes: no
tolerance."""
import glob
import json
import os
import shutil

import pytest

import test_torch_faults as faults
from repro.core import upload as rupload
from repro.core.checkpointer import FastPersistConfig as RefFP
from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro.core.partition import Topology as RefTopology
from repro_torch.convert import train_state_from_numpy
from repro_torch.core import layout, upload
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.partition import Topology
from repro_torch.core.upload import (HydrateStats, LocalObjectStore,
                                     UploadManager, hydrate, remote_steps)

KINDS = {"keyframe": dict(),
         "chain": dict(keyframe_every=3),
         "striped": dict(keyframe_every=3, delta_stripe_min_mb=0)}


def _geometry(kind):
    """(writers, volumes): the striped chain spreads over 4 writers and 2
    volumes, the others single-stream into one."""
    return (4, 2) if kind == "striped" else (1, 1)


def _states(kind):
    s1 = faults.np_state()
    if kind == "keyframe":
        return [s1]
    s2 = faults.mutate(s1, 1)
    return [s1, s2, faults.mutate(s2, 2)]


def _vols(root, n):
    return [os.path.join(root, f"vol{i}") for i in range(n)] if n > 1 \
        else None


def engine(pkg, root, store=None, kind="keyframe", backend=None, **kw):
    """A ``pkg`` ("port" or "ref") engine under ``root``; tiered when a
    store is given (unless ``backend`` says otherwise)."""
    writers, volumes = _geometry(kind)
    if backend is None:
        backend = "fastpersist-tiered" if store is not None \
            else "fastpersist"
    if pkg == "port":
        return CheckpointEngine(CheckpointSpec(
            directory=root, backend=backend, upload_store=store,
            volumes=_vols(root + "_v", volumes),
            fp=FastPersistConfig(strategy="replica",
                                 topology=Topology(dp_degree=writers),
                                 **KINDS[kind]), **kw))
    return RefEngine(RefSpec(
        directory=root, backend=backend, upload_store=store,
        volumes=_vols(root + "_v", volumes),
        fp=RefFP(strategy="replica", topology=RefTopology(dp_degree=writers),
                 **KINDS[kind]), **kw))


def save_all(pkg, eng, states):
    for step, s in enumerate(states, start=1):
        st = train_state_from_numpy(s, device="cpu") if pkg == "port" else s
        eng.save(st, step, {"step": step}).wait()


def wipe_local(eng):
    """The lost node: every local checkpoint artifact of ``eng`` goes."""
    for root in [eng.spec.directory, *(eng.spec.volumes or [])]:
        for p in glob.glob(os.path.join(root, "ckpt_*")):
            shutil.rmtree(p, ignore_errors=True)


def _remote_commits(store):
    """{step: remote COMMIT} of every committed generation."""
    return {s: upload.read_remote_commit(store, s, g)
            for s, g in upload.remote_generations(store)}


# ====================================================== cross-package
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_remote_generation_cross_hydrates(tmp_path, kind, writer, reader):
    """One package uploads, the local directory is lost, the other
    hydrates the newest generation (walking the chain) and loads it
    bit-exact."""
    states = _states(kind)
    bucket = str(tmp_path / "bucket")
    w = engine(writer, str(tmp_path / "w"), bucket, kind)
    save_all(writer, w, states)
    w.wait_uploaded()
    w.close()
    wipe_local(w)
    assert remote_steps(LocalObjectStore(bucket)) == \
        rupload.remote_steps(rupload.LocalObjectStore(bucket)) == \
        list(range(1, len(states) + 1))
    r = engine(reader, str(tmp_path / "r"), bucket, kind,
               backend="fastpersist")
    got, man = r.load(tier="remote")
    faults.assert_equal_state(got, states[-1])
    assert man.extras == {"step": len(states)}
    if kind != "keyframe":                     # the whole chain came
        assert r.steps() == [1, 2, 3]
        assert layout.read_commit_marker(
            os.path.join(r.directory, "ckpt_00000003"))["delta"]["striped"] \
            == (kind == "striped")


@pytest.mark.parametrize("kind", list(KINDS))
def test_cas_keys_and_objects_equal_for_equal_state(tmp_path, kind):
    """The same states uploaded by both packages: the same payload
    objects under the same ``cas/<crc32>-<size>`` keys (manifest.json
    differs by its per-save nonce in both packages, so it is left out),
    the same object sizes and the same shard entries."""
    states = _states(kind)
    stores = {}
    for pkg in ("port", "ref"):
        eng = engine(pkg, str(tmp_path / pkg), str(tmp_path / f"b_{pkg}"),
                     kind)
        save_all(pkg, eng, states)
        eng.wait_uploaded()
        eng.close()
        stores[pkg] = LocalObjectStore(str(tmp_path / f"b_{pkg}"))
    pc, rc = (_remote_commits(stores[p]) for p in ("port", "ref"))
    assert sorted(pc) == sorted(rc) == list(range(1, len(states) + 1))
    payload_keys = {}
    for pkg, commits in (("port", pc), ("ref", rc)):
        keys = set()
        for step, c in commits.items():
            digests = {n: d for n, d in c["object_digest"].items()
                       if n != layout.MANIFEST_FILE}
            assert digests, step
            keys |= {upload.cas_key(d) for d in digests.values()}
        payload_keys[pkg] = keys
    assert payload_keys["port"] == payload_keys["ref"]
    for step in pc:
        a, b = pc[step], rc[step]
        for field in ("objects", "object_digest"):
            strip = lambda m: {n: v for n, v in m.items()  # noqa: E731
                               if n != layout.MANIFEST_FILE}
            assert strip(a[field]) == strip(b[field]), (step, field)
        assert a["shards"] == b["shards"]
        assert bool(a.get("delta")) == bool(b.get("delta")) == (step > 1)
    # every payload object in either bucket is the same bytes
    for key in payload_keys["port"]:
        assert stores["port"].get(key) == stores["ref"].get(key), key


def test_naming_and_digest_functions_match_reference(tmp_path):
    """remote_generation / remote_prefix / entry_digest / cas_key /
    object_key give the reference's strings on the same inputs."""
    eng = engine("port", str(tmp_path / "p"))
    save_all("port", eng, _states("keyframe"))
    d = os.path.join(eng.directory, "ckpt_00000001")
    marker = layout.read_commit_marker(d)
    assert upload.remote_generation(marker) == \
        rupload.remote_generation(marker)
    gen = upload.remote_generation(marker)
    assert upload.remote_prefix(1, gen) == rupload.remote_prefix(1, gen)
    assert upload.parse_remote_prefix(upload.remote_prefix(7, gen)) == \
        rupload.parse_remote_prefix(rupload.remote_prefix(7, gen)) == (7, gen)
    files = layout.commit_files(d, marker, None, digests=True)
    for f in files:
        assert upload.entry_digest(f) == rupload.entry_digest(f)
        assert upload.cas_key(upload.entry_digest(f)) == \
            rupload.cas_key(rupload.entry_digest(f))
    commit = {"object_digest": {"shard_000.bin": "0badf00d-10"}}
    for name in ("shard_000.bin", "manifest.json"):
        assert upload.object_key(commit, "ckpt_00000001.gen-x", name) == \
            rupload.object_key(commit, "ckpt_00000001.gen-x", name)


# ============================================== COMMIT order and crashes
def test_remote_commit_written_last(tmp_path):
    store = faults.OrderAssertingStore(str(tmp_path / "bucket"))
    eng = engine("port", str(tmp_path / "p"), store, "striped")
    save_all("port", eng, _states("striped"))
    eng.wait_uploaded()
    eng.close()
    assert remote_steps(store) == [1, 2, 3]


def test_crash_before_remote_commit_is_unobservable(tmp_path):
    """The payload objects land, the COMMIT put dies: neither package
    sees a generation, and neither can hydrate one."""
    store = faults.FlakyStore(str(tmp_path / "bucket"), fail_commits=True)
    eng = engine("port", str(tmp_path / "p"), store)
    h = eng.save(train_state_from_numpy(faults.np_state(3), device="cpu"), 5)
    h.wait()                                   # the local commit is fine
    with pytest.raises(IOError, match="injected crash"):
        h.wait_uploaded()
    assert not h.uploaded()
    with pytest.raises(IOError, match="injected crash"):
        eng.wait_uploaded()
    eng.close()
    assert store.list() != []
    ref_store = rupload.LocalObjectStore(str(tmp_path / "bucket"))
    assert remote_steps(store) == rupload.remote_steps(ref_store) == []
    with pytest.raises(FileNotFoundError):
        hydrate(store, str(tmp_path / "h1"))
    with pytest.raises(FileNotFoundError):
        rupload.hydrate(ref_store, str(tmp_path / "h2"))


def test_flaky_store_retries_once_and_reference_hydrates(tmp_path):
    """A transient failure of one payload put is retried inside the
    attempt: every object lands exactly once, and the reference hydrates
    the generation bit-exact."""
    src = engine("port", str(tmp_path / "p"))
    save_all("port", src, _states("keyframe"))
    d = os.path.join(src.directory, "ckpt_00000001")
    marker = layout.verify_commit(d, deep=False)
    store = faults.FlakyStore(str(tmp_path / "bucket"))
    files = layout.commit_files(d, marker, None, digests=True)
    store.fail_once.add(upload.cas_key(upload.entry_digest(files[1])))
    mgr = UploadManager(store, max_retries=2, retry_backoff=0.0)
    try:
        st = mgr.enqueue(1, d, marker).wait()
    finally:
        mgr.close()
    assert st.committed and st.retries >= 1
    assert all(v == 1 for v in store.put_ok.values())
    r = engine("ref", str(tmp_path / "r"), str(tmp_path / "bucket"),
               backend="fastpersist")
    got, _ = r.load(tier="remote")
    faults.assert_equal_state(got, faults.np_state())


def test_partial_upload_retry_is_idempotent(tmp_path):
    """A failed attempt leaves an unobservable half generation; the retry
    skips what landed, duplicates nothing, and the bucket holds exactly
    the generation's keys."""
    src = engine("port", str(tmp_path / "p"), kind="striped")
    save_all("port", src, _states("keyframe"))
    d = os.path.join(src.directory, "ckpt_00000001")
    marker = layout.verify_commit(d, deep=False)
    store = faults.FlakyStore(str(tmp_path / "bucket"))
    files = layout.commit_files(d, marker, src.spec.volumes, digests=True)
    store.fail_once.add(upload.cas_key(upload.entry_digest(files[2])))
    mgr = UploadManager(store, volume_roots=src.volume_roots(),
                        max_retries=0)
    try:
        assert mgr.enqueue(1, d, marker).exception() is not None
        with pytest.raises(IOError):
            mgr.drain()
        assert remote_steps(store) == [] and mgr.unuploaded_steps() == [1]
        landed = len(store.put_ok)
        st = mgr.enqueue(1, d, marker).wait()
        assert st.committed and st.n_skipped >= landed
        assert mgr.unuploaded_steps() == []
    finally:
        mgr.close()
    assert all(v == 1 for v in store.put_ok.values())
    gen = upload.remote_generation(marker)
    expect = {upload.cas_key(upload.entry_digest(f)) for f in files}
    expect.add(f"{upload.remote_prefix(1, gen)}/{upload.REMOTE_COMMIT}")
    assert set(store.list()) == expect


# ======================================================= prune, hydrate
def test_prune_leaves_no_orphans_and_survivors_cross_hydrate(tmp_path):
    """prune_store keeps the newest step (and the keyframe its delta
    needs), deletes the rest COMMIT-first and sweeps every unreferenced
    cas/ object; the reference hydrates the survivor."""
    states = _states("chain") + [faults.mutate(faults.np_state(), 9)]
    bucket = str(tmp_path / "bucket")
    eng = engine("port", str(tmp_path / "p"), bucket, "chain")
    save_all("port", eng, states)             # steps 1 K, 2 D, 3 D, 4 K
    eng.wait_uploaded()
    eng.close()
    store = LocalObjectStore(bucket)
    victims = upload.prune_store(store, keep_last=1)
    assert sorted(victims) == [1, 2, 3] and remote_steps(store) == [4]
    refs = upload.referenced_digests(store)
    assert refs == rupload.referenced_digests(rupload.LocalObjectStore(
        bucket))
    for key in store.list():
        if key.startswith(upload.CAS_PREFIX + "/"):
            assert key[len(upload.CAS_PREFIX) + 1:] in refs, key
        else:
            assert upload.parse_remote_prefix(key.split("/", 1)[0])[0] == 4
    r = engine("ref", str(tmp_path / "r"), bucket, backend="fastpersist")
    got, _ = r.load(tier="remote")
    faults.assert_equal_state(got, states[-1])


@pytest.mark.parametrize("keep_last", [1, 2])
def test_prune_keeps_the_chain_a_kept_delta_needs(tmp_path, keep_last):
    """Each delta names the previous save as its base, so keeping the
    newest delta keeps its whole chain: both packages prune the same
    steps (none here) from copies of one bucket, and what stays loads."""
    bucket = str(tmp_path / "bucket")
    eng = engine("ref", str(tmp_path / "w"), bucket, "chain")
    save_all("ref", eng, _states("chain"))
    eng.wait_uploaded()
    eng.close()
    shutil.copytree(bucket, str(tmp_path / "bucket_ref"))
    store = LocalObjectStore(bucket)
    ref_store = rupload.LocalObjectStore(str(tmp_path / "bucket_ref"))
    assert upload.prune_store(store, keep_last=keep_last) == \
        rupload.prune_store(ref_store, keep_last=keep_last) == []
    assert remote_steps(store) == rupload.remote_steps(ref_store) == \
        [1, 2, 3]
    assert sorted(store.list()) == sorted(ref_store.list())
    got, _ = engine("port", str(tmp_path / "r"), bucket, "chain",
                    backend="fastpersist").load(tier="remote")
    faults.assert_equal_state(got, _states("chain")[-1])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_hydrate_reuses_intact_local_shards(tmp_path, writer):
    """Hydration fetches only what is missing or corrupt: with the local
    checkpoint intact nothing crosses the wire; with one shard corrupted
    only that shard does — so a phase that means to move bytes deletes
    the local shards first."""
    bucket = str(tmp_path / "bucket")
    w = engine(writer, str(tmp_path / "w"), bucket, "striped")
    save_all(writer, w, _states("keyframe"))
    w.wait_uploaded()
    w.close()
    eng = engine("port", str(tmp_path / "w"), bucket, "striped",
                 backend="fastpersist")
    eng.hydrate_remote(1)
    st = eng.last_hydrate_stats
    assert st.fetched_bytes == 0 and st.n_fetched == 0 and st.n_reused > 0
    d = os.path.join(eng.directory, "ckpt_00000001")
    marker = layout.verify_commit(d, deep=False)
    shards = [f for f in layout.commit_files(d, marker, eng.spec.volumes)
              if "crc32" in f]
    with open(shards[0]["path"], "r+b") as f:
        f.seek(shards[0]["size"] // 2)
        f.write(b"\xde\xad\xbe\xef")
    got, _ = eng.load(tier="remote")
    st = eng.last_hydrate_stats
    assert st.n_fetched == 1 and st.fetched_bytes == shards[0]["size"]
    faults.assert_equal_state(got, faults.np_state())


@pytest.mark.parametrize("tamper", ["corrupt", "truncate"])
def test_hydrate_refuses_a_damaged_remote_shard(tmp_path, tamper):
    """A bit-rotted or torn remote shard fails hydration in both
    packages, and leaves no committed local checkpoint behind."""
    bucket = str(tmp_path / "bucket")
    w = engine("port", str(tmp_path / "w"), bucket)
    save_all("port", w, _states("keyframe"))
    w.wait_uploaded()
    w.close()
    store = LocalObjectStore(bucket)
    s, g = upload.remote_generations(store)[-1]
    commit = upload.read_remote_commit(store, s, g)
    name = next(n for n in commit["object_digest"] if "shard_" in n)
    key = upload.object_key(commit, upload.remote_prefix(s, g), name)
    if tamper == "corrupt":
        faults.corrupt_object(store, key, store.size(key) // 2)
    else:
        faults.truncate_object(store, key, store.size(key) // 2)
    for n, hyd in (("p", hydrate), ("r", rupload.hydrate)):
        root = str(tmp_path / n)
        with pytest.raises(IOError):
            hyd(bucket, root)
        assert layout.committed_steps(root, legacy_ok=False) == []


def test_parallel_hydration_stats_match_reference(tmp_path):
    """Four ranged readers against one: the same bytes land, and both
    packages account the same fetched bytes for the same generation."""
    bucket = str(tmp_path / "bucket")
    w = engine("ref", str(tmp_path / "w"), bucket, "striped")
    save_all("ref", w, _states("keyframe"))
    w.wait_uploaded()
    w.close()
    fetched = {}
    for n, hyd, stats in (("p", hydrate, HydrateStats()),
                          ("r", rupload.hydrate, rupload.HydrateStats())):
        for readers in (1, 4):
            root = str(tmp_path / f"{n}{readers}")
            assert hyd(bucket, root, readers=readers, stats=stats) == 1
            got, _ = CheckpointEngine(CheckpointSpec(root)).load()
            faults.assert_equal_state(got, faults.np_state())
        fetched[n] = (stats.fetched_bytes, stats.n_fetched)
    assert fetched["p"] == fetched["r"]


def test_tiered_pipelined_backend_lands_on_device(tmp_path):
    """fastpersist-tiered-pipelined: the handle's two durability points,
    then a remote restore placed with ``device``."""
    bucket = str(tmp_path / "bucket")
    eng = engine("port", str(tmp_path / "p"), bucket,
                 backend="fastpersist-tiered-pipelined")
    h = eng.save(train_state_from_numpy(faults.np_state(), device="cpu"), 1)
    st = h.wait_uploaded()
    assert h.uploaded() and st.committed and eng.stats.uploads_enqueued == 1
    eng.close()
    wipe_local(eng)
    r = engine("port", str(tmp_path / "r"), bucket, backend="fastpersist")
    got, _ = r.load(tier="remote", device="meta")
    assert all(t.device.type == "meta" for t in got.values())
    got, _ = r.load(tier="remote", device="cpu", parallel=4)
    faults.assert_equal_state(got, faults.np_state())
    with pytest.raises(ValueError, match="object store"):
        engine("port", str(tmp_path / "x")).load(tier="remote")


def test_remote_commit_carries_the_reference_fields(tmp_path):
    """The remote COMMIT object is the local marker plus the same upload
    fields as the reference's (objects, sizes, CRCs, digests,
    remote_generation)."""
    keys = {}
    for pkg in ("port", "ref"):
        eng = engine(pkg, str(tmp_path / pkg), str(tmp_path / f"b{pkg}"))
        save_all(pkg, eng, _states("keyframe"))
        eng.wait_uploaded()
        eng.close()
        (c,) = _remote_commits(LocalObjectStore(str(tmp_path / f"b{pkg}"))
                               ).values()
        keys[pkg] = set(c)
        assert json.loads(json.dumps(c)) == c
    assert keys["port"] == keys["ref"]
