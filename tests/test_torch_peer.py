"""The peer tier of the port (``repro_torch.core.peer``) against the
reference's, on the CPU: a peer directory either package filled restores
bit-exact through the other (a keyframe, a v3 delta chain, a §13 striped
chain), placement by failure domain picks the reference's peers, the
restore reads from the healthiest peer holding a complete chain and
falls back to the remote tier when none does, and a crash before the
peer COMMIT leaves nothing a restore could see. No tolerance: bytes."""
import os
import shutil
import warnings

import pytest

import test_torch_faults as faults
from repro.core import peer as rpeer
from repro.core import upload as rupload
from repro_torch.convert import train_state_from_numpy
from repro_torch.core import layout, peer, upload
from repro_torch.core.peer import PeerConfig, PeerReplicator, ReplicationError
from repro_torch.core.upload import LocalObjectStore, remote_steps
from test_torch_tiers import KINDS, _states, engine, save_all, wipe_local


def _peer_specs(tmp_path, n=2):
    """n peer specs in distinct failure domains (strings, so both
    packages build their own store over the same directories)."""
    return [f"n{i}={tmp_path}/peer{i}@rack{i}" for i in range(n)]


def _peered(pkg, root, peers, kind="keyframe", factor=2, store=None,
            **kw):
    return engine(pkg, root, store, kind, peers=peers,
                  replication_factor=factor, failure_domain="rack-writer",
                  **kw)


# ====================================================== cross-package
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_peer_replicas_cross_restore(tmp_path, kind, writer, reader):
    """One package replicates to two peers and loses its local
    directory; the other restores the newest complete chain from a peer,
    bit-exact."""
    states = _states(kind)
    peers = _peer_specs(tmp_path)
    w = _peered(writer, str(tmp_path / "w"), peers, kind)
    save_all(writer, w, states)
    stats = w.wait_replicated()
    assert all(s.committed and s.replicas == 2 for s in stats)
    w.close()
    wipe_local(w)
    for i in range(2):
        st = LocalObjectStore(str(tmp_path / f"peer{i}"))
        want = list(range(1, len(states) + 1))
        assert peer.fully_replicated_steps(st) == want
        assert rpeer.fully_replicated_steps(
            rupload.LocalObjectStore(str(tmp_path / f"peer{i}"))) == want
    r = _peered(reader, str(tmp_path / "r"), peers, kind)
    got, man = r.load(tier="peer")
    faults.assert_equal_state(got, states[-1])
    assert man.extras == {"step": len(states)}


def test_peer_objects_equal_the_reference_s(tmp_path):
    """The same state replicated by both packages: each peer holds the
    same payload keys (content-addressed) with the same bytes."""
    states = _states("chain")
    keys = {}
    for pkg in ("port", "ref"):
        peers = _peer_specs(tmp_path / pkg)
        w = _peered(pkg, str(tmp_path / pkg / "w"), peers, "chain")
        save_all(pkg, w, states)
        w.wait_replicated()
        w.close()
        st = LocalObjectStore(str(tmp_path / pkg / "peer0"))
        keys[pkg] = {k for k in st.list()
                     if k.startswith(upload.CAS_PREFIX + "/")}
        commits = [upload.read_remote_commit(st, s, g)
                   for s, g in upload.remote_generations(st)]
        keys[pkg] |= {upload.cas_key(d) for c in commits
                      for n, d in c["object_digest"].items()
                      if n != layout.MANIFEST_FILE}
    # the manifests differ by their nonces; every other object is shared
    manifests = {pkg: {k for k in keys[pkg]
                       if k not in keys["port"] or k not in keys["ref"]}
                 for pkg in keys}
    assert len(manifests["port"]) == len(manifests["ref"]) == 3
    assert keys["port"] - manifests["port"] == keys["ref"] - manifests["ref"]


# ============================================================ placement
SCENARIOS = {
    "avoid_writer_domain": dict(domains=["rackW", "rackA", "rackB"], k=2,
                                fd="rackW", eject=()),
    "only_writer_domain": dict(domains=["rackW"], k=1, fd="rackW",
                               eject=()),
    "spread_domains": dict(domains=["rackA", "rackA", "rackB", "rackC"],
                           k=3, fd="rackW", eject=()),
    "k_beyond_domains": dict(domains=["rackA", "rackA", "rackB", "rackC"],
                             k=4, fd=None, eject=()),
    "skip_ejected": dict(domains=["rackA", "rackB", "rackC"], k=2,
                         fd="rackW", eject=(1,)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_placement_matches_reference(tmp_path, name):
    sc = SCENARIOS[name]
    specs = [f"p{i}={tmp_path}/p{i}@{d}" for i, d in enumerate(sc["domains"])]
    reps = [cls(specs, replication_factor=sc["k"], failure_domain=sc["fd"],
                eject_after=1, probation_seconds=3600.0)
            for cls in (PeerReplicator, rpeer.PeerReplicator)]
    for rep in reps:
        for i in sc["eject"]:
            rep.peers[i].health.record_failure("dead")
    port, ref = ([p.name for p in rep.place()] for rep in reps)
    assert port == ref and port
    if name == "avoid_writer_domain":
        assert set(port) == {"p1", "p2"}
    if name == "spread_domains":
        assert len({sc["domains"][int(p[1:])] for p in port}) == 3
    if name == "skip_ejected":
        assert "p1" not in port
    for rep in reps:
        rep.close()


def test_restore_from_the_healthiest_peer(tmp_path):
    """Both peers hold the chain; the peer with failures on record ranks
    last in both packages, and the restore reads from the other."""
    peers = _peer_specs(tmp_path)
    w = _peered("port", str(tmp_path / "w"), peers)
    save_all("port", w, _states("keyframe"))
    w.wait_replicated()
    w.close()
    wipe_local(w)
    r = _peered("port", str(tmp_path / "r"), peers)
    ref = rpeer.PeerReplicator(peers, replication_factor=2)
    for rep in (r.peer_replicator, ref):
        rep.peers[0].health.record_failure("flaky")
    order = [n for n, _ in r.peer_replicator.ordered_restore_peers()]
    assert order == [n for n, _ in ref.ordered_restore_peers()] == \
        ["n1", "n0"]
    step, name = peer.hydrate_from_peers(
        r.peer_replicator.ordered_restore_peers(), r.directory)
    assert (step, name) == (1, "n1")
    got, _ = r.load(1)
    faults.assert_equal_state(got, faults.np_state())
    ref.close()
    r.close()


def test_newest_complete_step_wins_across_peers(tmp_path):
    peers = _peer_specs(tmp_path)
    w = _peered("ref", str(tmp_path / "w"), peers)
    s1, s2 = faults.np_state(1), faults.np_state(2)
    w.save(s1, 1).wait_replicated()
    w.save(s2, 2).wait_replicated()
    w.close()
    p0 = LocalObjectStore(str(tmp_path / "peer0"))
    for st, gen in upload.remote_generations(p0, 2):
        for key in p0.list(f"ckpt_{st:08d}.gen-{gen}"):
            p0.delete(key)
    pairs = [("n0", p0), ("n1", LocalObjectStore(str(tmp_path / "peer1")))]
    assert peer.hydrate_from_peers(pairs, str(tmp_path / "a")) == (2, "n1")
    assert rpeer.hydrate_from_peers(
        [(n, rupload.LocalObjectStore(s.root)) for n, s in pairs],
        str(tmp_path / "b")) == (2, "n1")
    got, _ = engine("port", str(tmp_path / "a")).load()
    faults.assert_equal_state(got, s2)


def test_no_complete_chain_falls_back_to_remote(tmp_path):
    """Every peer loses the keyframe under a delta: chain_complete says
    so in both packages, load(tier='peer') warns and restores from the
    remote tier, and without a remote tier it raises."""
    peers = _peer_specs(tmp_path)
    bucket = str(tmp_path / "bucket")
    w = _peered("port", str(tmp_path / "w"), peers, "chain", store=bucket)
    states = _states("chain")[:2]
    save_all("port", w, states)
    w.wait_replicated()
    w.wait_uploaded()
    w.close()
    for i in range(2):
        s = LocalObjectStore(str(tmp_path / f"peer{i}"))
        for st, gen in upload.remote_generations(s, 1):
            for key in s.list(f"ckpt_{st:08d}.gen-{gen}"):
                s.delete(key)
        (gen2,) = [g for _, g in upload.remote_generations(s, 2)]
        rs = rupload.LocalObjectStore(s.root)
        assert not peer.chain_complete(s, 2, gen2)
        assert not rpeer.chain_complete(rs, 2, gen2)
        assert peer.fully_replicated_steps(s) == \
            rpeer.fully_replicated_steps(rs) == []
    wipe_local(w)
    r = _peered("port", str(tmp_path / "r"), peers, "chain",
                store=bucket, backend="fastpersist")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got, _ = r.load(tier="peer")
    assert any("falling back to the remote tier" in str(w.message)
               for w in rec)
    faults.assert_equal_state(got, states[-1])
    r.close()
    no_remote = _peered("port", str(tmp_path / "x"), peers, "chain")
    with pytest.raises(FileNotFoundError):
        no_remote.load(tier="peer")
    no_remote.close()


# ================================================== faults on the tier
def test_peer_commit_written_last(tmp_path):
    stores = [faults.OrderAssertingStore(str(tmp_path / f"peer{i}"))
              for i in range(2)]
    cfgs = [PeerConfig(f"n{i}", s, f"rack{i}") for i, s in enumerate(stores)]
    w = _peered("port", str(tmp_path / "w"), cfgs, "striped")
    save_all("port", w, _states("striped"))
    w.wait_replicated()
    w.close()
    assert all(remote_steps(s) == [1, 2, 3] for s in stores)


def test_crash_before_peer_commit_is_unobservable(tmp_path):
    stores = [faults.FlakyStore(str(tmp_path / f"peer{i}"),
                                fail_commits=True) for i in range(2)]
    cfgs = [PeerConfig(f"n{i}", s, f"rack{i}") for i, s in enumerate(stores)]
    w = _peered("port", str(tmp_path / "w"), cfgs)
    h = w.save(train_state_from_numpy(faults.np_state(), device="cpu"), 4)
    with pytest.raises(ReplicationError):
        h.wait_replicated(timeout=60)
    assert not h.replicated()
    assert w.unreplicated_steps() == [4]          # stays pinned
    with pytest.raises(ReplicationError):
        w.wait_replicated()
    w.close()
    assert any(s.list() for s in stores)
    pairs = [(f"n{i}", rupload.LocalObjectStore(s.root))
             for i, s in enumerate(stores)]
    assert all(rpeer.fully_replicated_steps(s) == [] for _, s in pairs)
    with pytest.raises(FileNotFoundError):
        rpeer.hydrate_from_peers(pairs, str(tmp_path / "r"))


def test_one_dead_peer_under_replicates_and_stays_pinned(tmp_path):
    stores = [faults.FlakyStore(str(tmp_path / f"peer{i}"))
              for i in range(3)]
    stores[2].kill()
    cfgs = [PeerConfig(f"n{i}", s, f"rack{i}") for i, s in enumerate(stores)]
    w = _peered("port", str(tmp_path / "w"), cfgs, factor=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rs = w.save(train_state_from_numpy(faults.np_state(), device="cpu"),
                    1).wait_replicated()
    assert rs.committed and rs.under_replicated
    assert (rs.replicas, rs.target) == (2, 3)
    assert w.unreplicated_steps() == [1]
    stores[2].revive()
    d = os.path.join(w.directory, "ckpt_00000001")
    rs = w.peer_replicator.enqueue(1, d).wait()
    assert rs.replicas == 3 and not rs.under_replicated
    assert w.unreplicated_steps() == []
    assert all(v == 1 for s in stores for v in s.put_ok.values())
    w.close()


def test_peer_prune_matches_reference(tmp_path):
    """prune_peers keeps the newest step on every peer, like the
    reference's on a copy of the same peers."""
    peers = _peer_specs(tmp_path)
    w = _peered("port", str(tmp_path / "w"), peers)
    for step in (1, 2, 3):
        w.save(train_state_from_numpy(faults.np_state(step), device="cpu"),
               step).wait_replicated()
    w.close()
    ref_peers = []
    for i in range(2):
        shutil.copytree(str(tmp_path / f"peer{i}"),
                        str(tmp_path / f"rpeer{i}"))
        ref_peers.append(f"n{i}={tmp_path}/rpeer{i}@rack{i}")
    port = PeerReplicator(peers, replication_factor=2)
    ref = rpeer.PeerReplicator(ref_peers, replication_factor=2)
    assert port.prune_peers(1) == ref.prune_peers(1)
    for i in range(2):
        a = LocalObjectStore(str(tmp_path / f"peer{i}"))
        b = LocalObjectStore(str(tmp_path / f"rpeer{i}"))
        assert remote_steps(a) == remote_steps(b) == [3]
        assert sorted(a.list()) == sorted(b.list())
    port.close()
    ref.close()


def test_spec_parsing_matches_reference(tmp_path):
    for spec in (f"{tmp_path}/n1@rack0", f"alpha={tmp_path}/n2@rack1",
                 f"{tmp_path}/plain", f"{tmp_path}/odd@name/deeper"):
        a, b = peer.make_peer(spec), rpeer.make_peer(spec)
        assert (a.name, a.store, a.failure_domain) == \
            (b.name, b.store, b.failure_domain)
    with pytest.raises(ValueError, match="duplicate"):
        PeerReplicator([f"{tmp_path}/a", f"{tmp_path}/a"])


def test_trainer_style_lost_node_walks_peer_then_remote(tmp_path):
    """The engine's restore ladder: with peers it hydrates from a peer;
    with the peers gone (dead stores) and a bucket, from the bucket."""
    bucket = str(tmp_path / "bucket")
    stores = [faults.FlakyStore(str(tmp_path / f"peer{i}"))
              for i in range(2)]
    cfgs = [PeerConfig(f"n{i}", s, f"rack{i}") for i, s in enumerate(stores)]
    w = _peered("port", str(tmp_path / "w"), cfgs, store=bucket)
    save_all("port", w, _states("keyframe"))
    w.wait_replicated()
    w.wait_uploaded()
    w.close()
    wipe_local(w)
    r = _peered("port", str(tmp_path / "w"), cfgs, store=bucket,
                backend="fastpersist")
    got, _ = r.load(tier="peer", device="cpu")
    faults.assert_equal_state(got, faults.np_state())
    assert r.last_hydrate_stats.fetched_bytes > 0
    wipe_local(r)
    for s in stores:
        s.kill()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, _ = r.load(tier="peer", device="cpu")
    faults.assert_equal_state(got, faults.np_state())
    r.close()
