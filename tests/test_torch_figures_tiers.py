"""The last slice of the port's paper figures beside the reference's, on
the CPU at their smoke sizes, both writing under ``tmp_path``: the MoE
figure and the projections (``fig10_moe``, ``table1_bandwidth``,
``fig12_projection``) and the durability tiers (``fig13_tiered_upload``,
``fig_peer``, ``fig_serve``).

Held EQUAL to the reference's: table1's and fig12's rows and return
values and fig10b's, exactly, at the paper's V100 peak; fig10a's element
counts (at the figure's own scale) and its checkpoint bytes (at a
smaller scale); fig_serve's dedup, tensor and warm-cache fields; fig13's
``upload_bytes`` up to the manifest (ROADMAP C.4: the port's ``treedef``
string is its own, so each uploaded manifest differs by the same number
of bytes, and the test holds the difference to exactly that). The timed
rows are checked for presence and sign. A bucket the port's fig13 loop
uploaded hydrates bit-exact through the reference's
``engine.load(tier="remote")``."""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # the reference's figures
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fig10_moe as ref_f10m  # noqa: E402
from benchmarks import fig12_projection as ref_f12  # noqa: E402
from benchmarks import fig13_tiered_upload as ref_f13  # noqa: E402
from benchmarks import fig_peer as ref_peer  # noqa: E402
from benchmarks import fig_serve as ref_serve  # noqa: E402
from benchmarks import table1_bandwidth as ref_t1  # noqa: E402
from repro.core.engine import CheckpointEngine as RefEngine  # noqa: E402
from repro.core.engine import CheckpointSpec as RefSpec  # noqa: E402
from repro_torch.benchmarks import (fig10_moe, fig12_projection,  # noqa: E402
                                    fig13_tiered_upload, fig_peer,
                                    fig_serve, table1_bandwidth)
from repro_torch.core.checkpointer import FastPersistConfig  # noqa: E402
from repro_torch.core.engine import CheckpointSpec  # noqa: E402
from repro_torch.core.partition import Topology  # noqa: E402
from repro_torch.tree import treedef_str  # noqa: E402

CPU = "cpu"


@pytest.fixture
def bench(tmp_path, monkeypatch):
    """Both packages' scratch under ``tmp_path`` and the working
    directory (where the figures write ``experiments/``) at
    ``tmp_path``."""
    monkeypatch.setenv("FASTPERSIST_BENCH_DIR", str(tmp_path / "bench"))
    monkeypatch.setattr(ref_common, "BENCH_DIR", str(tmp_path / "ref"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _rows(text, prefixes):
    """The CSV rows under ``prefixes``: [(name, us, derived)]."""
    out = []
    for line in text.splitlines():
        if line.startswith(prefixes):
            name, us, derived = line.split(",", 2)
            out.append((name, float(us), derived))
    return out


def _treedef_gap(*keys) -> int:
    """How many bytes longer the reference's structure string of a flat
    dict of ``keys`` is than the port's (ROADMAP C.4: the manifest's and
    the baseline file's ``treedef``)."""
    return (len(str(jax.tree_util.tree_structure({k: 0 for k in keys})))
            - len(treedef_str({k: torch.zeros(1) for k in keys})))


# ------------------------------------------------ the analytic figures
@pytest.mark.parametrize("ref,port,prefixes", [
    (ref_t1, table1_bandwidth, ("table1/", "eq2/")),
    (ref_f12, fig12_projection, ("fig12/",))], ids=["table1", "fig12"])
def test_analytic_rows_equal_reference(ref, port, prefixes, capsys):
    want = ref.run()
    want_rows = _rows(capsys.readouterr().out, prefixes)
    got = port.run(device=CPU)
    got_rows = _rows(capsys.readouterr().out, prefixes)
    assert got == want
    assert got_rows == want_rows and len(got_rows) >= 11


class _Stats:
    seconds = 1.0


class _NoSave:
    """A checkpointer that records nothing and writes nothing."""

    def __init__(self, *a, **k):
        pass

    def save(self, state, step):
        return _Stats()


def test_fig10_counts_and_projection_equal_reference(monkeypatch, capsys):
    """fig10a's element count at each DP, at the figure's own scale (the
    saves stubbed out on both sides), and fig10b's rows and return
    values, exactly."""
    ref_nbytes, port_n = [], []

    def ref_state(nbytes):
        ref_nbytes.append(nbytes)
        return {"p": jnp.zeros((1,), jnp.bfloat16)}

    def port_state(mb, device, seed=0, n=None):
        port_n.append(n)
        return {"p": torch.zeros(1, dtype=torch.bfloat16)}

    for mod, state in ((ref_f10m, ref_state), (fig10_moe, port_state)):
        monkeypatch.setattr(mod, "synth_state", state)
        monkeypatch.setattr(mod, "BaselineCheckpointer", _NoSave)
        monkeypatch.setattr(mod, "FastPersistCheckpointer", _NoSave)
    want = ref_f10m.run()
    want_rows = _rows(capsys.readouterr().out, ("fig10b/",))
    got = fig10_moe.run(device=CPU)
    got_rows = _rows(capsys.readouterr().out, ("fig10b/",))
    assert got == want and got_rows == want_rows
    assert port_n == [max(b // 14, 1) for b in ref_nbytes]
    assert port_n == [fig10_moe.state_elems(dp) for dp in (1, 4, 8)]
    assert 1.0e9 < 14 * port_n[-1] <= 67e9 / 64


def test_fig10_checkpoint_bytes_equal_reference(bench, monkeypatch):
    """fig10a at 1/4096 of its scale: both packages' baseline and
    FastPersist saves write the same bytes (the states' values differ:
    each package draws its own)."""
    seen = {"ref": [], "port": []}

    def wrap(mod, side):
        for name in ("BaselineCheckpointer", "FastPersistCheckpointer"):
            cls = getattr(mod, name)

            class Rec(cls):
                def save(self, state, step, *a, **k):
                    st = super().save(state, step, *a, **k)
                    seen[side].append(getattr(st, "bytes_written", None)
                                      or st.total_bytes)
                    return st
            monkeypatch.setattr(mod, name, Rec)

    wrap(ref_f10m, "ref")
    wrap(fig10_moe, "port")
    monkeypatch.setattr(ref_f10m, "SCALE", 64 * 4096)
    monkeypatch.setattr(fig10_moe, "SCALE", 64 * 4096)
    ref_f10m.run()
    fig10_moe.run(device=CPU)
    assert len(seen["port"]) == 6
    # FastPersist's payload bytes are equal; the baseline's file carries
    # the tree's structure string, which is the port's own (C.4)
    c4 = _treedef_gap("p", "mw", "m", "v")
    assert seen["port"][1::2] == seen["ref"][1::2]
    assert [r - p for r, p in zip(seen["ref"][0::2], seen["port"][0::2])] \
        == [c4] * 3
    assert not os.listdir(bench / "bench")          # each pair removed


# ------------------------------------------------ the durability tiers
def test_fig13_equals_reference_up_to_the_manifest(bench):
    want = ref_f13.run(smoke=True)
    got = fig13_tiered_upload.run(smoke=True, device=CPU)
    assert set(got) == set(want)
    assert (got["mb"], got["steps"]) == (want["mb"], want["steps"]) == (8, 4)
    assert got["roundtrip_ok"] and want["roundtrip_ok"]
    # one manifest a save crosses the wire, and C.4 makes it differ by
    # the length of the structure strings
    assert want["upload_bytes"] - got["upload_bytes"] == \
        got["steps"] * _treedef_gap("blob", "head")
    assert got["upload_bytes"] > 8 * 2**20
    for k in ("iter_tiered_ms", "upload_busy_s", "hydrate_s"):
        assert got[k] > 0, k
    assert 0 <= got["overlap_pct"] <= 100


def test_fig13_bucket_hydrates_through_the_reference(bench):
    """The port's fig13 loop (tiered saves of a state on the device)
    fills a bucket; the reference's engine restores it from the bucket
    alone, bit-exact."""
    d = bench / "f13x"
    state = fig13_tiered_upload.make_state(2, CPU)
    spec = CheckpointSpec(
        directory=str(d / "prim"), backend="fastpersist-tiered",
        volumes=[str(d / "vol0"), str(d / "vol1")],
        upload_store=str(d / "bucket"),
        fp=FastPersistConfig(strategy="replica",
                             topology=Topology(dp_degree=4)))
    iters, _, _, _, uploaded = fig13_tiered_upload._loop(spec, state, 2,
                                                         0.0)
    assert len(iters) == 2 and uploaded > 2 * 2**20
    with RefEngine(RefSpec(directory=str(d / "ref"), backend="fastpersist",
                           upload_store=str(d / "bucket"))) as eng:
        restored, _ = eng.load(tier="remote")
    assert set(restored) == {"blob", "head"}
    assert np.array_equal(np.asarray(restored["blob"]),
                          state["blob"].numpy())
    assert np.array_equal(np.asarray(restored["head"]),
                          state["head"].numpy())


def test_fig_peer_matches_reference(bench):
    want = ref_peer.run(smoke=True)
    got = fig_peer.run(smoke=True, device=CPU)
    assert set(got) == set(want)
    for k in ("mb", "steps", "wan_latency_ms"):
        assert got[k] == want[k], k
    assert got["failover_ok"] and want["failover_ok"]
    for k in ("t_replicated_ms", "t_uploaded_ms", "tier_gap_x",
              "failover_restore_s"):
        assert got[k] > 0, k
    assert got["verdict"] in ("supported", "refuted")


def test_fig_serve_matches_reference(bench):
    want = ref_serve.run(smoke=True)
    got = fig_serve.run(smoke=True, device=CPU)
    assert set(got) == set(want)
    for k in ("mb", "dedup_uploaded_objects", "dedup_bytes_saved",
              "dedup_metadata_only", "tensor_bytes", "warm_fetched_bytes",
              "tensor_fetch_frac"):
        assert got[k] == want[k], k
    assert got["warm_fetched_bytes"] == 0 and got["dedup_metadata_only"]
    # the wire bytes of a fetch include one manifest (C.4)
    assert want["tensor_fetched_bytes"] - got["tensor_fetched_bytes"] == \
        _treedef_gap("blob", "head")
    for k in ("hydrate_r1_s", "hydrate_r2_s", "hydrate_r4_s",
              "hydrate_warm_s", "speedup_2x", "speedup_4x",
              "tensor_read_s"):
        assert got[k] > 0, k


@pytest.mark.parametrize("ref,port,name", [
    (ref_f13, fig13_tiered_upload, "fig13"),
    (ref_peer, fig_peer, "fig_peer"),
    (ref_serve, fig_serve, "fig_serve")],
    ids=["fig13", "fig_peer", "fig_serve"])
def test_persisted_keys_equal_reference(ref, port, name, bench):
    """At 1 MiB and the figures' full legs: the JSON the port persists
    under experiments/torch/ has the reference's keys."""
    ref.run(mb=1)
    port.run(mb=1, device=CPU)
    want = json.loads((bench / "experiments" / f"{name}.json").read_text())
    got = json.loads((bench / "experiments" / "torch" / f"{name}.json")
                     .read_text())
    assert set(got) == set(want)
    assert got.get("roundtrip_ok", True) and got.get("failover_ok", True)
