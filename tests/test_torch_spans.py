"""The port's span recorder (``repro_torch.spans``): off, a site costs a
flag check and returns one shared object, reading no clock; on, spans
carry their thread and ``perf_counter`` times; a save through the engine
records every save-path span, and the stats fields it fills are those
spans' durations; the token stream's batches do not depend on it."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as pconfigs
from repro_torch import spans
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.partition import Topology
from repro_torch.core.retention import RetentionPolicy
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.train.trainer import CheckpointPolicy, Trainer, TrainerConfig

SAVE_PATH = ("save.prepare", "snapshot.alloc", "snapshot.fill", "write.copy",
             "write.crc", "write.wait", "save.manifest", "commit.fsync",
             "commit.publish", "commit.marker")


@pytest.fixture
def recording():
    spans.take()
    spans.record(True)
    try:
        yield
    finally:
        spans.record(False)
        spans.take()


def test_off_reads_no_clock_and_allocates_no_span(monkeypatch):
    spans.record(False)
    calls = []
    monkeypatch.setattr(spans.time, "perf_counter",
                        lambda: calls.append(1) or 0.0)
    a, b = spans.span("x", 8), spans.span("y")
    assert a is b
    with a as sp:
        sp.nbytes = 5
    assert calls == [] and spans.take() == []


def test_nested_spans_carry_thread_and_clock(recording):
    lo = time.perf_counter()
    with spans.span("outer"):
        with spans.span("inner", 7) as sp:
            sp.nbytes = 9
    t = threading.Thread(target=lambda: spans.span("other").__enter__()
                         .__exit__(None, None, None), name="helper-1")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    hi = time.perf_counter()
    got = {s[0]: s for s in spans.take()}
    assert set(got) == {"outer", "inner", "other"}
    main = threading.current_thread().name
    assert got["outer"][1] == got["inner"][1] == main
    assert got["other"][1] == "helper-1"
    (_, _, o0, o1, _), (_, _, i0, i1, n) = got["outer"], got["inner"]
    assert lo <= o0 <= i0 <= i1 <= o1 <= hi and n == 9
    assert spans.take() == []


def test_timed_measures_off_and_records_on(recording):
    with spans.timed("a") as sp:
        pass
    assert sp.seconds > 0 and [s[0] for s in spans.take()] == ["a"]
    spans.record(False)
    with spans.timed("b") as sp:
        time.sleep(0.001)
    assert sp.seconds >= 0.001 and spans.take() == []


def test_cap_counts_drops(recording, monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    for _ in range(5):
        with spans.span("x"):
            pass
    assert spans.dropped() == 2 and len(spans.take()) == 3
    assert spans.dropped() == 0


def _trainer(d, backend):
    cfg = dataclasses.replace(
        pconfigs.reduced(pconfigs.get_config("stablelm_1_6b")),
        n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256)
    pol = CheckpointPolicy(
        directory=d, every=1, backend=backend,
        fp=FastPersistConfig(topology=Topology(dp_degree=2)),
        retention=RetentionPolicy(keep_last=1))
    return Trainer(TrainerConfig(model=cfg, steps=3, global_batch=2,
                                 seq_len=16, checkpoint=pol, log_every=100),
                   device="cpu")


@pytest.mark.parametrize("backend", ["fastpersist", "fastpersist-pipelined"])
def test_engine_save_records_every_save_path_span(tmp_path, recording,
                                                  backend):
    tr = _trainer(str(tmp_path), backend)
    tr.run()
    rec = spans.take()
    names = {s[0] for s in rec}
    for n in SAVE_PATH + ("data.draw", "data.h2d", "train.step",
                          "train.adam", "engine.save", "engine.drain",
                          "retention.delete"):
        assert n in names, n
    assert ("engine.wait_snapshot" in names) == (backend != "fastpersist")
    main = threading.current_thread().name
    save_thread = main if backend == "fastpersist" else "ckpt-engine-worker"
    by_thread = {}
    for n, th, *_ in rec:
        by_thread.setdefault(n, set()).add(th)
    for n in ("data.draw", "train.step", "train.adam", "engine.save"):
        assert by_thread[n] == {main}, n
    for n in ("save.prepare", "save.manifest", "commit.fsync",
              "commit.marker"):
        assert by_thread[n] == {save_thread}, n
    assert by_thread["snapshot.fill"] == {"fp-snapshot"}
    assert any(th.startswith("fp-write") for th in by_thread["write.copy"])
    # train.adam nests inside train.step
    steps = [(a, b) for n, _, a, b, _ in rec if n == "train.step"]
    for n, _, a, b, _ in rec:
        if n == "train.adam":
            assert any(s0 <= a <= b <= s1 for s0, s1 in steps)
    # each save's stats fields are its spans' durations
    saves = [h.wait() for h in tr.saves]
    assert len(saves) == 3

    def per_save(name):
        return [(a, b) for n, _, a, b, _ in rec if n == name]
    fills, fsyncs = per_save("snapshot.fill"), per_save("commit.fsync")
    assert sorted(s.snapshot_seconds for s in saves) == sorted(
        b - a for a, b in fills)
    assert sorted(s.fsync_seconds for s in saves) == sorted(
        b - a for a, b in fsyncs)
    # a save's commit: fsync, publish (shard dirs), marker, publish
    commit = [(n, b - a) for n, _, a, b, _ in rec if n.startswith("commit.")]
    assert [n for n, _ in commit[:4]] == [
        "commit.fsync", "commit.publish", "commit.marker", "commit.publish"]
    assert [s.commit_seconds for s in saves] == pytest.approx(
        [sum(t for _, t in commit[i:i + 4]) for i in range(0, 12, 4)],
        abs=1e-9)
    # the writers' bytes are the payload's; the fill's are its D2H bytes
    copied = sum(nb for n, *_, nb in rec if n == "write.copy")
    assert copied == sum(s.total_bytes for s in saves)
    assert sum(nb for n, *_, nb in rec if n == "snapshot.fill") == sum(
        s.d2h_bytes for s in saves)
    assert sum(nb for n, *_, nb in rec if n == "snapshot.alloc") > 0


def test_token_stream_batches_equal_with_recording_on_and_off():
    cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=4, seed=11)
    spans.record(False)
    off = [next(TokenStream(cfg, position=i)) for i in range(3)]
    spans.take()
    spans.record(True)
    try:
        on = [next(TokenStream(cfg, position=i)) for i in range(3)]
        rec = spans.take()
    finally:
        spans.record(False)
    for a, b in zip(off, on):
        for k in ("tokens", "labels"):
            assert torch.equal(a[k], b[k])
    assert [s[0] for s in rec] == ["data.draw", "data.h2d"] * 3
    assert {s[4] for s in rec if s[0] == "data.h2d"} == {
        np.dtype(np.int32).itemsize * 4 * 33}
