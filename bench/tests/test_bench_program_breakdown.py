"""The program's spans in the benchmark: the reader of ``commit_fsync_s``
on a synthetic record, on a record of a program that lacks the field,
and on a CPU run of the training traffic; the idle gaps of a trace split
by the program's spans; and ``bench/program_breakdown.py``'s readings,
synthetic and from a CPU run with the recorder on."""
import time

import pytest

from bench import common, program_breakdown, trace
from bench.generators import train_ckpt
from bench.tests.conftest import TRAIN

US = 1000            # device events in ns; the marker at host 1.0 s
BASE = 5_000_000_000
T = 1.0


def _reader(name):
    return common.module("metrics", name)


def _dev():
    return [(BASE, BASE + 1 * US, "spin_kernel"),
            (BASE + 10 * US, BASE + 20 * US, "k1"),
            (BASE + 15 * US, BASE + 30 * US, "k2"),
            (BASE + 50 * US, BASE + 60 * US, "Memcpy HtoD (x)"),
            (BASE + 95 * US, BASE + 120 * US, "k1")]


HARNESS = [("train_step", T, T + 40e-6), ("save", T + 30e-6, T + 55e-6),
           ("data", T + 40e-6, T + 45e-6)]


def test_gaps_are_the_trace_reductions():
    r = trace.reduce(_dev(), HARNESS, T, T + 100e-6)
    gaps = program_breakdown.idle_gaps(_dev(), T, T + 100e-6)
    assert sum(b - a for a, b in gaps) == pytest.approx(
        r["window_s"] - r["busy_s"])
    assert sum(t for _, t in r["idle_gaps"]) == pytest.approx(
        sum(b - a for a, b in gaps))
    assert program_breakdown.idle_gaps(_dev()[1:], T, T + 1) == []
    assert program_breakdown.idle_program(_dev()[1:], HARNESS, [], T,
                                      T + 1) == {}


def test_gap_goes_to_innermost_main_span_and_open_save_span():
    # idle: 0-10, 30-50, 60-95 us (the marker is not work)
    prog = [("train.step", "MainThread", T, T + 8e-6, 0),
            ("train.adam", "MainThread", T + 2e-6, T + 6e-6, 0),
            ("write.copy", "fp-write_0", T + 4e-6, T + 40e-6, 1 << 20),
            ("write.wait", "fp-write_1", T + 5e-6, T + 7e-6, 0),
            ("commit.fsync", "MainThread", T + 60e-6, T + 70e-6, 0),
            ("data.draw", "MainThread", T + 80e-6, T + 90e-6, 0),
            ("snapshot.fill", "fp-snapshot", T + 85e-6, T + 99e-6, 0),
            ("engine.save", "ckpt-engine-worker", T, T + 1, 0)]
    r = program_breakdown.idle_program(_dev(), HARNESS, prog, T, T + 100e-6)
    main = dict(r["idle_gaps_program"])
    assert main["train.step"] == pytest.approx(4e-6)       # 0-2, 6-8
    assert main["train.adam"] == pytest.approx(4e-6)       # 2-6
    assert main["commit.fsync"] == pytest.approx(10e-6)    # 60-70
    assert main["data.draw"] == pytest.approx(10e-6)       # 80-90
    # no program span open: the harness's innermost, else untraced
    assert main["train_step"] == pytest.approx(2e-6)       # 8-10
    assert main["save"] == pytest.approx(15e-6)            # 30-40, 45-50
    assert main["data"] == pytest.approx(5e-6)             # 40-45
    assert main["untraced"] == pytest.approx(15e-6)        # 70-80, 90-95
    assert sum(main.values()) == pytest.approx(65e-6)
    under = dict(r["idle_under_save"])
    assert under["none"] == pytest.approx(9e-6)            # 0-4, 80-85
    assert under["write.copy"] == pytest.approx(2e-6)      # 4-5, 7-8
    assert under["write.copy+write.wait"] == pytest.approx(2e-6)
    assert under["snapshot.fill"] == pytest.approx(5e-6)   # 85-90
    assert r["persist_idle_s"] == pytest.approx(4e-6)


def _save(**kw):
    return dict({"total_bytes": 8, "seconds": 1.0, "commit_seconds": 0.5,
                 "snapshot_seconds": 0.1, "d2h_bytes": 8}, **kw)


def test_reader_reads_the_saves_and_none_without_them():
    read = _reader("commit_fsync_s").read
    fields = [dict(fsync_seconds=0.25), dict(fsync_seconds=0.75)]
    assert read({"saves": [_save(**f) for f in fields]}) == pytest.approx(
        0.5)
    # the program before these fields, and a run with no window save
    assert read({"saves": [_save(), _save()]}) is None
    assert read({"saves": [_save(**fields[0]), _save()]}) is None
    assert read({"saves": []}) is None and read({}) is None


def test_reader_reads_a_cpu_run_of_the_blocking_traffic(make_ctx):
    out = train_ckpt.run(make_ctx(dict(TRAIN, backend="fastpersist")))
    rec = out["records"]
    fsync = _reader("commit_fsync_s").read(rec)
    assert 0 < fsync <= _reader("commit_phase_s").read(rec)


def test_readings_of_synthetic_spans():
    w = 10.0                                  # the window starts here
    prog = [("snapshot.alloc", "ckpt-engine-worker", 9.0, 9.5, 64),
            ("data.draw", "MainThread", 9.6, 9.7, 0),
            ("data.draw", "MainThread", 10.0, 10.002, 0),
            ("data.h2d", "MainThread", 10.002, 10.003, 8),
            ("data.draw", "MainThread", 11.0, 11.004, 0),
            ("save.prepare", "MainThread", 12.0, 12.1, 0),
            ("save.manifest", "MainThread", 12.5, 12.7, 0),
            ("commit.fsync", "MainThread", 12.7, 13.5, 0),
            ("commit.publish", "MainThread", 13.5, 13.55, 0),
            ("commit.marker", "MainThread", 13.55, 13.6, 0),
            ("commit.publish", "MainThread", 13.6, 13.65, 0),
            ("retention.delete", "MainThread", 13.7, 14.0, 0)]
    out = {"setup_end": w, "checks": [{"ok": True}],
           "records": {"saves": [{"commit_seconds": 0.95}]}}
    r = program_breakdown.readings(prog, out, {})
    assert r["correct"] and r["window_saves"] == 1
    assert r["data_draw_ms"] == pytest.approx(3.0)     # the window's two
    assert r["data_h2d_ms"] == pytest.approx(0.5)
    assert r["arena_alloc_s"] == pytest.approx(0.5)    # the set-up's
    assert r["save_overhead_s"] == pytest.approx(0.6)  # with the delete
    c = r["commit"]
    assert c["commit.fsync"] == pytest.approx(0.8)
    assert c["commit.publish"] == pytest.approx(0.1)
    assert (c["commit.fsync"] + c["commit.publish"] + c["commit.marker"]
            == pytest.approx(c["commit_phase_s"]))
    assert "idle_gaps_program" not in r
    # with a traced stretch: the gaps' split and the persist share
    seen = {"dev": _dev(), "harness": HARNESS, "w0": T, "w1": T + 100e-6}
    shifted = [(n, th, a - w + T, b - w + T, nb) for n, th, a, b, nb in [
        ("train.step", "MainThread", w, w + 10e-6, 0),
        ("write.crc", "fp-write_0", w, w + 5e-6, 0)]]
    r = program_breakdown.readings(shifted, out, seen)
    assert dict(r["idle_gaps_program"])["train.step"] == pytest.approx(
        10e-6)
    assert r["persist_idle_s"] == pytest.approx(5e-6)
    assert r["device_idle_share.persist"] == pytest.approx(5.0)


def test_breakdown_of_a_cpu_run_of_the_blocking_traffic(make_ctx):
    from repro_torch import spans
    out, prog, dropped, seen = program_breakdown.collect(
        make_ctx(dict(TRAIN, backend="fastpersist")))
    assert dropped == 0 and seen == {} and all(
        c["ok"] for c in out["checks"])
    # the recorder is off again and holds nothing
    with spans.span("data.draw"):
        pass
    assert spans.take() == []
    names = {n for n, *_ in prog}
    assert {"data.draw", "data.h2d", "train.step", "snapshot.alloc",
            "save.prepare", "save.manifest", "commit.fsync",
            "retention.delete"} <= names
    r = program_breakdown.readings(prog, out, seen)
    assert r["window_saves"] == TRAIN["saves"]
    assert r["data_draw_ms"] > 0 and r["arena_alloc_s"] > 0
    deleted = sum(b - a for n, _, a, b, _ in prog if n == "retention.delete"
                  and a >= out["setup_end"])
    assert r["save_overhead_s"] * TRAIN["saves"] > deleted > 0
    c = r["commit"]
    assert (c["commit.fsync"] + c["commit.publish"] + c["commit.marker"]
            == pytest.approx(c["commit_phase_s"], abs=1e-9))


class _Stretch:
    """A stand-in for :class:`bench.trace.Stretch` on the CPU: its device
    trace is the marker alone, so the whole stretch is idle."""

    def __init__(self):
        self.t0 = self.t1 = None
        self._prof = None

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()

    def result(self, spans):
        raise AssertionError("the breakdown reads the stretch itself")


def test_breakdown_of_a_traced_cpu_run(make_ctx, monkeypatch):
    monkeypatch.setattr(trace, "Stretch", _Stretch)
    monkeypatch.setattr(trace, "device_events",
                        lambda prof: [(0, 1000, trace.MARKER)])
    out, prog, _, seen = program_breakdown.collect(
        make_ctx(dict(TRAIN, backend="fastpersist-pipelined"), trace=True))
    assert _Stretch.result is not trace.reduce and "result" in vars(_Stretch)
    assert out["records"]["trace"]["busy_s"] == 0
    r = program_breakdown.readings(prog, out, seen)
    assert r["busy_s"] == 0 and r["window_s"] == pytest.approx(
        seen["w1"] - seen["w0"])
    assert sum(t for _, t in r["idle_gaps"]) == pytest.approx(r["window_s"])
    assert {n for n, _ in r["idle_gaps_program"]} & {"train.step",
                                                     "train.adam"}
    assert 0 <= r["device_idle_share.persist"] <= 100
    # every idle second of the stretch gets one label
    every = program_breakdown.idle_program(
        seen["dev"], seen["harness"], prog, seen["w0"], seen["w1"],
        top=len(prog) + 10)
    assert sum(t for _, t in every["idle_gaps_program"]) == pytest.approx(
        seen["w1"] - seen["w0"])


def test_breakdown_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert program_breakdown.main([
        "--workload", "gpt3_2_7b_tp4.train_blocking", "--seed", "1",
        "--seconds", "1"]) == 2
    assert "refused" in capsys.readouterr().err
