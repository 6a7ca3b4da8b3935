"""The harness on the CPU at a tiny size: the training traffic end to end
with its reference comparison under each backend, the refusal to measure
without a card or past the write budget, the blocking cell's stall and
commit latency read per layer, a cell found by its file alone, and the
trace reduction."""
import argparse
import json
import os
import time

import pytest

from bench import common, run, trace
from bench.tests.conftest import TINY, TRAIN
from bench.generators import train_ckpt


@pytest.mark.parametrize("backend", ["fastpersist-pipelined", "fastpersist"])
def test_traffic_end_to_end_on_cpu(make_ctx, backend):
    out = train_ckpt.run(make_ctx(dict(TRAIN, backend=backend)))
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(c["ok"] for c in out["checks"]), out["checks"]
    assert all(v and v > 0 for v in out["end_to_end"].values())
    assert out["bytes_written"] > 0


@pytest.mark.parametrize("n_saves", [1, 2])
def test_train_window_saves_on_its_schedule(make_ctx, n_saves):
    ctx = make_ctx(dict(TRAIN, saves=n_saves), seconds=0.6)
    out = train_ckpt.run(ctx)
    saves = [a for n, a, _ in ctx.spans if n == "save"]
    assert len(saves) == 1 + n_saves
    assert len(out["records"]["saves"]) == n_saves
    assert out["records"]["window_steps"] > 0
    assert out["end_to_end"]["commit_s"] > 0


def test_refuses_to_measure_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "gpt3_2_7b_tp4.train_overlap", "--seed",
                   "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_a_cell_planned_past_the_budget_is_refused(monkeypatch, capsys):
    monkeypatch.setattr(common, "WRITE_BUDGET", 1 << 30)
    rc = run.main(["--workload", "gpt3_2_7b_tp4.train_overlap", "--seed",
                   "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "refused:" in out.err and "would write" in out.err


def test_a_run_that_wrote_past_the_budget_is_refused(make_ctx, monkeypatch,
                                                     capsys):
    """A family whose count understates its state plans within the budget
    and writes past it: the run's own bytes refuse it."""
    out = train_ckpt.run(make_ctx(dict(TRAIN)))
    wl = common.load("workloads", "gpt3_1_3b_tp2.train_overlap")
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    args = argparse.Namespace(workload=wl["name"], trace=0)
    monkeypatch.setattr(common, "WRITE_BUDGET", out["bytes_written"] - 1)
    capsys.readouterr()
    rc = run.report(args, spec, wl, TINY, out, time.perf_counter())
    printed = capsys.readouterr()
    assert rc != 0 and printed.out == ""
    assert f"refused: {wl['name']} wrote {out['bytes_written']} bytes" in \
        printed.err


def test_blocking_stall_and_commit_latency_are_read_per_layer(make_ctx):
    """The blocking cell reports tokens/s and set-up end to end; its stall
    and commit latency are per-layer readings of the generator's own."""
    out = train_ckpt.run(make_ctx(dict(TRAIN, backend="fastpersist")))
    e2e, rec = out["end_to_end"], out["records"]
    stall = common.module("metrics", "save_stall_s").read
    latency = common.module("metrics", "commit_latency_s").read
    assert stall(rec) == e2e["ckpt_stall_s"] > 0
    assert latency(rec) == pytest.approx(e2e["commit_s"]) and e2e["commit_s"]
    assert latency(dict(rec, commit_s=[1.0, None])) is None
    assert latency({}) is None
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = "gpt3_2_7b_tp4.train_blocking"
    assert {m["name"] for m in run.metrics_for(spec, "end_to_end", cell)} \
        == {"train_tokens_per_s", "setup_s"}
    assert {"save_stall_s", "commit_latency_s"} <= {
        m["name"] for m in run.metrics_for(spec, "per_layer", cell)}


def test_a_new_cell_file_is_found_without_an_edit(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    name = f"_throwaway_{os.getpid()}.cell"
    path = os.path.join(common.BENCH, "workloads", name + ".json")
    wl = common.load("workloads", "gpt3_1_3b_tp2.train_overlap")
    with open(path, "w") as f:
        json.dump(dict(wl, name=name), f)
    try:
        assert common.load("workloads", name)["name"] == name
        rc = run.main(["--workload", name, "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
        assert rc == 2 and "CUDA" in capsys.readouterr().err
    finally:
        os.remove(path)
    with pytest.raises(FileNotFoundError):
        common.load("workloads", name)


def test_trace_reduction_busy_gaps_and_copies():
    us = 1000        # device events in ns; the marker at host 1.0 s
    base = 5_000_000_000
    dev = [(base, base + 1 * us, "spin_kernel"),
           (base + 10 * us, base + 20 * us, "k1"),
           (base + 15 * us, base + 30 * us, "k2"),
           (base + 50 * us, base + 60 * us, "Memcpy HtoD (x)"),
           (base + 95 * us, base + 120 * us, "k1")]
    t = 1.0
    spans = [("train_step", t, t + 40e-6), ("save", t + 30e-6, t + 55e-6),
             ("data", t + 40e-6, t + 45e-6)]
    r = trace.reduce(dev, spans, t, t + 100e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((20 + 10 + 5) * 1e-6)
    assert dict(r["device_ops"])["Memcpy HtoD (x)"] == pytest.approx(10e-6)
    gaps = dict(r["idle_gaps"])
    # 0-10 in train_step (the marker is not work); 30-50: save covers it
    # most; 60-95 in no span
    assert gaps["train_step"] == pytest.approx(10e-6)
    assert gaps["save"] == pytest.approx(20e-6)
    assert gaps["untraced"] == pytest.approx(35e-6)
    assert dict(r["device_ops"])["k1"] == pytest.approx(15e-6)
    assert "spin_kernel" not in dict(r["device_ops"])
    assert trace.reduce(dev[1:], spans, t, t + 1) == {}


def test_forbidden_modules_by_whole_name():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "benchmarksx": 1,
            "jaxtyping": 1}
    assert common.forbidden_loaded(mods) == []
    assert common.forbidden_loaded(dict(mods, **{"repro.core": 1})) == [
        "repro"]
    assert common.forbidden_loaded({"jax.numpy": 1, "flax": 1}) == [
        "flax", "jax"]
