"""BENCHMARK.json against the benchmark's files: every configuration,
cell and metric it names is found by name, and each per-layer metric
moves an end-to-end metric that all of its cells report."""
import json
import math
import os
import re

import pytest

from bench import common, inputs

ROOT = common.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cells_of(metric, s):
    return metric.get("workloads", [w["name"] for w in s["workloads"]])


def test_top_level_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["bench"]
    assert s["command"][1] == "bench/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(
        1, len(s["workloads"]) // 4)


def test_bounds_and_run_length():
    s = spec()
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_each_entry_has_its_file(kind):
    s = spec()
    for entry in s[kind]:
        data = common.load(kind, entry["name"])
        assert data["name"] == entry["name"]
        if kind == "configs":
            assert entry["file"] == f"bench/configs/{entry['name']}.json"
            assert sorted(entry["reduced"]) == sorted(data["reduced"])
            assert set(data["reduced"]) <= set(data["changed"])
        else:
            assert data["config"] == entry["config"]
            assert data["traffic"] == entry["traffic"]
            assert data["why"] == entry["why"]
            generator, params = common.cell_params(data)
            assert os.path.exists(os.path.join(
                common.BENCH, "generators", generator + ".py"))
            assert set(params["limits"]) == {
                "loss_gap", "grad_gap", "delta_gap", "saved_mismatch"}


def test_reduced_names_no_width():
    widths = re.compile(r"(_dim|_rank)$|d_model|d_ff|hidden|intermediate|"
                        r"head_dim|expand|top_k|latent|state|proj")
    for c in spec()["configs"]:
        cfg = common.load("configs", c["name"])
        for k in c["reduced"]:
            assert not widths.search(k), k
        # every published size the file holds, and does not list as
        # reduced, is the published one (the widths among them)
        kept = [k for k in cfg["published"]
                if k in cfg and k not in c["reduced"]]
        assert kept
        for k in kept:
            assert cfg[k] == cfg["published"][k], k


def test_every_per_layer_metric_has_a_reader_and_moves_one_metric():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for m in s["per_layer"]:
        path = os.path.join(common.BENCH, "metrics", m["name"] + ".py")
        assert os.path.exists(path), path
        assert m["moves"] in e2e
        assert set(cells_of(m, s)) <= set(cells_of(e2e[m["moves"]], s))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    s = spec()
    for w in s["workloads"]:
        e = [m["name"] for m in s["end_to_end"]
             if w["name"] in cells_of(m, s)]
        assert "setup_s" in e and len(e) >= 2
        assert any(w["name"] in cells_of(m, s) for m in s["per_layer"])


def test_each_cell_writes_within_the_budget():
    from bench import extent, run
    for w in spec()["workloads"]:
        wl = common.load("workloads", w["name"])
        cfg = common.load("configs", wl["config"])
        assert run.planned_writes(cfg, wl) <= common.WRITE_BUDGET
        params = common.cell_params(wl)[1]
        saves = params.get("saves", 0) + 1
        one = extent.save_bytes(inputs.state_bytes(cfg), cfg, params)
        assert saves * one < 2.5 * 2 ** 30


@pytest.mark.parametrize("name,d,heads,ff,V,gb", [
    ("gpt3_2_7b_tp4", 2560, 8 * 80, 10240, 12576, 1.2766),
    ("gpt3_1_3b_tp2", 2048, 8 * 128, 8192, 25152, 1.3084)])
def test_state_bytes_by_hand(name, d, heads, ff, V, gb):
    cfg = common.load("configs", name)
    n = V * d + 4 * d * heads + 2 * d * ff + 3 * d
    assert inputs.param_count(cfg) == n
    assert inputs.state_bytes(cfg) == 14 * n + 4
    assert math.isclose(inputs.state_bytes(cfg) / 1e9, gb, rel_tol=1e-3)
