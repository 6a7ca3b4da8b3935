"""The port's tables (``repro_torch.benchmarks.roofline`` and
``make_tables``) over the port's own dry-run JSON (two reduced pairs
counted on meta tensors on the 16 x 16 mesh) and the port's figure JSON
under ``experiments/torch/``. The roofline ranks by the compute and
collective terms only (the memory term is the dry run's unfused upper
bound), the tables print the H100 data sheet's rates, and with no JSON
at all they print nothing and raise nothing, as the reference's
checkpoint tables do."""
import json
import os
import sys
from dataclasses import fields
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # the reference's tables
    sys.path.insert(0, str(ROOT))

from benchmarks import make_tables as ref_tables  # noqa: E402
from repro_torch.benchmarks import (common, fig13_tiered_upload,  # noqa: E402
                                    fig_peer, fig_serve, make_tables,
                                    roofline, run)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

CPU = "cpu"
PAIRS = [("stablelm_1_6b", "train_4k"), ("stablelm_1_6b", "decode_32k")]


def _write_pair(out, arch, shape):
    """One pair's JSON as the dry run's CLI writes it, at reduced
    widths."""
    cfg = reduced(get_config(arch))
    extra = {f.name: getattr(cfg, f.name) for f in fields(cfg)
             if f.name != "name"}
    r = dryrun.lower_one(arch, shape, verbose=False, extra_cfg=extra)
    with open(os.path.join(out, f"{arch}__{shape}__pod.json"), "w") as f:
        json.dump(r, f, indent=2)
    return r


@pytest.fixture(scope="module")
def dry_rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("tables")
    out = d / "experiments" / "torch" / "dryrun"
    os.makedirs(out)
    return d, {(a, s): _write_pair(str(out), a, s) for a, s in PAIRS}


@pytest.fixture
def in_tables(dry_rows, monkeypatch):
    d, rows = dry_rows
    monkeypatch.chdir(d)
    monkeypatch.delenv("DRYRUN_DIR", raising=False)
    return rows


def test_cli_default_is_the_ports_own_directory(tmp_path, monkeypatch):
    """The dry run's CLI writes where the port's tables read, apart from
    the reference's ``experiments/dryrun`` (whose keys differ)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DRYRUN_DIR", raising=False)
    dryrun.main(["--arch", "stablelm_1_6b", "--shape", "decode_32k"])
    assert roofline.dryrun_dir() == os.path.join(common.EXPERIMENTS,
                                                 "dryrun")
    assert os.listdir(roofline.dryrun_dir()) == [
        "stablelm_1_6b__decode_32k__pod.json"]
    assert not os.path.exists(ref_tables.DRYRUN_DIR)


def test_roofline_rows_keep_the_dry_runs_dominant(in_tables, capsys):
    got = roofline.run(device=CPU)
    assert len(got) == 2
    for (arch, shape), r in in_tables.items():
        tc, tu, tl, dom, ratio = got[f"{arch}/{shape}/16x16"]
        assert (tc, tu, tl) == (r["t_compute_s"], r["t_memory_upper_s"],
                                r["t_collective_s"])
        assert dom == r["dominant"] == max(
            {"compute": tc, "collective": tl}.items(),
            key=lambda kv: kv[1])[0]
        assert ratio == r["useful_flops_ratio"]
    lines = capsys.readouterr().out.splitlines()
    by_name = {ln.split(",")[0]: ln for ln in lines}
    row = by_name["roofline/stablelm_1_6b/train_4k/16x16"]
    r = in_tables[("stablelm_1_6b", "train_4k")]
    # the row's time is the larger of compute and collective, never the
    # memory upper bound
    assert float(row.split(",")[1]) == pytest.approx(
        max(r["t_compute_s"], r["t_collective_s"]) * 1e6, abs=0.1)
    assert "roofline/hillclimb_most_collective" in by_name


def test_roofline_ranking_ignores_the_memory_upper_bound(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """Two rows: A has twice B's collective/compute ratio and a huge
    memory upper bound. Ranked without the memory term A is the most
    collective-bound; the reference's denominator (compute + memory)
    would pick B."""
    base = {"shape": "train_4k", "mesh": "16x16", "kind": "train",
            "useful_flops_ratio": 0.5, "dominant": "collective"}
    for name, tc, tu, tl in (("a", 1.0, 1e6, 2.0), ("b", 1.0, 0.0, 1.0)):
        (tmp_path / f"{name}.json").write_text(json.dumps(dict(
            base, arch=name, t_compute_s=tc, t_memory_upper_s=tu,
            t_collective_s=tl)))
    monkeypatch.setenv("DRYRUN_DIR", str(tmp_path))
    roofline.run(device=CPU)
    out = capsys.readouterr().out
    assert "roofline/hillclimb_most_collective,0.0,a/train_4k" in out


def test_make_tables_renders_the_h100_rates(in_tables, capsys):
    make_tables.main()
    out = capsys.readouterr().out
    assert "2 (arch × shape × mesh) pairs counted on meta tensors" in out
    assert ("989 TF/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink per card"
            in out)
    assert dryrun.CARD in out
    assert "197 TF/s" not in out and "819 GB/s" not in out
    for arch, shape in PAIRS:
        r = in_tables[(arch, shape)]
        assert f"| {arch} | {shape} | {make_tables.fmt(r['t_compute_s'])} |" \
            f" {make_tables.fmt(r['t_memory_upper_s'])} |" \
            f" {make_tables.fmt(r['t_collective_s'])} | {r['dominant']} |" \
            in out
        assert (f"| {arch} | {shape} | 16x16 | {r['kind']} | "
                f"{r['count_s']} |") in out
    assert make_tables._arch_type("stablelm_1_6b") == "dense"
    assert make_tables._arch_type("gpt3_1_8b_moe") == "moe"


def test_checkpoint_tables_read_the_ports_figures(tmp_path, monkeypatch,
                                                  capsys):
    """The tier figures' JSON (their smoke rows, persisted as the full
    runs persist them) rendered under the reference's headings."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FASTPERSIST_BENCH_DIR", str(tmp_path / "bench"))
    for name, mod in (("fig13", fig13_tiered_upload), ("fig_peer", fig_peer),
                      ("fig_serve", fig_serve)):
        common.save_json(name, mod.run(smoke=True, device=CPU))
    capsys.readouterr()
    make_tables.render()
    out = capsys.readouterr().out
    assert "### Dry-run matrix" not in out
    for heading in ("### Tiered durability: upload overlap (measured)",
                    "### Peer-replication durability tier (measured)",
                    "### Checkpoint serving read path (measured)"):
        assert heading in out
    assert "| roundtrip_ok | True |" in out
    assert "| failover_ok | True |" in out
    assert "| warm_fetched_bytes | 0 |" in out


def test_make_tables_without_json_prints_nothing(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DRYRUN_DIR", raising=False)
    make_tables.render()
    assert capsys.readouterr().out == ""
    ref_tables.ckpt_write_tables()
    ref_tables.ckpt_serve_table()
    assert capsys.readouterr().out == ""


def test_roofline_is_the_harness_last_entry():
    assert run.FIGURES[-1] == ("roofline", "roofline")
