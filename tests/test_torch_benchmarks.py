"""The port's paper figures (``repro_torch.benchmarks``) beside the
reference's (``benchmarks``), on the CPU at their smallest sizes, both
writing under ``tmp_path``. Deterministic fields are held EQUAL to the
reference's: fig_delta's bytes per cell, fig_snapshot's device→host and
dirty bytes, beyond_quant's save bytes, fig9's payload and its
estimator at the paper's V100 peak, fig8's write plans and fig10's
restored bytes. Timings, and the figures with nothing deterministic in
them (perf_writer, fig7, fig2), are checked for presence and sign.
Checkpoints written by fig9's save step and by one checkpointed fig11
step load bit-exact through the reference's engine."""
import os
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # the reference's figures
    sys.path.insert(0, str(ROOT))

from benchmarks import beyond_quant as ref_bq  # noqa: E402
from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fig10_parallel_restore as ref_f10  # noqa: E402
from benchmarks import fig11_pipelining as ref_f11  # noqa: E402
from benchmarks import fig9_dense_models as ref_f9  # noqa: E402
from benchmarks import fig_delta as ref_delta  # noqa: E402
from benchmarks import fig_snapshot as ref_snap  # noqa: E402
from repro.configs import PAPER_TABLE2 as REF_TABLE2  # noqa: E402
from repro.configs import get_paper_config as ref_paper  # noqa: E402
from repro.core import overlap as ref_overlap  # noqa: E402
from repro.core.engine import CheckpointEngine as RefEngine  # noqa: E402
from repro.core.engine import CheckpointSpec as RefSpec  # noqa: E402
from repro.core.partition import Topology as RefTopology  # noqa: E402
from repro.core.partition import make_plan as ref_make_plan  # noqa: E402
from repro_torch.benchmarks import (beyond_quant, common,  # noqa: E402
                                    fig2_baseline_util, fig7_buffer_sweep,
                                    fig8_parallel_writes,
                                    fig9_dense_models,
                                    fig10_parallel_restore,
                                    fig11_pipelining, fig_delta,
                                    fig_snapshot, perf_writer, run)

CPU = "cpu"


@pytest.fixture
def bench(tmp_path, monkeypatch):
    """Both packages' scratch under ``tmp_path/bench`` and the working
    directory (where the figures write ``experiments/``) at
    ``tmp_path``."""
    d = str(tmp_path / "bench")
    monkeypatch.setenv("FASTPERSIST_BENCH_DIR", d)
    monkeypatch.setattr(ref_common, "BENCH_DIR", d)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _rows(capsys, prefix):
    """The CSV rows the figure printed under ``prefix``: {name: (us,
    derived)}."""
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith(prefix):
            name, us, derived = line.split(",", 2)
            rows[name] = (float(us), derived)
    return rows


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        a = a.view(np.uint16)
    return a.tobytes()


# ------------------------------------------------------------ fig_delta
DELTA_KEYS = ("keyframe_every", "dirty_frac", "bytes_full", "bytes_delta",
              "bytes_x", "ok_full", "ok_delta")


@pytest.mark.parametrize("kw", [dict(smoke=True), dict(mb=1)],
                         ids=["smoke", "quick-1MB"])
def test_fig_delta_bytes_equal_the_reference(bench, kw):
    want = ref_delta.run(**kw)
    got = fig_delta.run(device=CPU, **kw)
    assert set(got) == set(want)
    assert len(got["cells"]) == len(want["cells"]) >= 1
    for g, w in zip(got["cells"], want["cells"]):
        assert set(g) == set(w)
        assert {k: g[k] for k in DELTA_KEYS} == {k: w[k] for k in DELTA_KEYS}
        assert g["ok_full"] and g["ok_delta"]
        assert g["save_ms_full"] > 0 and g["save_ms_delta"] > 0
    assert got["best_sparse_bytes_x"] == want["best_sparse_bytes_x"]
    assert got["verdict"] == want["verdict"]
    assert os.path.isfile("experiments/torch/fig_delta.json") \
        == ("smoke" not in kw)


# --------------------------------------------------------- fig_snapshot
def test_fig_snapshot_dirty_sweep_equals_the_reference(bench):
    want = ref_snap.run(mb=2, smoke=True)
    got = fig_snapshot.run(mb=2, smoke=True, device=CPU)
    assert set(got) == set(want)
    assert len(got["dirty_cells"]) == len(want["dirty_cells"]) == 1
    for g, w in zip(got["dirty_cells"], want["dirty_cells"]):
        assert g == w           # d2h bytes, dirty bytes, pcie_x, host_x
        assert g["ok"]
    for c in got["chunk_cells"]:
        assert c["ok"] and c["stall_ms"] > 0
        assert c["chunk_mb"] == 0 or c["stall_x"] > 0
    assert [c["chunk_mb"] for c in got["chunk_cells"]] \
        == [c["chunk_mb"] for c in want["chunk_cells"]]
    assert got["emu_link_gbps"] > 0 and got["compute_window_ms"] > 0


@pytest.mark.parametrize("device_dirty", [True, False])
def test_fig_snapshot_pcie_loop_equals_the_reference(bench, device_dirty):
    """The dirty sweep's one chain, at 1 MiB: (delta d2h bytes, dirtied
    bytes, keyframe d2h bytes, bit-exact) equal to the reference's."""
    d = str(bench / "bench" / "pcie")
    want = ref_snap._pcie_loop(d, device_dirty, 1, 3, 0.1)
    got = fig_snapshot._pcie_loop(d, device_dirty, 1, 3, 0.1, CPU)
    assert got == want
    assert got[3]


def test_emulated_link_meters_each_slice():
    host = torch.arange(4096, dtype=torch.uint8)
    blob = fig_snapshot._emu_device_blob(host, rate=4096 / 0.05)
    import time
    t0 = time.perf_counter()
    piece = blob.reshape(-1)[:2048]
    assert time.perf_counter() - t0 >= 0.02     # 2048 B at 4096 B / 50 ms
    assert torch.equal(fig_snapshot._raw(piece), host[:2048])
    assert fig_snapshot._raw(blob).data_ptr() == host.data_ptr()


# --------------------------------------------------------- beyond_quant
def test_beyond_quant_bytes_equal_the_reference(bench, capsys):
    want = ref_bq.run(quick=True)
    got = beyond_quant.run(quick=True, device=CPU)
    assert set(got) == set(want) == {False, True}
    for q in (False, True):
        assert got[q].total_bytes == want[q].total_bytes
        assert got[q].seconds > 0
    rows = _rows(capsys, "beyond/")
    assert set(rows) == {"beyond/quant_full", "beyond/quant_int8",
                         "beyond/quant_reduction"}
    state = beyond_quant.synth_moments(1, CPU)
    assert [(k, v.dtype) for k, v in state.items()] == [
        ("p", torch.bfloat16), ("mw", torch.float32), ("m", torch.float32),
        ("v", torch.float32)]


# ------------------------------------------------------------------ fig9
@pytest.mark.parametrize("key", fig9_dense_models.MODELS)
def test_fig9_payload_and_estimator_equal_the_reference(key):
    meta = REF_TABLE2[key]
    assert fig9_dense_models.payload_bytes(key) \
        == meta["ckpt_gb"] * 10**9 // ref_f9.SCALE
    assert fig9_dense_models.PAPER_V100_FP16_FLOPS \
        == ref_overlap.V100_FP16_FLOPS
    bl_gbps, fp_gbps, n_writers = 0.61, 1.37, 8
    it, ov_fp, ov_bl, e2e = fig9_dense_models.project(key, bl_gbps,
                                                      fp_gbps, n_writers)
    # the reference's run(), line for line, at the same write rates
    dp = 128 // meta["mp"]
    ck = meta["ckpt_gb"] * 10**9
    rit = ref_overlap.estimate_iteration(
        ref_paper(key), meta["gbs"], 2048, 128,
        peak_flops=ref_overlap.V100_FP16_FLOPS, mfu=0.4)
    r_fp = ref_overlap.effective_overhead(
        rit, ck / (fp_gbps / n_writers * 1e9 * dp), pipelined=True)
    r_bl = ref_overlap.effective_overhead(
        rit, ck / (bl_gbps * 1e9 * meta["mp"]), pipelined=False)
    assert (it.t_forward, it.t_backward, it.t_optimizer) \
        == (rit.t_forward, rit.t_backward, rit.t_optimizer)
    assert (ov_fp, ov_bl, e2e) == (r_fp, r_bl, (1 + r_bl) / (1 + r_fp))


def test_fig9_synth_state_matches_the_reference_leaves():
    nbytes = fig9_dense_models.payload_bytes("gpt3_0_7b") // 1000
    want = ref_f9.synth_state(nbytes)
    got = common.synth_state(nbytes / 2**20, CPU)
    assert sorted(got) == sorted(want) == ["m", "mw", "p", "v"]
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    assert torch.equal(got["m"], torch.zeros_like(got["m"]))
    assert torch.equal(got["v"], torch.ones_like(got["v"]))
    again = common.synth_state(nbytes / 2**20, CPU)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_fig9_save_step_loads_bit_exact_in_the_reference(tmp_path):
    rng = np.random.default_rng(9)
    n = 3000
    host = {"p": rng.standard_normal(n).astype(np.float32),
            "mw": rng.standard_normal(n).astype(np.float32),
            "m": np.zeros(n, np.float32), "v": np.ones(n, np.float32)}
    state = {k: torch.from_numpy(v) for k, v in host.items()}
    state["p"] = state["p"].to(torch.bfloat16)
    sb, sf = fig9_dense_models.save_pair(state, str(tmp_path), 4)
    assert sb.total_bytes > sf.total_bytes == 14 * n
    assert sf.n_writers == 4
    for backend in ("bl", "fp"):
        ref, _ = RefEngine(RefSpec(str(tmp_path / backend))).load(0)
        assert set(ref) == set(state)
        for k in state:
            assert _bits(ref[k]) == _bits(state[k]), (backend, k)


def test_fig9_runs(bench, capsys, monkeypatch):
    """The figure end to end on the CPU with its payloads cut 1000×
    (``payload_bytes`` patched): every model's two rows, positive."""
    monkeypatch.setattr(fig9_dense_models, "payload_bytes",
                        lambda key: REF_TABLE2[key]["ckpt_gb"] * 10**9
                        // ref_f9.SCALE // 1000)
    out = fig9_dense_models.run(quick=True, device=CPU)
    assert list(out) == fig9_dense_models.MODELS[:3]
    assert all(s > 0 and e > 0 for s, e in out.values())
    rows = _rows(capsys, "fig9")
    assert len(rows) == 6 and all(us > 0 for us, _ in rows.values())


# ------------------------------------------------------------------ fig11
def test_fig11_inner_run_beside_the_reference(bench):
    """One GAS, three steps, through both packages' inner function; the
    reference trains its TINY model in JAX, the port the same config in
    torch. Timings are positive; the port's model on the CPU is the
    reference's TINY field for field."""
    d = str(bench / "bench" / "f11")
    want = ref_f11._run(3, 1, "fastpersist-pipelined", d)
    got = fig11_pipelining._run(3, 1, "fastpersist-pipelined", d, CPU)
    assert want > 0 and got > 0
    t = fig11_pipelining.model_for(CPU)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "gated_mlp"):
        assert getattr(t, f) == getattr(ref_f11.TINY, f)
    assert fig11_pipelining.SIZES[("cpu", True)] == (8, [1, 4, 16])


@pytest.mark.parametrize("backend", ["fastpersist", "baseline"])
def test_fig11_checkpoint_loads_bit_exact_in_the_reference(tmp_path,
                                                           backend):
    d = str(tmp_path / "f11")
    tr = fig11_pipelining.make_trainer(1, 1, backend, d, CPU)
    tr.run()
    tr.engine.close()
    from repro_torch.tree import flatten
    live = dict(flatten(tr.state))
    ref, _ = RefEngine(RefSpec(d)).load(1)
    assert set(ref) == set(live)
    for k in live:
        assert _bits(ref[k]) == _bits(live[k]), k


def test_fig11_card_config_is_gpt3_0_7b_at_published_widths():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fig11_pipelining.model_for("cuda")
    import dataclasses
    from repro_torch.configs import get_paper_config
    card = dataclasses.replace(get_paper_config("gpt3_0_7b"),
                               n_layers=fig11_pipelining.CARD_LAYERS)
    assert (card.d_model, card.n_heads, card.d_ff, card.vocab_size) \
        == (1536, 16, 6144, 50257)
    assert 1.4e9 < card.param_count() * 14 < 1.5e9
    assert fig11_pipelining.SIZES[("cuda", True)] == (4, [1, 16])


# ------------------------------------------------------------ fig8, fig10
@pytest.mark.parametrize("writers,volumes", [(1, 1), (2, 1), (4, 1),
                                             (8, 1), (4, 2), (4, 4)])
def test_fig8_plans_equal_the_reference(writers, volumes):
    total = 256 * 2**20 + 12345
    got = fig8_parallel_writes.plan_for(total, writers, volumes)
    want = ref_make_plan(total, RefTopology(dp_degree=writers,
                                            ranks_per_node=writers),
                         "replica", n_volumes=volumes)
    assert [vars(e) for e in got.extents] == [vars(e) for e in want.extents]


def test_fig8_runs(bench, capsys, monkeypatch):
    """The figure end to end on a 4 MiB stream (``synth_bytes`` cut 64×)."""
    monkeypatch.setattr(fig8_parallel_writes, "synth_bytes",
                        lambda mb, seed=0: common.synth_bytes(mb / 64, seed))
    out = fig8_parallel_writes.run(quick=True, device=CPU)
    assert set(out) == {1, 2, 4, 8, "4w_1v", "4w_2v", "4w_4v"}
    assert all(v > 0 for v in out.values())
    assert os.path.isfile("experiments/torch/fig8.json")
    assert not os.path.exists("experiments/fig8.json")
    assert len(_rows(capsys, "fig8/model_")) == 8


def test_fig10_restored_bytes_equal_the_reference(bench):
    want = ref_f10.run(mb=1, smoke=True)
    got = fig10_parallel_restore.run(mb=1, smoke=True, device=CPU)
    assert got == want == {"roundtrip_ok": True}
    # the port's checkpoint, restored by both packages' engines
    d = str(bench / "bench" / "f10x")
    state = fig10_parallel_restore.make_state(1, CPU)
    spec = fig10_parallel_restore.make_spec(d, 4)
    from repro_torch.core.engine import CheckpointEngine
    with CheckpointEngine(spec) as eng:
        eng.save(state, 0).result()
        mine, _ = eng.load(0, parallel=2, device=CPU)
    ref, _ = RefEngine(RefSpec(spec.directory,
                               volumes=list(spec.volumes))).load(
        0, parallel=2)
    want_blob = ref_common.synth_bytes(1, seed=10)
    assert _bits(ref["blob"]) == _bits(mine["blob"]) == want_blob.tobytes()
    assert _bits(ref["head"]) == _bits(mine["head"]) \
        == np.arange(977, dtype=np.float32).tobytes()


def test_fig10_sweep_runs(bench):
    out = fig10_parallel_restore.run(mb=2, device=CPU)
    assert out["roundtrip_ok"] is True
    assert out["single_reader"] > 0 and out["speedup_4readers_vs_single"] > 0
    assert any(k.startswith("r4_") for k in out)
    assert os.path.isfile("experiments/torch/fig10.json")


# ------------------------------------- the figures with no fixed numbers
def test_perf_writer_rows(bench):
    log = perf_writer.run(mb=4, device=CPU)
    names = [r["iteration"] for r in log]
    assert names[:6] == ["it0_baseline_32MB_double_direct",
                         "it1_single_buffer", "it2_buffer_4MB",
                         "it2b_buffer_128MB", "it3_direct_vs_buffered",
                         "it4_engine_atomic_commit"]
    assert {"it5_multi_volume_stripe", "it7_arena_steady_state",
            "it8_single_pass_crc", "final_best"} <= set(names)
    for r in log:
        assert r["gbps"] >= 0
        assert r["verdict"] in ("baseline", "confirmed", "refuted",
                                "skipped", "selected")
        assert (r["gbps"] > 0) == (r["verdict"] != "skipped")
    assert os.path.isfile("experiments/torch/perf_writer.json")


def test_fig7_rows(bench, capsys, monkeypatch):
    monkeypatch.setattr(fig7_buffer_sweep, "synth_bytes",
                        lambda mb, seed=0: common.synth_bytes(mb / 16, seed))
    out = fig7_buffer_sweep.run(quick=True, device=CPU)
    sweep = [k for k in out if k[1] in ("single", "double")]
    assert len(sweep) == 2 * 2 * 4 and all(out[k] > 0 for k in sweep)
    assert out[(128, "arena", "reuse")] > 0
    rows = _rows(capsys, "fig7/")
    assert "fig7/arena_first_128MB" in rows
    assert rows["fig7/arena_first_128MB"][1] == "alloc+copy_1allocs"
    assert rows["fig7/arena_steady_128MB"][1].endswith("_3reuses")


def test_fig2_rows(bench, capsys, monkeypatch):
    monkeypatch.setattr(fig2_baseline_util, "synth_state",
                        lambda mb, device: common.synth_state(mb / 32,
                                                              device))
    monkeypatch.setattr(fig2_baseline_util, "measure_peak_write_gbps",
                        lambda mb: common.measure_peak_write_gbps(4))
    peak = fig2_baseline_util.run(quick=True, device=CPU)
    assert peak > 0
    rows = _rows(capsys, "fig2/")
    assert set(rows) == {"fig2/peak_write", "fig2/baseline_64MB",
                         "fig2/baseline_256MB"}
    assert rows["fig2/baseline_64MB"][0] > 0


# ------------------------------------------------------------- the harness
@pytest.mark.parametrize("name,module", run.FIGURES)
def test_every_figure_raises_on_cuda_without_a_card(name, module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda does not raise")
    import importlib
    mod = importlib.import_module(f"repro_torch.benchmarks.{module}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.run(quick=True)


def test_harness_cli(bench, capsys):
    run.main(["--device", "cpu", "--only", "beyond_quant"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert any(line.startswith("beyond/quant_reduction,") for line in out)
    assert any(line.startswith("beyond_quant/wall,") for line in out)
    assert not os.path.exists(str(bench / "bench"))      # cleaned up
    with pytest.raises(ValueError, match="unknown figures"):
        run.run_all(device=CPU, only=["fig99"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run.main(["--only", "fig2"])


def test_harness_exits_1_when_a_figure_fails(bench, monkeypatch, capsys):
    def boom(quick=True, device="cuda"):
        raise OSError("disk full")
    monkeypatch.setattr(beyond_quant, "run", boom)
    with pytest.raises(SystemExit) as e:
        run.main(["--device", "cpu", "--only", "beyond_quant"])
    assert e.value.code == 1
    assert "beyond_quant/FAILED,0.0,OSError('disk full')" \
        in capsys.readouterr().out


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_harness_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the figures run on cuda by default")
    monkeypatch.setenv("FASTPERSIST_BENCH_DIR", str(tmp_path / "bench"))
    monkeypatch.chdir(tmp_path)
    results, seconds, failed = run.run_all(
        quick=True, device="cuda",
        only=["beyond_quant", "fig_delta", "fig10_restore"])
    assert not failed
    assert all(c["ok_full"] and c["ok_delta"]
               for c in results["fig_delta"]["cells"])
    assert results["fig10_restore"]["roundtrip_ok"] is True
    assert results["beyond_quant"][True].device_scales
