"""The port imports neither JAX, nor the JAX package, nor ml_dtypes, and
``chip_smoke.py`` refuses to run (and prints no result) without a CUDA
card or without the rest of the repository. Checked in subprocesses:
this test process has JAX loaded by conftest."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _run(code_or_args, cwd=ROOT, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable, *code_or_args])
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_and_chip_smoke_import_no_jax():
    code = f"""
import importlib, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.argv = ["chip_smoke.py", "--help"]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print("imported", len(names), "modules")
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout
    n = int(out.stdout.split("imported")[1].split()[0])
    assert n >= 20          # every module of the slice was imported


TIER_MODULES = ["repro_torch.core." + m for m in
                ("retry", "upload", "peer", "serve", "retention",
                 "overlap")] + ["repro_torch.sharding",
                                "repro_torch.sharding.specs"]


def test_tier_modules_import_no_jax():
    """The modules of the durability-tier slice exist and import nothing
    of JAX, the JAX package or ml_dtypes; ``repro_torch.core`` exports
    what ``repro.core`` exports, its fixed backend table in place of the
    reference's registry and ``PipelinedCheckpointer``."""
    code = f"""
import importlib, sys
for name in {TIER_MODULES!r}:
    importlib.import_module(name)
from repro_torch.sharding.specs import zero1_ownership
import repro_torch.core as core
want = ["LocalObjectStore", "ObjectStore", "UploadManager", "UploadStats",
        "hydrate", "make_store", "register_store_scheme", "remote_steps",
        "IterationModel", "estimate_iteration", "effective_overhead",
        "BACKENDS", "available_backends", "EngineStats", "DeltaPlan",
        "dirty_byte_spans"]
missing = [n for n in want if not hasattr(core, n)]
assert not missing, missing
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print("ok")
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


MODEL_MODULES = ["repro_torch.configs." + m for m in
                 ("gpt3_family", "qwen1_5_4b", "gemma2_9b", "arctic_480b",
                  "minicpm3_4b", "qwen3_moe_235b", "internvl2_26b",
                  "whisper_small", "zamba2_2_7b")] + [
    "repro_torch.models.layers", "repro_torch.models.transformer",
    "repro_torch.models.registry", "repro_torch.models.hybrid",
    "repro_torch.models.encdec", "repro_torch.launch.serve_decode",
    "repro_torch.launch.quickstart",
    "repro_torch.launch.fastpersist_vs_baseline",
    "repro_torch.launch.train_100m"]


def test_model_modules_import_no_jax():
    """The modules of the model slices (every config of the reference,
    the MoE layer, the dense and moe prefill and decode, the hybrid, the
    encoder-decoder) and the launchers exist and import nothing of JAX,
    the JAX package or ml_dtypes;
    ``repro_torch.configs`` exports what ``repro.configs`` exports and
    resolves every config."""
    code = f"""
import importlib, sys
for name in {MODEL_MODULES!r}:
    importlib.import_module(name)
import repro_torch.configs as c
want = ["ARCH_IDS", "INPUT_SHAPES", "MLAConfig", "MoEConfig", "ModelConfig",
        "SSMConfig", "ShapeConfig", "all_configs", "get_config", "reduced",
        "GPT3_CONFIGS", "GPT3_MOE_1_8B", "PAPER_TABLE2", "get_paper_config"]
missing = [n for n in want if not hasattr(c, n)]
assert not missing, missing
assert len(c.all_configs()) == 10
assert [c.get_paper_config(k).name for k in c.PAPER_ARCH_IDS][-1] == \
    "gpt3-1.8b-moe"
from repro_torch.models.layers import moe_apply, moe_apply_sorted, moe_route
from repro_torch.models.transformer import decode_step, init_cache, prefill
from repro_torch.models.hybrid import decode_step, init_cache, prefill
from repro_torch.models.layers import mla_attention, mla_init
from repro_torch.models.encdec import decode_step, encode, init_cache, prefill
from repro_torch.models.registry import make_batch
from repro_torch.models.transformer import embed_inputs
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print("ok")
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    out = _run(["chip_smoke.py"], env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
    assert "torch.cuda.is_available() is false" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], cwd=tmp_path,
               env_extra={"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


PARALLEL_MODULES = ["repro_torch.sharding.moe_ep",
                    "repro_torch.sharding.specs",
                    "repro_torch.launch.mesh", "repro_torch.launch.inputs",
                    "repro_torch.launch.op_cost",
                    "repro_torch.launch.dryrun",
                    "repro_torch.models.registry"]


def test_parallel_and_dryrun_modules_import_no_jax():
    """Expert parallelism, the mesh helpers and the dry run exist and
    import nothing of JAX, the JAX package or ml_dtypes; the dry run's
    rates are the H100's (no TPU constant in the port)."""
    code = f"""
import importlib, sys
for name in {PARALLEL_MODULES!r}:
    importlib.import_module(name)
from repro_torch.sharding.moe_ep import local_params, make_moe_ep
from repro_torch.sharding.specs import (batch_specs, cache_specs, dp_axes,
    local_slice, param_spec, param_specs, replicated_specs, shard_shape,
    zero1_specs)
from repro_torch.launch.mesh import (Mesh, init_process_mesh,
    make_cpu_mesh, make_production_mesh, run_ranks)
from repro_torch.launch.inputs import batch_structs, input_specs
from repro_torch.launch.op_cost import OpCost, aggregate
from repro_torch.launch import dryrun
assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) == \\
    (989e12, 3.35e12, 450e9)
assert make_production_mesh(multi_pod=True).size == 512
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print("ok")
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    tpu = re.compile(r"(?<![\d.])(197e12|819e9|50e9)\b")
    hits = [(p.name, m.group(0))
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")
            for m in tpu.finditer(p.read_text())]
    assert not hits, hits


BENCHMARK_MODULES = ["repro_torch.benchmarks." + m for m in
                     ("common", "run", "fig11_pipelining",
                      "fig9_dense_models", "perf_writer",
                      "fig7_buffer_sweep", "fig8_parallel_writes",
                      "fig2_baseline_util", "fig10_parallel_restore",
                      "fig_delta", "fig_snapshot", "beyond_quant",
                      "fig10_moe", "table1_bandwidth", "fig12_projection",
                      "fig13_tiered_upload", "fig_peer", "fig_serve",
                      "roofline", "make_tables")]
#: the figures of the last slice, each imported in a fresh interpreter
LAST_FIGURES = BENCHMARK_MODULES[-8:]


def test_benchmark_modules_import_no_jax():
    """The port's figures exist, are all in the harness, and import
    nothing of JAX, the JAX package, ml_dtypes or the reference's
    top-level ``benchmarks`` package; the walk of
    ``test_port_and_chip_smoke_import_no_jax`` reaches them too."""
    code = f"""
import importlib, pkgutil, sys
import repro_torch
walked = {{m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                 "repro_torch.")}}
for name in {BENCHMARK_MODULES!r}:
    assert name in walked, name
    importlib.import_module(name)
from repro_torch.benchmarks import run
assert sorted("repro_torch.benchmarks." + m for _, m in run.FIGURES) == \\
    sorted(n for n in {BENCHMARK_MODULES!r}
           if not n.endswith((".common", ".run", ".make_tables")))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r} + ("benchmarks",))
assert not bad, bad
print("ok")
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", LAST_FIGURES)
def test_last_figure_module_imports_no_jax(module):
    """Each module of the last slice of figures, imported alone in a
    fresh interpreter, loads neither JAX nor the JAX package nor the
    reference's ``benchmarks``."""
    code = f"""
import importlib, sys
importlib.import_module({module!r})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r} + ("benchmarks",))
assert not bad, bad
print("ok")
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
