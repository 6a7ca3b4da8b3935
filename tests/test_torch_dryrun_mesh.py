"""The dry run's per-device figures on a mesh (ROADMAP C.26): the port's
``lower_one`` against the reference's on the same 2 x 4 (``data``,
``model``) mesh, at ``reduced()`` widths passed as ``extra_cfg``, one
train pair per family plus stablelm's prefill and decode.

The reference compiles each pair on 8 of its 512 forced host devices;
JAX fixes its device count when it starts, and this process started it
already (tests/conftest.py), so the reference pairs run in a
subprocess that imports ``repro.launch.dryrun`` (whose ``XLA_FLAGS``
line comes first) and patches its ``make_production_mesh`` (two such
subprocesses, each with half the pairs, side by side). The port's
``make_production_mesh`` is patched to ``make_mesh((2, 4), ...)``.

Held per pair:

  * ``flops_per_device`` within 1 %;
  * the collective bytes per device within 25 % of the reference's HLO
    count: the total, with the reference's collective-permutes left out
    (the one kind excluded here: XLA's halo exchange of a split inside a
    shard, ``dryrun.NOT_COUNTED``), and each kind both count. The
    reference's all-to-alls (rope's halves of a split head, at most 6 %
    of a pair's total) are not counted by the port either, and stay in
    the reference's total.
"""
import json
import os
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [("stablelm_1_6b", "train_4k"), ("stablelm_1_6b", "prefill_32k"),
         ("stablelm_1_6b", "decode_32k"), ("gemma2_9b", "train_4k"),
         ("mamba2_370m", "train_4k"), ("zamba2_2_7b", "train_4k"),
         ("qwen3_moe_235b", "train_4k"), ("minicpm3_4b", "train_4k"),
         ("internvl2_26b", "train_4k"), ("whisper_small", "train_4k")]
#: the kind left out of the comparison, by name
EXCLUDED = "collective-permute"
TOTAL_TOL, FLOPS_TOL = 0.25, 0.01

_REF_SCRIPT = r"""
import json, sys
from dataclasses import fields
import repro.launch.dryrun as rd
import jax
from repro.configs import get_config, reduced
rd.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 4), ("data", "model"))
out = {}
for arch, shape in %(pairs)r:
    cfg = reduced(get_config(arch))
    extra = {f.name: getattr(cfg, f.name) for f in fields(cfg)
             if f.name != "name"}
    if %(n_layers)r:
        extra["n_layers"] = %(n_layers)r
    r = rd.lower_one(arch, shape, verbose=False, extra_cfg=extra)
    out[arch + "/" + shape] = {
        "flops": r["hlo_flops_per_device"],
        "collectives": r["collective_bytes_per_device"]}
json.dump(out, open(sys.argv[1], "w"))
print("REF-OK")
"""


def _reference(d, n_layers=None) -> dict:
    """The reference's figures of every pair: the pairs split between two
    subprocesses run side by side, each on its own 512 host devices."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    runs = []
    for i in range(2):
        path = os.path.join(d, f"ref{i}.json")
        script = _REF_SCRIPT % {"pairs": PAIRS[i::2], "n_layers": n_layers}
        runs.append((path, subprocess.Popen(
            [sys.executable, "-c", script, path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = {}
    for path, proc in runs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF-OK" in stdout, stderr[-3000:]
        with open(path) as f:
            out.update(json.load(f))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _reference(str(tmp_path_factory.mktemp("dryrun_mesh")))


def _port(arch, shape, monkeypatch):
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_mesh(
                            (2, 4), ("data", "model")))
    cfg = reduced(get_config(arch))
    extra = {f.name: getattr(cfg, f.name) for f in fields(cfg)
             if f.name != "name"}
    return dryrun.lower_one(arch, shape, verbose=False, extra_cfg=extra)


@pytest.mark.parametrize("arch,shape", PAIRS,
                         ids=[f"{a}-{s}" for a, s in PAIRS])
def test_per_device_figures_match_reference(arch, shape, reference,
                                            monkeypatch):
    ref = reference[f"{arch}/{shape}"]
    got = _port(arch, shape, monkeypatch)
    assert got["n_chips"] == 8
    assert got["flops_per_device"] == pytest.approx(ref["flops"],
                                                    rel=FLOPS_TOL)
    assert EXCLUDED in got["collectives_not_counted"]
    mine = got["collective_bytes_per_device"]
    theirs = {k: v for k, v in ref["collectives"].items() if k != EXCLUDED}
    assert EXCLUDED not in mine
    assert got["collective_total_per_device"] == pytest.approx(
        sum(theirs.values()), rel=TOTAL_TOL)
    shared = set(mine) & set(theirs)
    assert shared, (mine, theirs)
    for kind in shared:
        assert mine[kind] == pytest.approx(theirs[kind], rel=TOTAL_TOL), \
            kind


if __name__ == "__main__":
    # the table of ROADMAP C.26: python tests/test_torch_dryrun_mesh.py
    # [n_layers]
    import tempfile
    n_layers = int(sys.argv[1]) if len(sys.argv) > 1 else None
    with tempfile.TemporaryDirectory() as d:
        ref = _reference(d, n_layers)
    dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
        (2, 4), ("data", "model"))
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             EXCLUDED)
    print("| pair | flops/dev ref / port | "
          + " | ".join(f"{k} ref / port" for k in kinds)
          + " | total ref (less CP) / port |")
    print("|---" * (len(kinds) + 3) + "|")
    for arch, shape in PAIRS:
        cfg = reduced(get_config(arch))
        extra = {f.name: getattr(cfg, f.name) for f in fields(cfg)
                 if f.name != "name"}
        if n_layers:
            extra["n_layers"] = n_layers
        got = dryrun.lower_one(arch, shape, verbose=False, extra_cfg=extra)
        r = ref[f"{arch}/{shape}"]
        mine, theirs = got["collective_bytes_per_device"], r["collectives"]
        cells = [f"{theirs.get(k, 0):.4g} / {mine.get(k, 0):.4g}"
                 for k in kinds]
        less = sum(v for k, v in theirs.items() if k != EXCLUDED)
        print(f"| {arch} {shape} | {r['flops']:.5g} / "
              f"{got['flops_per_device']:.5g} | " + " | ".join(cells)
              + f" | {less:.4g} / {got['collective_total_per_device']:.4g}"
              " |")
