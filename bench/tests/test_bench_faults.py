"""The controls and each fault planted under the timed path make a run's
``correct`` come out false, held to each cell's own limits: the step
control (the reference in the program's place, its weights, master
weights and moments in bfloat16), the checkpoint control (the program's
int8-quantized checkpoints), a step that returns its state unchanged,
half of the batch left out, and a value altered where the save takes
it; for a cell that saves one DP rank's extent, the tiny run saves its
rank's extent too."""
import json
import os

import pytest

from bench import common, faults
from bench.tests.conftest import TINY, TRAIN
from bench.generators import train_ckpt

with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def rank(cell: str):
    return common.cell_params(common.load("workloads", cell))[1].get("rank")


#: each cell's readings as ``bench/control.py`` runs them
CASES = [(c, v) for c in CELLS for v in faults.variants(
    common.cell_params(common.load("workloads", c))[1])]


def cell_run(cell: str, **over):
    """The tiny run's parameters and configuration for ``cell``: its limits
    and, for a rank mix, its rank of its configuration's DP ranks."""
    wl = common.load("workloads", cell)
    params = dict(TRAIN, limits=wl["limits"], rank=rank(cell), **over)
    assumed = common.load("configs", wl["config"]).get("assumed", {})
    return params, dict(TINY, assumed=assumed)


@pytest.mark.parametrize("cell,variant", CASES,
                         ids=[f"{c}-{v}" for c, v in CASES])
def test_control_and_faults_make_the_run_incorrect(make_ctx, cell, variant):
    params, cfg = cell_run(cell)
    if variant == "control_step":
        checks = train_ckpt.control_step(make_ctx(params, cfg=cfg))
    elif variant == "control_ckpt":
        checks = train_ckpt.run(make_ctx(dict(params, fp={
            "quantize": True}), cfg=cfg))["checks"]
    else:
        with faults.FAULTS[variant]():
            checks = train_ckpt.run(make_ctx(params, cfg=cfg))["checks"]
    assert not all(c["ok"] for c in checks), checks


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes_the_cells_limits(make_ctx, cell):
    params, cfg = cell_run(cell)
    out = train_ckpt.run(make_ctx(params, seed=11, cfg=cfg))
    assert all(c["ok"] for c in out["checks"]), out["checks"]
