"""The controls and each fault planted under the timed path make a run's
``correct`` come out false, held to each cell's own limits: the step
control (the reference in the program's place, its weights, master
weights and moments in bfloat16), the checkpoint control (the program's
int8-quantized checkpoints), a step that returns its state unchanged,
half of the batch left out, and a value altered where the save takes
it."""
import json
import os

import pytest

from bench import common, faults
from bench.tests.conftest import TRAIN
from bench.generators import train_ckpt

with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
VARIANTS = ["control_step", "control_ckpt", *faults.FAULTS]
CASES = [(c, v) for c in CELLS for v in VARIANTS]


@pytest.mark.parametrize("cell,variant", CASES,
                         ids=[f"{c}-{v}" for c, v in CASES])
def test_control_and_faults_make_the_run_incorrect(make_ctx, cell, variant):
    limits = common.load("workloads", cell)["limits"]
    params = dict(TRAIN, limits=limits)
    if variant == "control_step":
        checks = train_ckpt.control_step(make_ctx(params))
    elif variant == "control_ckpt":
        checks = train_ckpt.run(make_ctx(dict(params, fp={
            "quantize": True})))["checks"]
    else:
        with faults.FAULTS[variant]():
            checks = train_ckpt.run(make_ctx(params))["checks"]
    assert not all(c["ok"] for c in checks), checks


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes_the_cells_limits(make_ctx, cell):
    limits = common.load("workloads", cell)["limits"]
    out = train_ckpt.run(make_ctx(dict(TRAIN, limits=limits), seed=11))
    assert all(c["ok"] for c in out["checks"]), out["checks"]
