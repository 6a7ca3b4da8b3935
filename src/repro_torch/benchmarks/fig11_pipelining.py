"""Paper Fig. 11: pipelined checkpointing — REAL training with a
checkpoint every iteration (the counterpart of
``benchmarks/fig11_pipelining.py``): the GAS sweep, slowdown against the
no-checkpoint run, for the baseline, FastPersist and pipelined
FastPersist. Training runs through ``repro_torch.train.trainer.Trainer``
on ``device``; checkpoints are real disk writes.

On the CPU the model is the reference's ``TINY`` (4 × 256). On the card
it is ``gpt3_0_7b`` at its published widths (arXiv:2005.14165: d 1536,
16 heads of 96, d_ff 6144, vocab 50257), cut in depth to
``CARD_LAYERS`` of 24 (1.48 GB a save) and to 4 steps a cell, so that
the quick sweep (24 saves) takes about a minute on an H100 host's disk
(at 2 layers and 5 steps, 1.87 GB a save, it took 85 s); the cuts are
printed as the ``fig11/config`` row."""
import dataclasses
import os
import shutil

import numpy as np

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device)
from repro_torch.configs import get_paper_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.partition import Topology
from repro_torch.train.trainer import CheckpointPolicy, Trainer, \
    TrainerConfig

TINY = ModelConfig(
    name="gpt3-tiny", arch_type="dense", n_layers=4, d_model=256,
    n_heads=8, n_kv_heads=8, d_ff=1024, vocab_size=8192, gated_mlp=False,
    source="bench")
#: the card's model: gpt3_0_7b's depth cut to this many of its 24 layers
CARD_LAYERS = 1
#: micro-batch and sequence of every step (the reference's)
MICRO_BATCH, SEQ = 4, 128
#: (steps, GAS sweep) by (device type, quick): the reference's sizes on
#: the CPU; on the card fewer steps and GAS values, since every step
#: saves the whole state
SIZES = {("cpu", True): (8, [1, 4, 16]),
         ("cpu", False): (16, [1, 2, 4, 8, 16, 64]),
         ("cuda", True): (4, [1, 16]),
         ("cuda", False): (16, [1, 2, 4, 8, 16, 64])}


def model_for(device) -> ModelConfig:
    if resolve_device(device).type == "cpu":
        return TINY
    return dataclasses.replace(get_paper_config("gpt3_0_7b"),
                               n_layers=CARD_LAYERS)


def make_trainer(steps, gas, backend, d, device="cuda", model=None):
    """The Trainer of one cell: ``backend`` is a CheckpointEngine
    backend key, or "none"; every step checkpoints into ``d``."""
    shutil.rmtree(d, ignore_errors=True)
    pol = None
    if backend != "none":
        pol = CheckpointPolicy(
            directory=d, every=1, backend=backend,
            fp=FastPersistConfig(strategy="replica",
                                 topology=Topology(dp_degree=4,
                                                   ranks_per_node=4)))
    model = model or model_for(device)
    return Trainer(TrainerConfig(model=model, steps=steps,
                                 global_batch=MICRO_BATCH * gas,
                                 seq_len=SEQ, gas=gas, log_every=10**9,
                                 checkpoint=pol), device=device)


def _run(steps, gas, backend, d, device="cuda", model=None):
    """Mean iteration seconds after the first two steps; the cell's
    checkpoints stay in ``d``."""
    tr = make_trainer(steps, gas, backend, d, device, model)
    tr.run()
    if tr.engine is not None:
        tr.engine.close()
    return float(np.mean(tr.iter_times[2:]))


def run(quick=True, device="cuda"):
    device = resolve_device(device)
    steps, gas_list = SIZES[(device.type, bool(quick))]
    model = model_for(device)
    n_params = model.param_count()
    emit("fig11/config", 0.0,
         f"{model.name}_layers{model.n_layers}_d{model.d_model}_"
         f"h{model.n_heads}_ff{model.d_ff}_vocab{model.vocab_size}_"
         f"seq{SEQ}_microbatch{MICRO_BATCH}_steps{steps}_"
         f"gas{'-'.join(map(str, gas_list))}_"
         f"state{n_params * 14 / 1e9:.3f}GB")
    out = {}
    for gas in gas_list:
        d = os.path.join(bench_dir(), "f11")
        t_none = _run(steps, gas, "none", d, device, model)
        t_fp = _run(steps, gas, "fastpersist", d, device, model)
        t_pipe = _run(steps, gas, "fastpersist-pipelined", d, device, model)
        t_base = _run(steps, gas, "baseline", d, device, model)
        shutil.rmtree(d, ignore_errors=True)
        slow_fp = t_fp / t_none - 1
        slow_pipe = t_pipe / t_none - 1
        slow_base = t_base / t_none - 1
        out[gas] = (slow_base, slow_fp, slow_pipe)
        emit(f"fig11a/gas{gas}_baseline", t_base,
             f"{100*slow_base:.1f}%_slowdown")
        emit(f"fig11a/gas{gas}_fastpersist", t_fp,
             f"{100*slow_fp:.1f}%_slowdown")
        emit(f"fig11a/gas{gas}_pipelined", t_pipe,
             f"{100*slow_pipe:.1f}%_slowdown")
    return out


if __name__ == "__main__":
    run()
    cleanup()
