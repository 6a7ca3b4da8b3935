"""Faults planted under the timed path, each a context manager that
patches the program for the length of a run: what the cell's checks
must catch. Used by ``bench/control.py`` on the chip and by the CPU test
of the harness."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _wrap_step(change):
    import repro_torch.train.trainer as tr
    make = tr.make_train_step

    def patched(model, opt_cfg, gas=1):
        return change(make(model, opt_cfg, gas), model, gas)
    return _patch(tr, "make_train_step", patched)


def unchanged():
    """A step that computes the loss and returns its state unchanged."""
    def change(step, model, gas):
        def stuck(state, batch):
            with torch.no_grad():
                loss = model.loss(state.params, batch)
            return state, {"loss": loss.float(), "step": state.opt.step}
        return stuck
    return _wrap_step(change)


def half_batch():
    """Half of each batch left out, the mean taken over the rest."""
    def change(step, model, gas):
        def half(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    return _wrap_step(change)


def altered_save():
    """One value of the state altered where the save takes it: the first
    master weight, or the first byte of a rank's part (``bench/extent.py``),
    which lies inside its extent."""
    from repro_torch.core.engine import CheckpointEngine
    from repro_torch.tree import flatten
    save = CheckpointEngine.save

    def patched(self, state, step, extras=None):
        leaves = flatten(state.opt.master if hasattr(state, "opt")
                         else state)
        with torch.no_grad():
            leaves[0][1].view(-1)[0] += 1
        return save(self, state, step, extras)
    return _patch(CheckpointEngine, "save", patched)


#: the faults a training cell can have
FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered_save}


def variants(params: dict) -> list:
    """What a cell's control readings run besides sound runs: the two
    controls and each fault; a mix that saves one DP rank's extent has no
    ``control_ckpt``, since its part is bytes, with no float record for
    int8 saves to quantize."""
    out = ["control_step", "control_ckpt", *FAULTS]
    if params.get("rank") is not None:
        out.remove("control_ckpt")
    return out
