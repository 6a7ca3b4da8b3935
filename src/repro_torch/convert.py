"""Carry weights and optimizer state across packages.

``train_state_from_numpy`` turns the reference's ``TrainState`` (or a
params dict) held as numpy arrays — bf16 as uint16 bits or as an
``ml_dtypes.bfloat16`` array on the caller's side — into the port's
tensors on a given device; ``to_numpy`` is the inverse (bf16 comes back
as uint16 bits). Trees are matched by structure: NamedTuples named
``TrainState`` / ``AdamState`` become the port's classes, dicts and
sequences stay what they are.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adam import AdamState
from repro_torch.train.steps import TrainState
from repro_torch.train.trainer import resolve_device
from repro_torch.tree import tree_map

_TYPES = {"TrainState": TrainState, "AdamState": AdamState}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, device):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _TYPES.get(type(tree).__name__)
        fields = [_convert(getattr(tree, f), device) for f in tree._fields]
        return cls(*fields) if cls is not None else type(tree)(*fields)
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    return _tensor(tree, device)


def train_state_from_numpy(tree, device="cuda"):
    """The reference's TrainState / params (numpy leaves) as the port's
    tree of tensors on ``device`` (default cuda, which raises without a
    card; pass ``device="cpu"`` for the CPU)."""
    return _convert(tree, resolve_device(device))


def to_numpy(tree):
    """The port's tree as numpy arrays on the host (bf16 as uint16).
    Always copies: a view of a CPU tensor would follow the in-place
    optimizer updates."""
    def one(t):
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return tree_map(one, tree)
