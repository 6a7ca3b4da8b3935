"""``layers.layer_slices``: the loops over stacked layers split each
stacked leaf once per forward (one ``unbind``), so that each leaf's
backward is one ``stack`` of its layers' gradients, not one zero tensor
of the whole stack per layer with that layer's gradient copied in.

Each family whose loop takes it (dense, moe, vlm, ssm, hybrid, encdec)
is held at 4 layers: the gradients of ``model.loss`` equal, under
``torch.equal``, those of the same loss built with per-index ``v[i]``
(:func:`_per_index`), with and without ``remat``; no ``SelectBackward0``
reaches a stacked leaf and one ``UnbindBackward0`` feeds each; a train
step makes one call a micro-batch.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import configs as pconfigs
from repro_torch.models import layers as ly
from repro_torch.models.registry import build_model, make_batch
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import flatten, leaves

#: family -> (arch, changes to its reduced config); 4 layers each, the
#: hybrid's as 2 groups of 2 so that both of its loops run twice
FAMILIES = {
    "dense": ("stablelm_1_6b", {}),
    "moe": ("qwen3_moe_235b", {}),
    "vlm": ("internvl2_26b", {}),
    "ssm": ("mamba2_370m", {}),
    "hybrid": ("zamba2_2_7b", {"attn_every": 2}),
    "encdec": ("whisper_small", {"n_enc_layers": 4}),
}
#: the families whose stacks ``remat`` recomputes
REMAT = ("dense", "moe", "encdec")
#: the top-level keys of the stacked trees
STACKED = ("layers", "enc_layers", "dec_layers", "ssm_layers", "inv_norms")
ROWS, SEQ = 2, 32


def _cfg(family):
    arch, changes = FAMILIES[family]
    return dataclasses.replace(pconfigs.reduced(pconfigs.get_config(arch)),
                               n_layers=4, **changes)


def _setup(family, remat=False):
    cfg = _cfg(family)
    model = build_model(cfg, remat=remat)
    params = init_train_state(model, 0, "cpu").params
    return model, params, make_batch(cfg, ROWS, SEQ, device="cpu")


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _per_index(tree, n):
    """The selection before ``layer_slices``: layer ``i`` of every
    stacked leaf as ``v[i]``."""
    return [_layer(tree, i) for i in range(n)]


def _grads(model, params, batch):
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    return torch.autograd.grad(model.loss(params, batch), ps)


def _assert_grads_equal(family, remat, monkeypatch):
    model, params, batch = _setup(family, remat)
    got = _grads(model, params, batch)
    with monkeypatch.context() as m:
        m.setattr(ly, "layer_slices", _per_index)
        want = _grads(model, params, batch)
    for (name, _), g, w in zip(flatten(params), got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert any(g.abs().sum() > 0 for g in got)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grads_equal_per_index(family, monkeypatch):
    _assert_grads_equal(family, False, monkeypatch)


@pytest.mark.parametrize("family", REMAT)
def test_remat_grads_equal_per_index(family, monkeypatch):
    _assert_grads_equal(family, True, monkeypatch)


def _consumers(root):
    """{id(leaf): [names of the graph nodes that feed its gradient]}."""
    out, seen, todo = {}, set(), [root]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if hasattr(nxt, "variable"):
                out.setdefault(id(nxt.variable), []).append(
                    type(node).__name__)
            todo.append(nxt)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_unbind_feeds_each_stacked_leaf(family):
    model, params, batch = _setup(family)
    for p in leaves(params):
        p.requires_grad_(True)
    feeds = _consumers(model.loss(params, batch).grad_fn)
    stacked = [(name, p) for name, p in flatten(params)
               if name.split("/")[0] in STACKED]
    assert stacked
    for name, p in stacked:
        assert "SelectBackward0" not in feeds.get(id(p), []), name
        assert feeds.get(id(p)) == ["UnbindBackward0"], name


@pytest.mark.parametrize("gas", [1, 2])
def test_train_step_calls_once_a_micro_batch(gas):
    model, _, _ = _setup("dense")
    state = init_train_state(model, 0, "cpu")
    batch = make_batch(model.cfg, 2 * gas, SEQ, device="cpu")
    step = make_train_step(model, AdamConfig(lr=1e-3), gas=gas)
    before = ly.layer_slices.calls
    step(state, batch)
    assert ly.layer_slices.calls - before == gas


def test_layer_slices_are_views_of_each_layer():
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, generator=g),
            "b": {"c": torch.randn(3, 2, 5, generator=g)}}
    got = ly.layer_slices(tree, 3)
    assert len(got) == 3
    for i, lp in enumerate(got):
        want = _layer(tree, i)
        assert torch.equal(lp["a"], want["a"])
        assert torch.equal(lp["b"]["c"], want["b"]["c"])
        assert lp["b"]["c"].untyped_storage().data_ptr() == \
            tree["b"]["c"].untyped_storage().data_ptr()
