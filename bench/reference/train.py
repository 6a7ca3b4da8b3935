"""The reference's first training steps from the same weights and token
stream as the program: the losses, the first gradient as the optimizer
gets it (clipped), and each leaf's change over the steps. The loss is
the configuration's family's, ``loss(cfg, tree, tokens, labels)`` of
``bench/reference/<family>.py``."""
from __future__ import annotations

import torch

from bench import common
from bench.reference import adam, tokens


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def unflat(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def follow(cfg: dict, hp: dict, seed: int, w0: dict, n_steps: int,
           rows: int, micro: int, device, dtype=torch.float32):
    """``w0``: ``{name: tensor}`` of the starting weights (any float
    dtype). Weights, activations, master weights and moments are held in
    ``dtype``: float32 for the reference, bfloat16 for the control.
    Returns ``{"loss": [..], "grad": {name: norm}, "delta": {name:
    norm}}``, each norm in float64 on the host."""
    no_tf32()
    loss = common.module("reference", common.family_name(cfg)).loss
    master = {k: v.to(device=device, dtype=dtype).clone()
              for k, v in w0.items()}
    opt = adam.init(master)
    losses, first = [], None
    for i in range(n_steps):
        tok, lab = tokens.batch(seed, i, cfg["vocab_size"], rows,
                                cfg["seq_len"])
        tok = torch.from_numpy(tok).to(device)
        lab = torch.from_numpy(lab).to(device)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in master.items()}
        tree = unflat(leaves)
        grads = {k: torch.zeros_like(v) for k, v in master.items()}
        total = 0.0
        n_micro = rows // micro
        for j in range(n_micro):
            sl = slice(j * micro, (j + 1) * micro)
            lm = loss(cfg, tree, tok[sl], lab[sl]) / n_micro
            for k, g in zip(leaves, torch.autograd.grad(lm, list(
                    leaves.values()))):
                grads[k] += g
            total += float(lm.detach())
        losses.append(total)
        adam.step(opt, grads, hp)
        if first is None:
            b1 = hp["b1"]
            first = {k: float(torch.linalg.vector_norm(
                opt["m"][k].double() / (1 - b1))) for k in master}
        del leaves, tree, grads
    delta = {k: float(torch.linalg.vector_norm(
        opt["master"][k].double() - w0[k].to(device).double()))
        for k in master}
    return {"loss": losses, "grad": first, "delta": delta}
