"""Model FLOPs of one training step of a configuration's share: what the
forward and backward passes need, with nothing recomputed and causal
attention counted over the pairs it keeps. Each family counts its own
(``bench/families/<family>.py``)."""
from __future__ import annotations

from bench import common


def train_flops_per_step(cfg: dict, rows: int) -> int:
    """Forward and backward of ``rows`` sequences, as the configuration's
    family counts them."""
    return common.family(cfg).train_flops_per_step(cfg, rows)


def peak(device_name: str, key: str = "bf16_flops_per_s"):
    """The published peak of a device by its ``torch.cuda`` name, or None
    for a device the table does not hold."""
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")) as f:
        return json.load(f).get(device_name, {}).get(key)
