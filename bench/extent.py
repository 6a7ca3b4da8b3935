"""One data-parallel rank's part of a save: the extent of the checkpoint
stream that rank ``r`` of ``D`` writes when the ``D`` ranks of a DP group
share one save, each a disjoint stretch of the same stream.

A traffic mix asks for it with ``"rank": r``; ``D`` is the configuration's
``assumed.data_parallel``. The carve is the program's balanced byte stripe
(``repro_torch.core.partition.stripe_ranges``), copied here so that the
check does not take it from the program. The run hands the program's
engine the rank's part of the training state, as a sharded-state rank
hands its checkpointer its local flat shard: one byte view of each state
record that the extent overlaps, in stream order (``share``); the engine
snapshots, writes and commits that part alone."""
from __future__ import annotations

from typing import List, Optional, Tuple


def stripe_ranges(total: int, n: int) -> List[Tuple[int, int]]:
    """``[0, total)`` cut into ``n`` contiguous ``(lo, hi)`` ranges, the
    first ``total % n`` of them one byte longer."""
    base, rem = divmod(total, n)
    out, lo = [], 0
    for r in range(n):
        hi = lo + base + (r < rem)
        out.append((lo, hi))
        lo = hi
    return out


def rank_of(cfg: dict, params: dict) -> Optional[Tuple[int, int]]:
    """``(rank, D)`` of a mix that saves one rank's extent, else None."""
    if params.get("rank") is None:
        return None
    dp = int(cfg["assumed"]["data_parallel"])
    rank = int(params["rank"])
    if not 0 <= rank < dp:
        raise ValueError(f"rank {rank} is not one of {dp} DP ranks")
    return rank, dp


def save_bytes(state_bytes: int, cfg: dict, params: dict) -> int:
    """Stream bytes one save of the mix writes: the whole state, or the
    largest extent of the rank's plan."""
    r = rank_of(cfg, params)
    return state_bytes if r is None else -(-state_bytes // r[1])


def pieces(named, lo: int, hi: int) -> List[Tuple[str, object, int, int]]:
    """``[(name, tensor, a, b)]``: bytes ``[a, b)`` of each tensor of
    ``named`` (``[(name, tensor)]`` in stream order) that lie in stream
    bytes ``[lo, hi)``."""
    out, off = [], 0
    for name, t in named:
        n = t.numel() * t.element_size()
        a, b = max(lo, off) - off, min(hi, off + n) - off
        if b > a:
            out.append((name, t, a, b))
        off += n
    return out


def stream_size(named) -> int:
    return sum(t.numel() * t.element_size() for _, t in named)


def byte_view(t, a: int, b: int):
    """Bytes ``[a, b)`` of a contiguous tensor, as a uint8 view."""
    import torch
    return t.detach().reshape(-1).view(torch.uint8)[a:b]


def share(state, lo: int, hi: int) -> dict:
    """The rank's part of ``state``: ``{index: {record: uint8 view}}``,
    whose flatten order (keys sorted) is stream order, each piece named
    ``<index>/<record>`` in the manifest."""
    from repro_torch.tree import flatten
    return {f"{i:04d}": {name: byte_view(t, a, b)}
            for i, (name, t, a, b) in enumerate(
                pieces(flatten(state), lo, hi))}


def flat(state, lo: int, hi: int):
    """A copy of stream bytes ``[lo, hi)`` of ``state``, as one uint8
    tensor: what the check holds a rank's part against. It is cut by
    ``pieces`` alone, so that a fault in ``share`` shows as other bytes."""
    import torch
    from repro_torch.tree import flatten
    views = [byte_view(t, a, b) for _, t, a, b in pieces(flatten(state),
                                                         lo, hi)]
    return torch.cat(views) if views else torch.empty(0, dtype=torch.uint8)
