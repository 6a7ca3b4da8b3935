"""ZeRO-1 ownership of a checkpoint's byte stream, for the owned-span
restore (DESIGN.md §7). A copy of ``repro.sharding.specs.zero1_ownership``:
pure byte math over manifest records, so both packages hand each reader
rank the same spans."""
from __future__ import annotations


def zero1_ownership(records, n_readers: int) -> dict:
    """Project ZeRO-1 ownership onto the checkpoint BYTE stream for the
    parallel restore path (``partition.make_read_plan``): map each
    manifest record to the tensor-relative byte ranges each DP reader
    rank owns, ``{name: [(reader, lo, hi), ...]}``.

    Mirrors the reference's ``zero1_specs`` rule in the only form that stays
    byte-contiguous on disk: a leaf whose LEADING dim divides by
    ``n_readers`` is split into row blocks (contiguous bytes in C
    order — rank *r* reads exactly its optimizer-state shard); any
    other leaf falls back to balanced byte striping, so the union of
    all ranks' spans always covers every tensor exactly once (the
    load-then-allgather invariant). ``records`` are manifest
    ``TensorRecord``s — their ``shape``/``nbytes`` describe the
    ON-STREAM layout, which is what restore reads."""
    own = {}
    for rec in records:
        n = rec.nbytes
        if n == 0:
            own[rec.name] = []
            continue
        rows = rec.shape[0] if rec.shape else 0
        if rows and rows % n_readers == 0 and n % rows == 0:
            row_bytes = n // rows
            blk = (rows // n_readers) * row_bytes
            own[rec.name] = [(r, r * blk, (r + 1) * blk)
                             for r in range(n_readers)]
        else:
            base, rem = divmod(n, n_readers)
            ranges, lo = [], 0
            for r in range(n_readers):
                ln = base + (1 if r < rem else 0)
                if ln:
                    ranges.append((r, lo, lo + ln))
                lo += ln
            own[rec.name] = ranges
    return own
