"""DP-parallel checkpoint read/write planning (paper §4.2; DESIGN.md
§5 for write plans and volume striping, §7 for read plans).

The serialized checkpoint byte stream is partitioned at BYTE granularity
(imbalance ≤ 1 byte) across a selected subset of DP ranks. The plan is
computed once at training-setup time, so checkpoint creation needs no
communication. Writer-subset selection:

  * ``replica`` — every DP rank writes (paper Fig. 6b),
  * ``socket``  — a fixed number of writers per node, maximizing I/O-path
    utilization while bounding contention (paper Fig. 6c; their DGX-2
    sweet spot was one writer per CPU socket),
  * ``auto``    — pick the subset the bandwidth model predicts fastest.

The RESTORE side mirrors it: :func:`make_read_plan` maps each reader
rank to the exact ``[shard, offset, length]`` spans it owns — balanced
byte-striping by default, or explicit per-tensor ownership (e.g. the
ZeRO-1 projection from ``repro.sharding.specs.zero1_ownership``) — the
paper's load-then-allgather, fixed before the first restore touches a
disk.

Write plans are additionally VOLUME-HEALTH aware: :func:`probe_volumes`
drops failed (unwritable/missing) and full volumes from the stripe set
at plan time, and the plan records the degraded set so the manifest
carries an audit trail of where the bytes could not go.
"""
from __future__ import annotations

import math
import os
import warnings
from bisect import bisect_right
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class Topology:
    """The DP group and its I/O hardware layout."""
    dp_degree: int
    ranks_per_node: int = 8
    node_write_gbps: float = 24.8      # DGX-2 RAID-0 peak (paper §5.2.1)
    rank_stage_gbps: float = 12.0      # device→host per rank (PCIe-ish)
    per_write_seconds: float = 2e-4    # fixed submission overhead

    @property
    def n_nodes(self) -> int:
        return max(1, math.ceil(self.dp_degree / self.ranks_per_node))

    def node_of(self, rank: int) -> int:
        return rank // self.ranks_per_node


@dataclass(frozen=True)
class Extent:
    rank: int
    offset: int
    length: int
    shard_index: int       # position among the participating writers
    volume: int = 0        # destination volume (index into the engine's
    #                        volume roots — the paper's per-node SSDs)


@dataclass(frozen=True)
class WritePlan:
    total_bytes: int
    extents: List[Extent]
    strategy: str
    n_volumes: int = 1
    #: volume indices dropped by the plan-time health probe (failed or
    #: full volumes — their shards were re-striped onto the survivors)
    degraded: Tuple[int, ...] = ()

    @property
    def writers(self) -> List[int]:
        return [e.rank for e in self.extents]

    @cached_property
    def _by_rank(self) -> Dict[int, Extent]:
        # cached rank→extent mapping: extent_of is on the per-iteration
        # save path, so an O(n) scan per writer is O(n²) per checkpoint
        return {e.rank: e for e in self.extents}

    def extent_of(self, rank: int) -> Optional[Extent]:
        return self._by_rank.get(rank)

    def validate(self):
        """Invariants: extents sorted by offset AND shard_index, disjoint,
        cover [0,total) exactly, balance ≤ 1B, volumes in range."""
        pos = 0
        for i, e in enumerate(self.extents):
            assert e.shard_index == i, \
                f"shard_index {e.shard_index} != position {i}"
            assert e.length >= 0, f"negative extent length {e.length}"
            assert e.offset == pos, \
                f"extents not sorted/disjoint: gap or overlap at byte " \
                f"{pos} (extent {i} starts at {e.offset})"
            pos += e.length
            assert 0 <= e.volume < max(self.n_volumes, 1), \
                f"extent {i} targets volume {e.volume} of {self.n_volumes}"
            assert e.volume not in self.degraded, \
                f"extent {i} targets degraded volume {e.volume}"
        assert pos == self.total_bytes, \
            f"stream not fully covered: {pos} != {self.total_bytes}"
        lengths = [e.length for e in self.extents]
        if lengths:
            assert max(lengths) - min(lengths) <= 1, "imbalance > 1 byte"
        assert len({e.rank for e in self.extents}) == len(self.extents), \
            "duplicate writer rank"


def select_writers(topo: Topology, strategy: str = "replica",
                   writers_per_node: int = 2,
                   total_bytes: Optional[int] = None) -> List[int]:
    """Choose which DP ranks write (paper §4.2 'Hardware efficiency').

    The subset always SPANS ALL NODES (the paper rejects same-node
    subsets: they under-utilize the other nodes' SSDs)."""
    if strategy == "replica":
        return list(range(topo.dp_degree))
    if strategy == "socket":
        out = []
        for node in range(topo.n_nodes):
            base = node * topo.ranks_per_node
            n_here = min(topo.ranks_per_node, topo.dp_degree - base)
            for w in range(min(writers_per_node, n_here)):
                # spread writers across the node's ranks (one per socket)
                out.append(base + w * max(1, n_here // max(writers_per_node, 1)))
        return sorted(set(out))
    if strategy == "auto":
        assert total_bytes is not None
        best, best_t = None, float("inf")
        for cand_name, cand in [
                ("replica", select_writers(topo, "replica")),
                *[(f"socket{w}", select_writers(topo, "socket", w))
                  for w in (1, 2, 4)]]:
            t = predict_write_seconds(topo, total_bytes, cand)
            if t < best_t:
                best, best_t = cand, t
        return best
    raise ValueError(f"unknown strategy {strategy!r}")


def predict_write_seconds(topo: Topology, total_bytes: int,
                          writers: Sequence[int]) -> float:
    """Analytic §4.2 model: per-node SSD bandwidth is shared by that
    node's writers; per-writer efficiency decays with contention and
    small writes. Used by strategy='auto' and the Fig. 12 projection."""
    if not writers:
        return float("inf")
    per = total_bytes / len(writers)
    node_load = {}
    for r in writers:
        node_load[topo.node_of(r)] = node_load.get(topo.node_of(r), 0) + 1
    worst = 0.0
    for node, k in node_load.items():
        bw_node = topo.node_write_gbps * 1e9
        # contention: k concurrent writers share the RAID with ~7%/writer
        # efficiency loss beyond the second (fit to paper Fig. 8 shape)
        eff = 1.0 / (1.0 + 0.07 * max(0, k - 2))
        stage = per / (topo.rank_stage_gbps * 1e9)        # device→host
        disk = per * k / (bw_node * eff)
        t = max(disk, stage) + topo.per_write_seconds
        worst = max(worst, t)
    return worst


# ------------------------------------------------------- volume health
def _volume_free_bytes(path: str) -> Optional[int]:
    """Free bytes on the filesystem holding ``path``; None = unknown
    (statvfs unavailable or a pseudo-fs reporting zero capacity)."""
    try:
        st = os.statvfs(path)
    except (OSError, AttributeError):
        return None
    if st.f_blocks == 0:          # proc/overlay oddities: don't guess
        return None
    return st.f_bavail * st.f_frsize


def probe_volumes(paths: Sequence[str], total_bytes: int = 0,
                  min_free_bytes: int = 0, create: bool = False,
                  n_shards: Optional[int] = None
                  ) -> Tuple[List[int], List[int]]:
    """Health-check candidate volume destinations at plan time.

    Returns ``(healthy, degraded)`` index lists. A volume is degraded
    when its path is missing/not-a-directory/uncreatable (failed
    volume) or its filesystem's free space cannot hold this volume's
    share of the stripe plus ``min_free_bytes`` (full volume). The
    per-volume share is computed from the round-robin shard assignment
    when ``n_shards`` is given — ``ceil(n_shards / k)`` shards of
    ``ceil(total / n_shards)`` bytes each, NOT ``total / k``: with 3
    shards on 2 volumes one volume really receives ~2/3 of the bytes.
    The capacity check iterates to a fixed point: dropping a full
    volume raises the per-survivor share, which may drop another.

    ``create=True`` attempts a (single-level) mkdir first — the probe
    form used on per-save staging directories, where an uncreatable
    dir IS the failure signal."""
    healthy, degraded = [], []
    for i, p in enumerate(paths):
        if create and not os.path.isdir(p):
            try:
                # deliberately mkdir, NOT makedirs: a missing parent
                # (unmounted/removed volume root) must read as failure,
                # not be silently recreated on the primary filesystem
                os.mkdir(p)
            except OSError:
                degraded.append(i)
                continue
        if not os.path.isdir(p) or not os.access(p, os.W_OK | os.X_OK):
            degraded.append(i)
            continue
        healthy.append(i)
    # capacity fixed point over the survivors
    while healthy:
        k = len(healthy)
        if n_shards and total_bytes:
            shard_bytes = -(-total_bytes // n_shards)
            need = -(-n_shards // k) * shard_bytes
        else:
            need = -(-total_bytes // k)
        need += max(0, min_free_bytes)
        full = []
        for i in healthy:
            free = _volume_free_bytes(paths[i])
            if free is not None and free < need:
                full.append(i)
        if not full:
            break
        # drop only the fullest volume per round: the share each
        # survivor must absorb grows as volumes drop, so eliminating
        # all of them at once over-evicts
        worst = min(full, key=lambda i: _volume_free_bytes(paths[i]) or 0)
        healthy.remove(worst)
        degraded.append(worst)
    return healthy, sorted(degraded)


def make_plan(total_bytes: int, topo: Topology, strategy: str = "replica",
              writers_per_node: int = 2, n_volumes: int = 1,
              volume_roots: Optional[Sequence[str]] = None,
              healthy_volumes: Optional[Sequence[int]] = None,
              min_free_bytes: int = 0,
              min_extent_bytes: int = 0) -> WritePlan:
    """Byte-granularity balanced partition over the selected writers.

    ``n_volumes`` stripes the shards round-robin across that many
    destination volumes (directory roots standing in for the paper's
    per-node SSDs), so concurrent writers drive distinct devices instead
    of contending on one filesystem.

    Volume health: pass ``volume_roots`` to probe each destination
    (writable + sufficient free space) here at plan time, or
    ``healthy_volumes`` (surviving ORIGINAL indices) when the caller
    probed already. Failed/full volumes are excluded from the stripe —
    their shards land on the survivors — and recorded in
    ``plan.degraded``; when nothing survives the probe, the plan falls
    back to the full volume set (the write will then fail loudly at
    the filesystem, which beats silently writing nowhere).

    Args:
        total_bytes: length of the serialized checkpoint stream.
        topo: the DP group + I/O hardware layout.
        strategy: writer-subset selection — ``"replica"`` (every DP
            rank), ``"socket"`` (``writers_per_node`` per node), or
            ``"auto"`` (bandwidth-model pick).
        writers_per_node: writer count per node for ``"socket"``.
        n_volumes: stripe the shards round-robin over this many
            destination volumes (ignored when ``volume_roots`` given).
        volume_roots: probe these destinations at plan time.
        healthy_volumes: pre-probed surviving volume indices.
        min_free_bytes: extra free-space headroom the probe demands.
        min_extent_bytes: trim the writer subset until every extent is
            at least this long (tiny streams shattered across every DP
            writer would pay one submission + fsync + shard file per
            writer for KB-sized extents). 0 keeps the full subset; at
            least one writer always survives. Delta generations no
            longer use this — their stripe-vs-single-stream choice is
            the binary :func:`delta_stripe_plan` cutoff.

    Returns:
        a :class:`WritePlan` — one :class:`Extent` per writer with its
        ``(rank, offset, length, shard_index, volume)``, plus the
        recorded ``degraded`` volume set.
    """
    writers = select_writers(topo, strategy, writers_per_node, total_bytes)
    if min_extent_bytes > 0:
        cap = max(1, total_bytes // min_extent_bytes)
        if cap < len(writers):
            writers = writers[:cap]
    n = len(writers)
    if volume_roots is not None and healthy_volumes is None:
        n_volumes = len(volume_roots)
        healthy_volumes, _deg = probe_volumes(
            volume_roots, total_bytes, min_free_bytes, n_shards=n)
    n_volumes = max(1, n_volumes)
    if healthy_volumes is None:
        healthy = list(range(n_volumes))
    else:
        healthy = [v for v in healthy_volumes if 0 <= v < n_volumes]
    degraded = tuple(v for v in range(n_volumes) if v not in set(healthy))
    if not healthy:               # nowhere healthy: keep the original
        healthy, degraded = list(range(n_volumes)), ()
    if degraded:
        warnings.warn(
            f"checkpoint stripe degraded: volumes {list(degraded)} failed "
            f"the plan-time health probe; striping {total_bytes} bytes "
            f"across volumes {healthy} instead", stacklevel=2)
    # the §7 stripe_ranges carve — the same ≤1-byte-imbalance rule the
    # read plans and parallel ranged hydration use, so every layer
    # (write, restore, delta stripe tables) agrees on byte geometry
    extents = [Extent(rank=rank, offset=lo, length=hi - lo, shard_index=i,
                      volume=healthy[i % len(healthy)])
               for i, (rank, (lo, hi))
               in enumerate(zip(writers, stripe_ranges(total_bytes, n)))]
    plan = WritePlan(total_bytes, extents, strategy, n_volumes=n_volumes,
                     degraded=degraded)
    plan.validate()
    return plan


def delta_stripe_plan(packed_bytes: int, topo: Topology,
                      strategy: str = "replica", writers_per_node: int = 2,
                      n_volumes: int = 1,
                      healthy_volumes: Optional[Sequence[int]] = None,
                      stripe_min_bytes: int = 0) -> WritePlan:
    """Write plan for a delta generation's PACKED span stream
    (DESIGN.md §13).

    At or above ``stripe_min_bytes`` the packed stream is carved
    exactly like a full keyframe — the full writer subset, balanced
    ``stripe_ranges`` extents, round-robin across the healthy volumes —
    so frequent incremental saves keep the paper's §4.2 write fan-out.
    Below the cutoff (``FastPersistConfig.delta_stripe_min_mb``) the
    delta SINGLE-STREAMS: one writer, one primary-resident shard — a
    KB-scale payload must not pay a submission + fsync + shard file
    per writer and volume. ``stripe_min_bytes=0`` stripes every delta."""
    if stripe_min_bytes > 0 and packed_bytes < stripe_min_bytes:
        writers = select_writers(topo, strategy, writers_per_node,
                                 packed_bytes)
        plan = WritePlan(packed_bytes,
                         [Extent(rank=writers[0], offset=0,
                                 length=packed_bytes, shard_index=0)],
                         strategy, n_volumes=1)
        plan.validate()
        return plan
    return make_plan(packed_bytes, topo, strategy, writers_per_node,
                     n_volumes=n_volumes, healthy_volumes=healthy_volumes)


# =========================================================== read plans
@dataclass(frozen=True)
class ReadSpan:
    """One reader's claim on one contiguous byte range of one shard."""
    reader: int
    shard_index: int
    shard_offset: int      # byte offset INSIDE the shard file
    length: int
    stream_offset: int     # where these bytes sit in the full stream
    volume: int = 0        # the shard's destination volume (from the
    #                        saved plan — tells the reader where to look)


@dataclass(frozen=True)
class ReadPlan:
    """The restore-side twin of :class:`WritePlan` (paper §4.2's
    load-then-allgather): each reader rank owns exact ``[shard, offset,
    length]`` spans, fixed before any disk is touched, so the parallel
    load needs no coordination beyond the final reassembly."""
    total_bytes: int
    n_readers: int
    spans: Tuple[ReadSpan, ...]      # sorted by (reader, stream_offset)
    source: str = "stripe"           # "stripe" | "ownership"
    #: stream bytes claimed by ALL readers together; == total_bytes for
    #: a full-coverage plan (partial ownership dicts may cover less)
    covered_bytes: int = 0

    @cached_property
    def _by_reader(self) -> Dict[int, List[ReadSpan]]:
        out: Dict[int, List[ReadSpan]] = {r: [] for r in range(self.n_readers)}
        for s in self.spans:
            out.setdefault(s.reader, []).append(s)
        return out

    def spans_of(self, reader: int) -> List[ReadSpan]:
        return self._by_reader.get(reader, [])

    @property
    def readers(self) -> List[int]:
        return sorted(self._by_reader)

    def bytes_of(self, reader: int) -> int:
        return sum(s.length for s in self.spans_of(reader))

    def validate(self, extents: Optional[Sequence[dict]] = None,
                 require_full: bool = True):
        """Invariants: spans stream-disjoint, non-negative, inside their
        shard (when ``extents`` — saved-plan extent dicts — are given),
        total coverage == ``covered_bytes`` (== ``total_bytes`` for
        ``require_full``), and stripe plans balanced to ≤ 1 byte."""
        by_stream = sorted(self.spans, key=lambda s: s.stream_offset)
        pos, covered = None, 0
        for s in by_stream:
            assert s.length >= 0, f"negative span length {s.length}"
            assert 0 <= s.reader < self.n_readers, f"bad reader {s.reader}"
            if pos is not None:
                assert s.stream_offset >= pos, \
                    f"overlapping spans at stream byte {s.stream_offset}"
            pos = s.stream_offset + s.length
            covered += s.length
        assert covered == self.covered_bytes, \
            f"covered {covered} != recorded {self.covered_bytes}"
        if require_full:
            assert covered == self.total_bytes, \
                f"plan covers {covered} of {self.total_bytes} bytes"
        if extents is not None:
            by_shard = {int(e["shard_index"]): e for e in extents}
            for s in self.spans:
                e = by_shard[s.shard_index]
                assert 0 <= s.shard_offset and \
                    s.shard_offset + s.length <= int(e["length"]), \
                    f"span {s} outside shard {s.shard_index}"
                assert s.stream_offset == \
                    int(e["offset"]) + s.shard_offset, \
                    f"span {s} stream/shard offsets disagree"
        if self.source == "stripe" and self.n_readers > 0:
            loads = [self.bytes_of(r) for r in range(self.n_readers)]
            assert max(loads) - min(loads) <= 1, "reader imbalance > 1B"


def stripe_ranges(total: int, n: int) -> List[Tuple[int, int]]:
    """Balanced byte-striping of ``[0, total)`` into ``n`` contiguous
    ``(lo, hi)`` ranges with at most 1 byte of imbalance — the single
    carving rule shared by the write plan, :func:`make_read_plan`, and
    the remote tier's parallel ranged hydration
    (:mod:`repro_torch.core.serve`), so every layer agrees on byte geometry."""
    assert n >= 1, "need at least one range"
    base, rem = divmod(max(total, 0), n)
    out, lo = [], 0
    for r in range(n):
        ln = base + (1 if r < rem else 0)
        out.append((lo, lo + ln))
        lo += ln
    return out


def _plan_extents(saved_plan) -> List[dict]:
    """Normalize a saved plan (WritePlan or the manifest's plan dict)
    to extent dicts sorted by stream offset. Layout-v1 extents carry no
    ``volume`` key — default 0 (the primary directory)."""
    if isinstance(saved_plan, WritePlan):
        exts = [vars(e).copy() for e in saved_plan.extents]
    else:
        exts = [dict(e) for e in saved_plan["extents"]]
    for e in exts:
        e.setdefault("volume", 0)
    return sorted(exts, key=lambda e: int(e["offset"]))


def _stream_range_spans(exts: List[dict], ends: List[int], reader: int,
                        lo: int, hi: int) -> Iterable[ReadSpan]:
    """Map one stream byte-range to shard spans — the same bisect walk
    as ``serializer.tensor_spans`` (extents are disjoint and offset-
    sorted, so their ends are monotonic)."""
    i = bisect_right(ends, lo)
    while i < len(exts) and int(exts[i]["offset"]) < hi:
        e = exts[i]
        e_off, e_len = int(e["offset"]), int(e["length"])
        if e_off + e_len > lo:
            s, t = max(lo, e_off), min(hi, e_off + e_len)
            if t > s:
                yield ReadSpan(reader=reader,
                               shard_index=int(e["shard_index"]),
                               shard_offset=s - e_off, length=t - s,
                               stream_offset=s,
                               volume=int(e.get("volume", 0)))
        i += 1


def _tensor_range_spans(by_shard: Dict[int, dict], index_spans,
                        reader: int, t_lo: int, t_hi: int
                        ) -> Iterable[ReadSpan]:
    """Carve a TENSOR-relative byte range out of the tensor's global-
    index spans (``[shard, offset_in_shard, length]``, stream-ordered):
    this walks the index instead of the raw extents, so ownership plans
    and ``load_tensor`` agree on byte geometry by construction."""
    t_pos = 0
    for shard, off, ln in index_spans:
        s, t = max(t_lo, t_pos), min(t_hi, t_pos + ln)
        if t > s:
            e = by_shard[int(shard)]
            sh_off = int(off) + (s - t_pos)
            yield ReadSpan(reader=reader, shard_index=int(shard),
                           shard_offset=sh_off, length=t - s,
                           stream_offset=int(e["offset"]) + sh_off,
                           volume=int(e.get("volume", 0)))
        t_pos += ln
        if t_pos >= t_hi:
            break


def make_read_plan(saved_plan, index: Optional[dict], n_readers: int,
                   ownership: Optional[dict] = None) -> ReadPlan:
    """Build the restore plan for ``n_readers`` against a checkpoint's
    SAVED write plan (rank-elastic: the reader count never has to match
    the writer count).

    * ``ownership=None`` — balanced byte-striping: the stream is split
      into ``n_readers`` contiguous ranges (imbalance ≤ 1 byte, the
      write-side rule mirrored), each mapped to shard spans.
    * ``ownership={name: reader}`` or ``{name: [(reader, lo, hi), ...]}``
      — per-tensor ownership (``lo``/``hi`` tensor-relative byte
      offsets), e.g. the ZeRO-1 projection from
      ``repro.sharding.specs.zero1_ownership``: each DP rank reads
      exactly the optimizer/parameter bytes it owns. Requires ``index``
      (the manifest's global tensor → span index; layout-v1 checkpoints
      have none — use striping); tensors ABSENT from the dict are
      balanced-striped across all readers so the plan still covers the
      full stream.

    Args:
        saved_plan: the manifest's SAVED write plan (``meta["plan"]``
            dict or a :class:`WritePlan`).
        index: the manifest's global tensor → ``[shard, offset,
            length]`` span index (required for ownership plans).
        n_readers: reader ranks to carve the stream across.
        ownership: None for balanced striping, or a per-tensor
            ownership dict as described above.

    Returns:
        a :class:`ReadPlan` whose :class:`ReadSpan`s are sorted by
        ``(reader, stream_offset)``; ``spans_of(rank)`` gives one
        rank's reads, ``covered_bytes`` what the union claims.
    """
    assert n_readers >= 1, "need at least one reader"
    exts = _plan_extents(saved_plan)
    ends = [int(e["offset"]) + int(e["length"]) for e in exts]
    total = ends[-1] if ends else 0
    spans: List[ReadSpan] = []

    if ownership is None:
        for r, (lo, hi) in enumerate(stripe_ranges(total, n_readers)):
            spans.extend(_stream_range_spans(exts, ends, r, lo, hi))
        plan = ReadPlan(total, n_readers, tuple(
            sorted(spans, key=lambda s: (s.reader, s.stream_offset))),
            source="stripe", covered_bytes=total)
        plan.validate(exts)
        return plan

    if index is None:
        raise ValueError("ownership-based read plans need the manifest's "
                         "global index (layout-v1 checkpoints have none "
                         "— use striping)")
    unknown = set(ownership) - set(index)
    if unknown:
        # a typo'd/renamed tensor would otherwise silently degrade to
        # byte-striping — rank r would NOT read the rows it believes
        # it owns, and the plan would still validate
        raise KeyError(f"ownership names tensors absent from the "
                       f"checkpoint index: {sorted(unknown)}")
    by_shard = {int(e["shard_index"]): e for e in exts}
    for name, index_spans in index.items():
        own = ownership.get(name)
        nbytes = sum(int(s[2]) for s in index_spans)
        if own is None:
            # tensors nobody claimed: balanced striping so coverage
            # stays full and the allgather needs no special cases
            for r, (lo, hi) in enumerate(stripe_ranges(nbytes, n_readers)):
                spans.extend(_tensor_range_spans(by_shard, index_spans,
                                                 r, lo, hi))
            continue
        ranges = ([(int(own), 0, nbytes)] if isinstance(own, int)
                  else [(int(r), int(a), int(b)) for r, a, b in own])
        for reader, t_lo, t_hi in ranges:
            spans.extend(_tensor_range_spans(by_shard, index_spans,
                                             reader, t_lo,
                                             min(t_hi, nbytes)))
    covered = sum(s.length for s in spans)
    plan = ReadPlan(total, n_readers, tuple(
        sorted(spans, key=lambda s: (s.reader, s.stream_offset))),
        source="ownership", covered_bytes=covered)
    plan.validate(exts, require_full=(covered == total))
    return plan
