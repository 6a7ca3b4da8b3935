"""FastPersist checkpointer: NVMe write path × DP-parallel writers.

Layout of a checkpoint directory (sharded multi-volume mode, the
paper's layout — each writer streams its byte extent to its own
destination volume, DESIGN.md §5):

    <primary>/ckpt_00000042/
      manifest.json      tensor metadata + extras + write plan + global
                         index (tensor → [shard, offset, length] spans)
      shard_000.bin      shards whose extent maps to the primary volume
    <volume1>/ckpt_00000042.shards-<nonce>/
      shard_001.bin      shards striped onto other volumes
      ...

Loading (paper §4.2): each rank reads its own shard then the DP group
allgathers. ``load`` is RANK-ELASTIC either way: the manifest's saved
plan (not the loader's topology) drives reassembly, so K shards restore
onto any reader configuration. Two restore modes:

  * ``load(step)`` — the legacy single-reader path: shards are read
    whole, sequentially, into a fresh bytearray;
  * ``load(step, read_plan=N)`` — the parallel pipeline: N reader
    workers each read ONLY their owned ``[shard, offset, length]``
    spans (``partition.make_read_plan``) through the async read
    backends into one shared page-aligned arena buffer — the single-
    host stand-in for the paper's allgather is that shared buffer —
    with per-span CRCs folded hot and combined into shard CRCs for
    verification (no second sweep).

A copy of ``repro.core.checkpointer`` on torch tensors: the on-disk
format is the reference's byte for byte. Quantized saves (``quantize``,
int8 per-block, lossy) quantize state on the card with the
``ckpt_quant`` CUDA kernel before the snapshot, which then moves only
the int8 values and the scales; a restore onto the card dequantizes
there (``load(device=...)``). ``read_owned`` (one rank's
owned spans, DESIGN.md §7) and :func:`allgather_owned` read the same
bytes as the reference's.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from itertools import groupby
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import layout, quant
from repro_torch.core.arena import SerializeArena
from repro_torch.core.delta import (DeltaPlan, apply_delta,
                                    assign_span_shards, build_delta)
from repro_torch.core.partition import (ReadPlan, ReadSpan, Topology,
                                        WritePlan, delta_stripe_plan,
                                        make_plan, make_read_plan,
                                        probe_volumes, select_writers)
from repro_torch.core.reader import combine_span_crcs, read_stream
from repro_torch.core.serializer import (ByteStreamView, Manifest,
                                         TensorRecord, begin_snapshot,
                                         decode_record, deserialize,
                                         serialize, serialize_leaves,
                                         tensor_spans)
from repro_torch.core.writer import WriteStats, WriterConfig, write_stream
from repro_torch.tree import flatten, treedef_str, unflatten


class _GatedSegments:
    """One extent's stream slices, gated on the snapshot watermark
    (DESIGN.md §10): each piece is yielded as soon as the fill worker
    has staged its bytes, so writers submit chunk N while chunk N+1 is
    still crossing from the device. The iterator never waits while ANY
    covered bytes remain unyielded (it hands over exactly what the
    watermark covers), and ``would_block()`` tells ``write_stream``
    whether pulling the next piece would stall — the writer then
    flushes its partially-filled staging buffer instead of idling
    behind the gate. A fill failure re-raises inside every waiting
    writer — a save with a torn snapshot can never reach COMMIT. The
    summed stall inside the gate lands in
    ``WriteStats.source_wait_seconds``."""

    def __init__(self, view: ByteStreamView, offset: int, length: int,
                 progress):
        self._view = view
        self._offset = offset
        self._length = length
        self._progress = progress
        self._cursor = offset          # stream offset of the next byte
        self.wait_seconds = 0.0

    def would_block(self):
        """True iff the next ``__iter__`` piece would wait on the
        watermark (no new bytes landed, fill still in flight)."""
        p = self._progress
        return (self._cursor < self._offset + self._length
                and p.filled <= self._cursor and not p.failed
                and not p.done)

    def __iter__(self):
        for seg in self._view.slices(self._offset, self._length):
            n = len(seg)
            done = 0
            while done < n:
                avail = self._progress.filled - self._cursor
                if avail <= 0 or self._progress.failed:
                    t0 = time.perf_counter()
                    self._progress.wait_until(self._cursor + 1)
                    self.wait_seconds += time.perf_counter() - t0
                    avail = self._progress.filled - self._cursor
                take = min(n - done, avail)
                # cursor moves BEFORE the yield: the consumer only asks
                # would_block() after it has copied this piece out, and
                # by then these bytes are spoken for
                self._cursor += take
                yield seg[done:done + take]
                done += take


#: dirty-compare granularity in bytes (delta spans coalesce to
#: multiples of this)
DIRTY_BLOCK = 4096


@dataclass
class FastPersistConfig:
    strategy: str = "auto"             # replica | socket (2 a node) | auto
    #: ``writer.checksum``: CRC32 per extent, verified on load; the CRCs
    #: accumulate during the writers' fill phase (writer.py single-pass
    #: integrity) — no second sweep over the stream happens in save()
    writer: WriterConfig = field(default_factory=WriterConfig)
    topology: Topology = field(default_factory=lambda: Topology(dp_degree=1))
    quantize: bool = False             # int8 per-block (beyond-paper, lossy)
    #: incremental delta checkpoints (DESIGN.md §9): every Nth save is
    #: a full KEYFRAME through the normal path, and the saves in
    #: between write only the byte spans that changed since the
    #: previous save (layout-v3 delta generations chained by
    #: generation nonce). 1 = every save is full (deltas off). The
    #: arena holds the previous image the dirty compare runs against;
    #: incompatible with ``quantize`` — those saves silently stay full.
    keyframe_every: int = 1
    #: int8-quantize delta spans before they hit disk (lossy; blockwise
    #: absmax scales, DESIGN.md §9) — keyframes stay full-precision
    delta_quantize: bool = False
    #: striped delta generations (DESIGN.md §13): a delta whose PACKED
    #: payload is at least this many MiB is carved across the full
    #: writer/volume fan-out exactly like a keyframe (per-shard span
    #: table, per-volume publish, one global COMMIT); smaller deltas
    #: single-stream into one primary-resident shard so tiny writes
    #: don't pay a submission + fsync + shard file per writer and
    #: volume. 0 stripes every delta.
    delta_stripe_min_mb: int = 8
    #: chunked device→arena snapshots (DESIGN.md §10): the copy runs on
    #: a snapshot worker in chunks of this many MiB, and writers consume
    #: each chunk as it lands — the first NVMe submission no longer
    #: waits for the last tensor to leave the device, and with an async
    #: engine the WRITE overlaps the next train step (the step only
    #: waits for the snapshot, ``wait_snapshot``). 0 = the old
    #: monolithic copy. Quantized saves stay monolithic (the quantizer
    #: reads the whole stream).
    snapshot_chunk_mb: int = 8
    #: device-side dirty masks (DESIGN.md §10): keep a packed previous
    #: image of every float record RESIDENT ON DEVICE and let the
    #: ckpt_pack_dirty CUDA kernel decide per block what changed —
    #: only dirty blocks (plus a tiny mask) cross PCIe, for full saves
    #: and deltas alike (Check-N-Run's bandwidth win at the PCIe hop,
    #: not just on disk). Opt-in: costs a device-memory copy of the
    #: float state. Non-float records and invalid baselines fall back
    #: to the host copy+compare, which stays the verification oracle.
    device_dirty: bool = False


@dataclass
class SaveStats:
    """Unified per-save statistics. Every engine backend returns this
    shape from ``SaveHandle.result()`` (baseline fills the writer fields
    with its single logical writer)."""
    total_bytes: int
    seconds: float                     # wall time of the persist phase
    serialize_seconds: float
    per_writer: List[WriteStats]
    n_writers: int
    backend: str = ""                  # set by CheckpointEngine
    step: int = -1                     # set by CheckpointEngine
    #: the payloads' fsync, the COMMIT marker and the atomic publish:
    #: the sum of the save's ``commit.*`` spans (set by CheckpointEngine)
    commit_seconds: float = 0.0
    #: the ``commit.fsync`` span: the payloads' fsync, part of
    #: ``commit_seconds`` (set by CheckpointEngine)
    fsync_seconds: float = 0.0
    #: per-shard-file descriptors {name, volume, size, crc32} — the
    #: engine folds these into the global COMMIT marker
    shards: List[dict] = field(default_factory=list)
    #: True when serialization refilled a cached staging arena in place
    #: (steady-state zero-allocation save); False on first save or shape
    #: change
    arena_reused: bool = False
    #: this save's random generation nonce — the engine stamps it into
    #: the COMMIT marker; a later delta's chain validity hangs off it
    generation: str = ""
    #: delta-save descriptor (None for full/keyframe saves): the full
    #: :meth:`repro_torch.core.delta.DeltaPlan.to_meta` dict plus "n_spans" —
    #: the engine stamps it verbatim into the COMMIT marker, which is
    #: what chain resolution replays from. ``total_bytes`` of a delta
    #: save is the PACKED payload actually written, not the stream size.
    delta: Optional[dict] = None
    #: stripe-vs-single-stream choice of a delta save (DESIGN.md §13):
    #: True = the packed payload cleared ``delta_stripe_min_mb`` and
    #: was carved across the full writer/volume fan-out; False = it
    #: single-streamed into one primary-resident shard; None = not a
    #: delta save
    delta_striped: Optional[bool] = None
    #: bytes that crossed device→host for this save (masks + gathered
    #: dirty blocks under ``device_dirty``; the full stream otherwise)
    d2h_bytes: int = 0
    #: wall time of the device→arena snapshot (the chunked fill worker;
    #: == serialize_seconds for monolithic saves)
    snapshot_seconds: float = 0.0
    #: chunk count of the snapshot (0 = monolithic copy)
    snapshot_chunks: int = 0
    #: wall time of int8 quantization on the host (``quantize`` saves of
    #: host state: the ckpt_quant kernel's plain version; part of
    #: ``serialize_seconds``); 0 for state on the card
    quantize_seconds: float = 0.0
    #: the per-block scales of a ``quantize`` save that the ckpt_quant
    #: kernel computed on the card, by record name (host copies of the
    #: snapshot's ``#scale`` records; empty for host state)
    device_scales: Dict[str, object] = field(default_factory=dict)

    @property
    def gbps(self):
        return self.total_bytes / max(self.seconds, 1e-12) / 1e9


class FastPersistCheckpointer:
    def __init__(self, directory: str, config: FastPersistConfig = None):
        self.directory = directory
        self.config = config or FastPersistConfig()
        os.makedirs(directory, exist_ok=True)
        self._plan_cache = {}
        # persistent staging arena: reused across save() calls AND across
        # overlapped (pipelined) saves — the engine's helper thread
        # serializes saves, so the arena is never refilled while a
        # previous save still reads it. Not safe for CONCURRENT save()
        # calls on one instance (use one checkpointer per caller).
        self._arena = SerializeArena()
        # ---- delta-chain state (DESIGN.md §9) ----
        # A save may only chain off a base that is BOTH durably
        # committed (note_committed fired) and still resident in the
        # arena (the dirty compare ran against exactly that image).
        self._base: Optional[Tuple[int, str]] = None      # committed
        self._pending: Optional[Tuple[int, str]] = None   # written, no
        #                                                   commit yet
        self._arena_gen: Optional[Tuple[int, str]] = None  # arena image
        self._since_keyframe = 0   # deltas committed since last keyframe
        #: wall time of the last load's dequantization (quantized
        #: checkpoints only)
        self.last_dequantize_seconds = 0.0

    # -- setup-time planning (paper: partition fixed before iteration 1) --
    def plan_for(self, total_bytes: int, n_volumes: int = 1,
                 healthy_volumes: Optional[Tuple[int, ...]] = None,
                 min_extent_bytes: int = 0) -> WritePlan:
        """Cached write plan. ``healthy_volumes`` (surviving volume
        indices from a per-save health probe) keys the cache too, so a
        volume dropping out mid-training re-plans instead of serving
        the stale stripe. ``min_extent_bytes`` trims the writer subset
        for tiny streams (delta generations) — see
        :func:`partition.make_plan`."""
        key = (total_bytes, n_volumes, healthy_volumes, min_extent_bytes)
        if key not in self._plan_cache:
            self._plan_cache[key] = make_plan(
                total_bytes, self.config.topology, self.config.strategy,
                n_volumes=n_volumes,
                healthy_volumes=(list(healthy_volumes)
                                 if healthy_volumes is not None else None),
                min_extent_bytes=min_extent_bytes)
        return self._plan_cache[key]

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def _delta_enabled(self) -> bool:
        return self.config.keyframe_every > 1 and not self.config.quantize

    def note_committed(self, step: int, marker: Optional[dict]):
        """Durability hook (DESIGN.md §9): the engine calls this AFTER
        the crash-atomic publish of a save this checkpointer wrote. Only
        then does that save become the delta base for the next one — a
        save whose commit never lands (crash, failed publish) must not
        be chained off, or the chain would reference a generation no
        restore can resolve. Standalone saves (no engine, ``directory``
        None) self-commit inline, since their write IS the durability
        point."""
        gen = str((marker or {}).get("generation") or "")
        if self._pending is not None and self._pending == (step, gen):
            self._base = self._pending
            if (marker or {}).get("delta"):
                self._since_keyframe += 1
            else:
                self._since_keyframe = 0
        else:
            # a commit we did not just write (another writer, reordered
            # steps, lost generation) — the arena image no longer
            # matches the durable tip, so restart the chain
            self._base = None
            self._since_keyframe = 0
        self._pending = None

    @staticmethod
    def _shard_file(shard_index: int) -> str:
        return f"shard_{shard_index:03d}.bin"

    def save(self, state, step: int, extras: Optional[dict] = None,
             directory: Optional[str] = None,
             volume_dirs: Optional[Sequence[str]] = None,
             on_snapshot: Optional[Callable[[], None]] = None) -> SaveStats:
        """Persist ``state``. ``directory`` overrides the step directory —
        the CheckpointEngine points it at a staging dir so the commit
        protocol (COMMIT marker + atomic rename) stays engine-owned.
        ``volume_dirs`` (index-aligned with the plan's volume indices)
        stripes shard files across destination volumes; the manifest and
        any volume-0-resident shards stay under ``directory``.
        ``on_snapshot`` is called once the device→staging copy has fully
        landed (DESIGN.md §10) — the earliest point a train step may
        update the state in place, while the write is still in flight."""
        t_ser = time.perf_counter()
        track = self._delta_enabled()
        # chunked snapshot (DESIGN.md §10): quantized saves stay
        # monolithic, as the reference's
        chunk_bytes = 0
        if self.config.snapshot_chunk_mb > 0 and not self.config.quantize:
            chunk_bytes = int(self.config.snapshot_chunk_mb) << 20
        quantize_s = 0.0
        dev_scales = {}
        progress = None
        fill_thread = None
        if chunk_bytes:
            manifest, buffers, progress, fill = begin_snapshot(
                state, self._arena, chunk_bytes, track_dirty=track,
                dirty_block=DIRTY_BLOCK,
                device_dirty=self.config.device_dirty)

            def _fill_job():
                fill()                     # failures park in `progress`
                if on_snapshot is not None and not progress.failed:
                    on_snapshot()

            fill_thread = threading.Thread(target=_fill_job,
                                           name="fp-snapshot", daemon=True)
            fill_thread.start()
        elif self.config.quantize:
            # the snapshot copies int8 values and scales: ckpt_quant
            # quantizes each float leaf on the card, enqueued on the
            # compute stream BEFORE the snapshot's ready event into new
            # storage, so the bytes are the values' at that event even
            # when the trainer updates the state in place after the
            # on_snapshot call
            leaves, dtypes, quantize_s = quant.quantize_leaves(
                flatten(state))
            manifest, buffers = serialize_leaves(
                leaves, treedef_str(state), arena=self._arena, dtypes=dtypes)
            dev_scales = {n[:-len("#scale")]: np.array(b)
                          for (n, t), b in zip(leaves, buffers)
                          if n.endswith("#scale")
                          and isinstance(t, torch.Tensor) and t.is_cuda}
            # the arena holds their bytes now: free the card's int8
            # values and scales before the trainer runs on
            del leaves
            if on_snapshot is not None:
                on_snapshot()
        else:
            manifest, buffers = serialize(
                state, arena=self._arena, track_dirty=track,
                dirty_block=DIRTY_BLOCK,
                device_dirty=self.config.device_dirty)
            if on_snapshot is not None:
                on_snapshot()
        arena_reused = self._arena.last_reused
        manifest.extras = extras or {}
        if self.config.quantize:
            manifest.extras = {**manifest.extras, "quantized": True}
        gen = os.urandom(4).hex()
        # delta eligibility (DESIGN.md §9): tracking produced a valid
        # dirty set (arena layout hit), the previous save is durably
        # committed AND is the image resident in the arena, and the
        # keyframe cadence hasn't come due. A chunked snapshot must
        # fully land first — the dirty set is only complete then (small
        # delta payloads don't profit from write overlap anyway).
        dplan: Optional[DeltaPlan] = None
        if track and self._base is not None \
                and self._arena_gen == self._base \
                and self._since_keyframe + 1 < self.config.keyframe_every:
            if progress is not None:
                progress.wait_done()
            if self._arena.last_dirty is not None:
                dplan, payloads = build_delta(
                    manifest.records, ByteStreamView(buffers),
                    self._arena.last_dirty,
                    base_step=self._base[0], base_gen=self._base[1],
                    gen=gen, quantize=self.config.delta_quantize)
                buffers = payloads
        view = ByteStreamView(buffers)
        ser_s = time.perf_counter() - t_ser

        d = directory if directory is not None else self.path(step)
        n_volumes = len(volume_dirs) if volume_dirs else 1
        dirs = list(volume_dirs) if volume_dirs else [d]
        # striped delta generations (DESIGN.md §13): the binary cutoff —
        # a packed payload clearing delta_stripe_min_mb is carved across
        # the full writer/volume fan-out exactly like a keyframe; below
        # it the delta single-streams into one primary-resident shard
        stripe_min = (int(self.config.delta_stripe_min_mb) << 20
                      if dplan is not None else 0)
        delta_single = dplan is not None and stripe_min > 0 \
            and view.total < stripe_min
        if delta_single:
            n_volumes, dirs = 1, [d]
        # plan-time volume health (ROADMAP): probe every destination —
        # writable + enough free space for its share — and stripe only
        # across the survivors; a totally-dead volume set degrades to
        # the primary directory instead of failing the save
        probe_degraded: Tuple[int, ...] = ()

        def _plan(n_vol, healthy=None):
            if dplan is None:
                return self.plan_for(view.total, n_vol,
                                     healthy_volumes=healthy)
            # delta payloads vary in size every save: a direct
            # (uncached) plan instead of flooding the plan cache with
            # one entry per distinct packed size
            return delta_stripe_plan(
                view.total, self.config.topology, self.config.strategy,
                n_volumes=n_vol,
                healthy_volumes=(list(healthy) if healthy is not None
                                 else None),
                stripe_min_bytes=stripe_min)

        if n_volumes > 1:
            n_writers = len(select_writers(
                self.config.topology, self.config.strategy,
                total_bytes=view.total))
            healthy, deg = probe_volumes(dirs, view.total, create=True,
                                         n_shards=n_writers)
            probe_degraded = tuple(deg)
            if not healthy:
                warnings.warn(
                    f"every checkpoint volume failed the health probe "
                    f"({dirs}); falling back to the primary directory "
                    f"{d}", stacklevel=2)
                dirs, n_volumes = [d], 1
                plan = _plan(1)
            else:
                plan = _plan(n_volumes, healthy=tuple(healthy))
        else:
            plan = _plan(n_volumes)
        if dplan is not None:
            # per-shard span table (DESIGN.md §13): stamp every span's
            # destination [shard, shard_offset] from the plan's carve of
            # the packed stream — restore and the durability tiers walk
            # the table without re-deriving the write-side geometry
            dplan.spans = assign_span_shards(plan.extents, dplan.spans)
        used_dirs = {d, *(dirs[e.volume] for e in plan.extents)}
        for vd in used_dirs:
            os.makedirs(vd, exist_ok=True)

        t0 = time.perf_counter()
        # Each writer = one of the paper's DP-rank helper processes. The
        # write path is communication-free: every extent was fixed at
        # setup; per-extent CRC32 accumulates inside each writer's fill
        # phase (single-pass integrity), so the stream is traversed
        # exactly once end to end.
        wcfg = self.config.writer

        # chunk-granular handoff: writers consume gated segments that
        # block until the snapshot watermark covers them (delta saves
        # already waited for the whole fill — no gate needed)
        gate = progress if (progress is not None and dplan is None) else None

        def run_writer(extent):
            if gate is not None:
                segs = _GatedSegments(view, extent.offset, extent.length,
                                      gate)
            else:
                segs = view.slices(extent.offset, extent.length)
            return write_stream(
                os.path.join(dirs[extent.volume],
                             self._shard_file(extent.shard_index)),
                segs, extent.length, wcfg)

        try:
            if len(plan.extents) == 1:
                per_writer = [run_writer(plan.extents[0])]
            else:
                with ThreadPoolExecutor(len(plan.extents),
                                        thread_name_prefix="fp-write") as ex:
                    per_writer = list(ex.map(run_writer, plan.extents))
        finally:
            # the arena must never see a new fill while this one runs —
            # join on every exit, including writer failure
            if fill_thread is not None:
                fill_thread.join()
        if progress is not None:
            # re-raise a fill failure the (already-satisfied) writers
            # outran: no manifest, no COMMIT
            progress.wait_done()
        wall = time.perf_counter() - t0

        with spans.span("save.manifest"):
            mpath = os.path.join(d, layout.MANIFEST_FILE)
            meta = json.loads(manifest.to_json())
            # mirror the COMMIT stamping rule: a delta generation is v3;
            # otherwise only a checkpoint whose shards actually leave the
            # primary directory is a v2 layout — anything else stays
            # readable by pre-sharding (v1) readers
            d_real = os.path.realpath(d)
            striped = any(os.path.realpath(dirs[e.volume]) != d_real
                          for e in plan.extents)
            meta["layout_version"] = (
                layout.DELTA_LAYOUT_VERSION if dplan is not None
                else layout.SHARDED_LAYOUT_VERSION if striped else 1)
            # the generation nonce also lands in the manifest so standalone
            # (no-COMMIT) saves still resolve delta chains
            meta["generation"] = gen
            if dplan is not None:
                meta["delta"] = dplan.to_meta()
                meta["delta"]["striped"] = not delta_single
            extents_meta = [vars(e).copy() for e in plan.extents]
            # fill-phase CRCs from the writers — NOT a second sweep
            for em, ws in zip(extents_meta, per_writer):
                if ws.crc32 is not None:
                    em["crc32"] = ws.crc32
            meta["plan"] = {"strategy": plan.strategy, "extents": extents_meta,
                            "n_volumes": plan.n_volumes}
            degraded = tuple(sorted({*plan.degraded, *probe_degraded}))
            if degraded:
                # audit trail: which volumes the health probe dropped (the
                # COMMIT's per-shard volume records already make restore
                # work without this — it is for operators and tests)
                meta["plan"]["degraded"] = list(degraded)
            # the global index: tensor → [shard, offset-in-shard, length]
            # spans, the key to rank-elastic and partial restore (§5).
            # Delta generations have none: their extents cover the PACKED
            # span payload, not the tensor stream — the DeltaPlan span
            # table is their index
            if dplan is None:
                meta["index"] = tensor_spans(manifest.records, plan.extents)
            with open(mpath, "w") as f:
                json.dump(meta, f)
        shard_meta = []
        for e, em in zip(plan.extents, extents_meta):
            sh = {"name": self._shard_file(e.shard_index),
                  "volume": e.volume, "size": e.length}
            if "crc32" in em:
                sh["crc32"] = em["crc32"]
            shard_meta.append(sh)
        stats = SaveStats(view.total, wall, ser_s, per_writer,
                          len(plan.extents), shards=shard_meta,
                          arena_reused=arena_reused, generation=gen,
                          delta=dplan.to_meta() if dplan is not None
                          else None,
                          d2h_bytes=self._arena.last_d2h_bytes,
                          snapshot_seconds=(progress.seconds
                                            if progress is not None
                                            else ser_s),
                          snapshot_chunks=(progress.n_chunks
                                           if progress is not None else 0),
                          delta_striped=(None if dplan is None
                                         else not delta_single),
                          quantize_seconds=quantize_s,
                          device_scales=dev_scales)
        if stats.delta is not None:
            # the engine stamps this dict into the COMMIT marker, so it
            # must stay the COMPLETE table (chain resolution + replay
            # read it from the marker); n_spans and the stripe choice
            # ride along for display and the tier audit trail
            stats.delta["n_spans"] = len(dplan.spans)
            stats.delta["striped"] = not delta_single
        # chain bookkeeping: the arena now holds THIS save's image;
        # the save becomes the next base only once its commit lands
        # (note_committed — engine hook, or inline for standalone saves
        # whose write is already the durability point)
        if track:
            self._arena_gen = (step, gen)
            self._pending = (step, gen)
            if directory is None:
                self.note_committed(step, {"generation": gen,
                                           "delta": stats.delta})
        else:
            self._arena_gen = None
            self._pending = None
        return stats

    # ------------------------------------------------------------- load
    def _read_manifest(self, step: int, directory: Optional[str] = None):
        """(manifest, saved plan, index, full meta dict) of a step dir.
        ``meta`` carries the delta descriptor + generation nonce for
        layout-v3 generations (and everything else the writer stamped)."""
        d = directory if directory is not None else self.path(step)
        with open(os.path.join(d, layout.MANIFEST_FILE)) as f:
            meta = json.load(f)
        manifest = Manifest(
            records=[], total_bytes=meta["total_bytes"],
            extras=meta.get("extras", {}))
        manifest.records = [TensorRecord(r["name"], r["dtype"],
                                         tuple(r["shape"]), r["offset"],
                                         r["nbytes"])
                            for r in meta["records"]]
        return manifest, meta["plan"], meta.get("index"), meta

    def _shard_dir(self, directory: str, extent: dict,
                   marker: Optional[dict],
                   volume_roots: Optional[Sequence[str]]) -> str:
        """Resolve the directory holding one extent's shard file. Layout
        v1 extents carry no ``volume`` key and resolve to ``directory``
        itself, which is exactly the legacy single-dir behaviour."""
        return layout.resolve_shard_dir(marker, directory,
                                        int(extent.get("volume", 0)),
                                        volume_roots)

    def read_shard(self, step: int, shard_index: int, extent,
                   directory: Optional[str] = None,
                   marker: Optional[dict] = None,
                   volume_roots: Optional[Sequence[str]] = None) -> bytes:
        """One rank's load step (before the allgather)."""
        d = directory if directory is not None else self.path(step)
        sd = self._shard_dir(d, extent, marker, volume_roots)
        with open(os.path.join(sd, self._shard_file(shard_index)),
                  "rb") as f:
            return f.read(extent["length"])

    def _materialize(self, manifest: Manifest, stream, like, device=None):
        """Shared tail of every load path: (de)quantize + rebuild tensors
        from an assembled stream. With a memoryview stream the tensors
        are zero-copy views into it (arena lifetime rule, DESIGN.md §7);
        dequantized tensors are new storage — on ``device`` when it is
        not the CPU (the int8 values and scales cross, the product runs
        there), on the host otherwise."""
        if manifest.extras.get("quantized"):
            t0 = time.perf_counter()
            named = quant.dequantize_named(deserialize(manifest, stream),
                                           manifest, device=device)
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.last_dequantize_seconds = time.perf_counter() - t0
            if like is not None:
                return unflatten(like, named), manifest
            return named, manifest
        return deserialize(manifest, stream, like=like), manifest

    def load(self, step: int, like=None, verify: bool = True,
             directory: Optional[str] = None,
             marker: Optional[dict] = None,
             volume_roots: Optional[Sequence[str]] = None,
             read_plan: Union[None, int, str, ReadPlan] = None,
             device=None):
        """Assemble the full stream (the 'allgather') and rebuild arrays.
        Rank-elastic: reassembly is driven entirely by the manifest's
        SAVED plan, so any reader topology/volume layout restores a
        checkpoint written by any writer count. Per-extent CRC32s are
        verified when present (production integrity check — a
        torn/corrupted shard fails loudly, not silently).

        ``read_plan`` selects the PARALLEL restore pipeline: an int (or
        ``"auto"``) builds a balanced byte-stripe
        :class:`~repro_torch.core.partition.ReadPlan` over that many local
        reader workers; an explicit plan (e.g. ownership-based) is used
        as-is. Each worker reads only its owned spans through the async
        read backends into one shared page-aligned arena buffer.

        ``device`` is where a quantized checkpoint is dequantized (its
        records land there; the others stay host views for the caller
        to place)."""
        d = directory if directory is not None else self.path(step)
        if marker is None:
            marker = layout.read_commit_marker(d)
        manifest, plan, index, meta = self._read_manifest(step, directory)
        dinfo = (marker or {}).get("delta") or meta.get("delta")
        if dinfo:
            return self._load_delta(step, d, marker, manifest, meta, like,
                                    verify, volume_roots, read_plan)
        if read_plan is not None:
            return self._load_parallel(manifest, plan, index, read_plan,
                                       like, verify, d, marker,
                                       volume_roots, device)
        stream = bytearray(manifest.total_bytes)
        self._fill_sequential(stream, step, d, plan, verify, marker,
                              volume_roots)
        return self._materialize(manifest, stream, like, device)

    def _fill_sequential(self, dest, step: int, d: str, plan: dict,
                         verify: bool, marker, volume_roots):
        """Legacy single-reader fill: read each shard whole into
        ``dest`` at its stream offset, CRC-checking against the saved
        plan. Shared by the plain load and the keyframe half of a delta
        restore."""
        import zlib
        for e in plan["extents"]:
            data = self.read_shard(step, e["shard_index"], e, d,
                                   marker=marker, volume_roots=volume_roots)
            if verify and "crc32" in e:
                crc = zlib.crc32(data)
                if crc != e["crc32"]:
                    raise IOError(
                        f"checkpoint corruption: shard {e['shard_index']} "
                        f"crc {crc:#x} != manifest {e['crc32']:#x}")
            dest[e["offset"]:e["offset"] + e["length"]] = data

    # --------------------------------------- delta restore (DESIGN.md §9)
    def _resolve_chain(self, step: int, d: str, marker, manifest, meta):
        """Walk a delta chain newest → keyframe, verifying every link's
        base identity. Returns ``(deltas, keyframe)`` where ``deltas``
        is newest-first ``[(step, dir, marker, meta, DeltaPlan), ...]``
        and ``keyframe`` is ``(step, dir, marker, manifest, plan,
        index)`` of the full base everything replays onto."""
        root = os.path.dirname(os.path.abspath(d))
        deltas = []
        cur_step, cur_d, cur_marker, cur_manifest, cur_meta = \
            step, d, marker, manifest, meta
        seen = set()
        while True:
            dinfo = ((cur_marker or {}).get("delta")
                     or cur_meta.get("delta"))
            if not dinfo:
                _mf, kplan, kindex, _meta = self._read_manifest(
                    cur_step, cur_d)
                return deltas, (cur_step, cur_d, cur_marker, cur_manifest,
                                kplan, kindex)
            dp = DeltaPlan.from_meta(dinfo)
            deltas.append((cur_step, cur_d, cur_marker, cur_meta, dp))
            if (dp.base_step, dp.base_gen) in seen or len(seen) > 100000:
                raise layout.TornCheckpointError(
                    f"{cur_d}: cyclic delta chain at base step "
                    f"{dp.base_step}")
            seen.add((dp.base_step, dp.base_gen))
            bd = os.path.join(root, layout.step_dir_name(dp.base_step))
            bmarker = layout.read_commit_marker(bd)
            try:
                bmanifest, _bplan, _bindex, bmeta = self._read_manifest(
                    dp.base_step, bd)
            except OSError as e:
                raise layout.TornCheckpointError(
                    f"{cur_d}: delta base step {dp.base_step} is missing "
                    f"({bd}) — the keyframe/delta chain is broken") from e
            bgen = ((bmarker or {}).get("generation")
                    or bmeta.get("generation") or "")
            if dp.base_gen and bgen != dp.base_gen:
                raise layout.TornCheckpointError(
                    f"{cur_d}: delta chains off generation "
                    f"{dp.base_gen} of step {dp.base_step}, but the "
                    f"committed generation there is {bgen or '<none>'} — "
                    f"the base was re-saved; refusing to replay onto the "
                    f"wrong image")
            cur_step, cur_d, cur_marker, cur_manifest, cur_meta = \
                dp.base_step, bd, bmarker, bmanifest, bmeta

    @staticmethod
    def _verify_span_shards(dd: str, plan: dict, dp: DeltaPlan):
        """Cross-check a striped delta's per-shard span table
        (DESIGN.md §13) against its saved write plan: every stamped
        span's ``[shard, shard_offset]`` must agree with the extent
        that carve placed its first packed byte in. A disagreement
        means the manifest and COMMIT describe different layouts —
        refuse rather than replay bytes from the wrong shard. Pre-§13
        tables (``shard_offset == -1``) carry no destinations and are
        skipped."""
        by_shard = {int(e["shard_index"]): e for e in plan["extents"]}
        for s in dp.spans:
            if s.shard_offset < 0:
                continue
            e = by_shard.get(s.shard)
            if (e is None
                    or s.packed_offset - int(e["offset"]) != s.shard_offset
                    or not 0 <= s.shard_offset < int(e["length"])):
                raise layout.TornCheckpointError(
                    f"{dd}: delta span @{s.offset} records shard "
                    f"[{s.shard}, {s.shard_offset}] but the saved plan "
                    f"puts packed byte {s.packed_offset} elsewhere — "
                    f"span table and write plan disagree")

    def _read_delta_payload(self, dstep: int, dd: str, dmarker,
                            dmeta: dict, dp: DeltaPlan, verify: bool,
                            volume_roots, read_plan=None) -> memoryview:
        """One delta generation's PACKED span payload, reassembled from
        its shards through the saved plan (same read machinery as full
        checkpoints — the per-span CRCs are checked later, at decode).
        Striped generations (multi-extent plans) fill through the
        parallel ReadPlan pipeline when the caller requested one; the
        per-shard span table is verified against the plan either way."""
        self._verify_span_shards(dd, dmeta["plan"], dp)
        packed = memoryview(bytearray(dp.packed_bytes))
        if read_plan is not None and len(dmeta["plan"]["extents"]) > 1:
            self._fill_parallel(dmeta["plan"], None, read_plan, verify,
                                dd, dmarker, volume_roots, packed)
        else:
            self._fill_sequential(packed, dstep, dd, dmeta["plan"],
                                  verify, dmarker, volume_roots)
        return packed

    def _load_delta(self, step: int, d: str, marker, manifest, meta,
                    like, verify, volume_roots, read_plan):
        """Restore a delta generation: resolve the chain to its
        keyframe, reassemble the keyframe stream into ONE buffer (the
        arena's read staging — through the parallel ReadPlan pipeline
        when requested), then replay each delta oldest → newest so the
        newest write of every byte wins; per-span CRCs verify during
        decode. The materialized manifest/extras are the REQUESTED
        step's."""
        deltas, (kstep, kd, kmarker, kmanifest, kplan, kindex) = \
            self._resolve_chain(step, d, marker, manifest, meta)
        total = kmanifest.total_bytes
        if manifest.total_bytes != total:
            raise layout.TornCheckpointError(
                f"{d}: delta stream is {manifest.total_bytes} bytes but "
                f"keyframe step {kstep} holds {total} — chain broken")
        dest = self._arena.read_buffer(total)
        if read_plan is not None:
            self._fill_parallel(kplan, kindex, read_plan, verify, kd,
                                kmarker, volume_roots, dest)
        else:
            self._fill_sequential(dest, kstep, kd, kplan, verify, kmarker,
                                  volume_roots)
        # an explicit ReadPlan was carved for the KEYFRAME's geometry —
        # each delta payload re-derives its own stripe from the count
        drp = read_plan if not isinstance(read_plan, ReadPlan) else None
        for dstep, dd, dmarker, dmeta, dp in reversed(deltas):
            packed = self._read_delta_payload(dstep, dd, dmarker, dmeta,
                                              dp, verify, volume_roots,
                                              read_plan=drp)
            apply_delta(dest, dp, packed, verify=verify)
        return self._materialize(manifest, dest, like)

    # ------------------------------------------- parallel restore (§4.2)
    def _resolve_read_plan(self, read_plan, plan: dict,
                           index: Optional[dict]) -> ReadPlan:
        if isinstance(read_plan, ReadPlan):
            return read_plan
        if read_plan == "auto":
            n = min(8, os.cpu_count() or 1, max(2, len(plan["extents"])))
        else:
            n = max(1, int(read_plan))
        return make_read_plan(plan, index, n)

    def _span_file(self, d: str, extent: dict, marker, volume_roots,
                   spans: List[ReadSpan]
                   ) -> Tuple[str, List[Tuple[int, int, int]]]:
        """(path, [(file_offset, dest_offset≡stream_offset, length)])
        for one shard's spans."""
        sd = self._shard_dir(d, extent, marker, volume_roots)
        path = os.path.join(sd, self._shard_file(int(extent["shard_index"])))
        return path, [(s.shard_offset, s.stream_offset, s.length)
                      for s in spans]

    def _read_rank_spans(self, rank: int, rp: ReadPlan, by_shard: Dict,
                         dest: memoryview, d: str, marker, volume_roots,
                         rcfg: WriterConfig, collected: Dict,
                         lock: threading.Lock):
        """One reader worker: stream this rank's spans — grouped per
        shard file, ``queue_depth`` reads in flight — into the shared
        destination buffer, folding per-span CRCs while the bytes are
        hot."""
        spans = rp.spans_of(rank)
        for shard_index, group in groupby(spans,
                                          key=lambda s: s.shard_index):
            group = list(group)
            e = by_shard[shard_index]
            path, triples = self._span_file(d, e, marker, volume_roots,
                                            group)
            st = read_stream(path, triples, dest, rcfg)
            if st.span_crcs is not None:
                with lock:
                    collected.setdefault(shard_index, []).extend(
                        (s.shard_offset, s.length, c)
                        for s, c in zip(group, st.span_crcs))

    def _verify_span_crcs(self, extents: Sequence[dict], collected: Dict):
        """Combine each shard's span CRCs (``reader.crc32_combine`` —
        no re-read) and compare against the manifest. Shards whose
        collected spans do not tile the whole shard (owned-only reads)
        are skipped: a partial read cannot be checked against a
        whole-shard CRC."""
        for e in extents:
            if "crc32" not in e:
                continue
            parts = collected.get(int(e["shard_index"]))
            if not parts:
                continue
            combined = combine_span_crcs(parts, int(e["length"]))
            if combined is None:        # partial coverage: unverifiable
                continue
            if combined != e["crc32"]:
                raise IOError(
                    f"checkpoint corruption: shard {e['shard_index']} "
                    f"combined span crc {combined:#x} != manifest "
                    f"{e['crc32']:#x} (parallel restore path)")

    def _fill_parallel(self, plan: dict, index: Optional[dict], read_plan,
                       verify, d: str, marker, volume_roots,
                       dest: memoryview):
        """Fill ``dest`` through N local reader workers (the
        single-host stand-in for the paper's allgather: every rank's
        spans land at their stream offsets, so assembly IS
        concatenation), with combined-CRC verification. Shared by the
        full parallel load and the keyframe half of a delta restore."""
        rp = self._resolve_read_plan(read_plan, plan, index)
        rcfg = self.config.writer
        if rcfg.checksum != bool(verify):
            rcfg = replace(rcfg, checksum=bool(verify))
        by_shard = {int(e["shard_index"]): e for e in plan["extents"]}
        collected: Dict[int, list] = {}
        lock = threading.Lock()
        readers = [r for r in rp.readers if rp.spans_of(r)]
        if len(readers) <= 1:
            for r in readers:
                self._read_rank_spans(r, rp, by_shard, dest, d, marker,
                                      volume_roots, rcfg, collected, lock)
        else:
            with ThreadPoolExecutor(len(readers),
                                    thread_name_prefix="fp-read") as ex:
                list(ex.map(
                    lambda r: self._read_rank_spans(
                        r, rp, by_shard, dest, d, marker, volume_roots,
                        rcfg, collected, lock), readers))
        if verify:
            self._verify_span_crcs(plan["extents"], collected)

    def _load_parallel(self, manifest: Manifest, plan: dict,
                       index: Optional[dict], read_plan, like, verify,
                       d: str, marker, volume_roots, device=None):
        """N local reader workers → one shared arena buffer, combined-CRC
        verification, zero-copy deserialize."""
        dest = self._arena.read_buffer(manifest.total_bytes)
        self._fill_parallel(plan, index, read_plan, verify, d, marker,
                            volume_roots, dest)
        return self._materialize(manifest, dest, like, device)

    def read_owned(self, step: int, rank: int, n_readers: int,
                   ownership: Union[None, str, dict] = None,
                   verify: bool = True,
                   directory: Optional[str] = None,
                   marker: Optional[dict] = None,
                   volume_roots: Optional[Sequence[str]] = None,
                   read_plan: Optional[ReadPlan] = None) -> "OwnedRead":
        """ONE rank's half of the distributed restore: read only the
        spans this rank owns (``ownership=None`` → balanced stripe;
        ``"zero1"`` → the ZeRO-1 projection from
        ``repro_torch.sharding.specs``; a dict → explicit per-tensor
        ownership) into a packed buffer. The returned
        :class:`OwnedRead` exposes the spans for the allgather
        (:func:`allgather_owned` is the single-host stand-in). Shards
        fully covered by this rank's spans are CRC-verified; partially
        covered shards cannot be (whole-shard CRCs)."""
        d = directory if directory is not None else self.path(step)
        if marker is None:
            marker = layout.read_commit_marker(d)
        manifest, plan, index, meta = self._read_manifest(step, directory)
        if (marker or {}).get("delta") or meta.get("delta"):
            raise NotImplementedError(
                f"read_owned on a delta generation (step {step}) is not "
                f"supported — its shards hold a packed dirty-span "
                f"payload, not the tensor stream; load() replays the "
                f"chain, or point at a keyframe step")
        if read_plan is None:
            if ownership == "zero1":
                from repro_torch.sharding.specs import zero1_ownership
                ownership = zero1_ownership(manifest.records, n_readers)
            read_plan = make_read_plan(plan, index, n_readers, ownership)
        spans = read_plan.spans_of(rank)
        owned = sum(s.length for s in spans)
        # a PRIVATE buffer, not the arena: the single-host allgather
        # needs every rank's OwnedRead alive at once, and on a real DP
        # group each rank is its own process anyway
        dest = memoryview(bytearray(owned))
        rcfg = self.config.writer
        if rcfg.checksum != bool(verify):
            rcfg = replace(rcfg, checksum=bool(verify))
        by_shard = {int(e["shard_index"]): e for e in plan["extents"]}
        collected: Dict[int, list] = {}
        pos = 0
        for shard_index, group in groupby(spans,
                                          key=lambda s: s.shard_index):
            group = list(group)
            e = by_shard[shard_index]
            path, triples = self._span_file(d, e, marker, volume_roots,
                                            group)
            packed = []
            for (file_off, _stream_off, length) in triples:
                packed.append((file_off, pos, length))
                pos += length
            st = read_stream(path, packed, dest, rcfg)
            if st.span_crcs is not None:
                collected.setdefault(shard_index, []).extend(
                    (s.shard_offset, s.length, c)
                    for s, c in zip(group, st.span_crcs))
        if verify:
            self._verify_span_crcs(plan["extents"], collected)
        return OwnedRead(rank=rank, step=step, manifest=manifest,
                         spans=list(spans), buffer=dest[:owned])

    def load_tensor(self, step: int, name: str,
                    directory: Optional[str] = None,
                    marker: Optional[dict] = None,
                    volume_roots: Optional[Sequence[str]] = None
                    ) -> torch.Tensor:
        """Partial restore of ONE tensor via the global index: reads only
        the [shard, offset, length] spans that hold its bytes — a tensor
        split mid-stream across shard boundaries is reassembled from the
        exact byte ranges, without touching the other shards' data.
        Spans land in ONE preallocated buffer through the same async
        span reader as the parallel restore path (no bytearray-append
        churn, no per-span copies)."""
        d = directory if directory is not None else self.path(step)
        if marker is None:
            marker = layout.read_commit_marker(d)
        manifest, plan, index, meta = self._read_manifest(step, directory)
        if (marker or {}).get("delta") or meta.get("delta"):
            raise NotImplementedError(
                f"load_tensor on a delta generation (step {step}) is not "
                f"supported — delta shards hold a packed dirty-span "
                f"payload with no per-tensor index; load() replays the "
                f"chain, or point at a keyframe step")
        if index is None or name not in index:
            raise KeyError(f"tensor {name!r} not in the checkpoint index "
                           f"(layout v1 checkpoints have no index — use "
                           f"load())")
        rec = next(r for r in manifest.records if r.name == name)
        by_shard = {e["shard_index"]: e for e in plan["extents"]}
        raw = memoryview(bytearray(rec.nbytes))
        rcfg = replace(self.config.writer, checksum=False)
        per_path: List[Tuple[str, Tuple[int, int, int]]] = []
        pos = 0
        for shard_index, off, length in index[name]:
            sd = self._shard_dir(d, by_shard[shard_index], marker,
                                 volume_roots)
            path = os.path.join(sd, self._shard_file(shard_index))
            per_path.append((path, (off, pos, length)))
            pos += length
        if pos != rec.nbytes:
            raise IOError(f"tensor {name!r}: index spans cover {pos} "
                          f"bytes, expected {rec.nbytes}")
        for path, group in groupby(per_path, key=lambda t: t[0]):
            read_stream(path, [t[1] for t in group], raw, rcfg)
        return decode_record(rec, raw)

    def latest_step(self) -> Optional[int]:
        """Most recent COMMITTED step. Defensive: staging ``.tmp`` dirs,
        ``ckpt_foo``, stray files, and torn directories are ignored
        rather than crashing the restore path."""
        steps = layout.committed_steps(self.directory, legacy_ok=True)
        return steps[-1] if steps else None


# ====================================================== owned-span reads
@dataclass
class OwnedRead:
    """One reader rank's slice of a checkpoint — the bytes a DP rank
    loads BEFORE the paper's allgather. ``buffer`` packs the rank's
    spans contiguously in stream order; ``spans`` records where each
    piece belongs in the full stream. The buffer is private to this
    read (every rank's OwnedRead must be alive at once for the
    single-host allgather), unlike the shared-arena full parallel
    load."""
    rank: int
    step: int
    manifest: Manifest
    spans: List[ReadSpan]          # stream order
    buffer: memoryview             # packed owned bytes

    @property
    def nbytes(self) -> int:
        return sum(s.length for s in self.spans)

    def chunks(self) -> Iterator[Tuple[int, memoryview]]:
        """(stream_offset, bytes) pieces — the rank's allgather payload."""
        off = 0
        for s in self.spans:
            yield s.stream_offset, self.buffer[off:off + s.length]
            off += s.length

    def tensor_fragments(self) -> Dict[str, List[Tuple[int, memoryview]]]:
        """{tensor name: [(tensor-relative byte offset, bytes), ...]}
        for every record this rank holds bytes of — e.g. rank *r*'s
        ZeRO-1 row block, ready to ``decode_record`` after a local
        concatenation."""
        out: Dict[str, List[Tuple[int, memoryview]]] = {}
        recs = sorted(self.manifest.records, key=lambda r: r.offset)
        starts = [r.offset for r in recs]
        from bisect import bisect_right
        for stream_off, mv in self.chunks():
            i = max(0, bisect_right(starts, stream_off) - 1)
            while i < len(recs) and recs[i].offset < stream_off + len(mv):
                r = recs[i]
                lo = max(stream_off, r.offset)
                hi = min(stream_off + len(mv), r.offset + r.nbytes)
                if hi > lo:
                    out.setdefault(r.name, []).append(
                        (lo - r.offset,
                         mv[lo - stream_off:hi - stream_off]))
                i += 1
        return out


def allgather_owned(reads: Sequence[OwnedRead]) -> memoryview:
    """Single-host stand-in for the paper's §4.2 allgather: concatenate
    every rank's owned spans back into the full checkpoint stream (on a
    real DP group this is one collective over the same payloads).
    Raises if the union of spans does not cover the stream exactly."""
    assert reads, "allgather of nothing"
    total = reads[0].manifest.total_bytes
    out = memoryview(bytearray(total))
    covered = 0
    for rd in reads:
        for stream_off, mv in rd.chunks():
            out[stream_off:stream_off + len(mv)] = mv
            covered += len(mv)
    if covered != total:
        raise IOError(f"owned reads cover {covered} of {total} bytes — "
                      f"ranks missing from the allgather")
    return out
