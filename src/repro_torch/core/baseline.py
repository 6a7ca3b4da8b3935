"""Baseline checkpointing — the paper's comparison point (§3.1).

Emulates ``torch.save()``: rank 0 alone serializes every tensor and
writes through ordinary buffered file I/O (small interleaved metadata +
data writes, no alignment, no async overlap, no parallelism). All other
DP ranks stall (paper Fig. 4a).

Prefer driving this through :class:`repro_torch.core.engine.CheckpointEngine`
(backend ``"baseline"``) — the direct class is kept as a thin
compatibility shim and as the engine's internal payload writer.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core import layout
from repro_torch.core.arena import SerializeArena
from repro_torch.core.serializer import Manifest, deserialize, serialize

PAYLOAD_FILE = "checkpoint.pt"


@dataclass
class BaselineStats:
    bytes_written: int
    seconds: float
    arena_reused: bool = False

    @property
    def gbps(self):
        return self.bytes_written / max(self.seconds, 1e-12) / 1e9


class BaselineCheckpointer:
    """torch.save()-style: pickle header per tensor + buffered writes.

    ``save`` accepts the same ``(state, step, extras, directory=...)``
    signature as :class:`FastPersistCheckpointer`, so the engine needs no
    per-backend argument plumbing. Legacy mode (no ``directory``) writes
    a single ``ckpt_<step>.pt`` file; directory mode writes
    ``checkpoint.pt`` + ``manifest.json`` into the given (staging) dir.
    """

    def __init__(self, directory: str, buffer_size: int = 64 * 1024,
                 use_arena: bool = True):
        self.directory = directory
        self.buffer_size = buffer_size
        os.makedirs(directory, exist_ok=True)
        # even the baseline benefits from the persistent staging arena
        # (serialize-time allocation churn is orthogonal to the write
        # strategy being emulated)
        self._arena = SerializeArena() if use_arena else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def save(self, state, step: int, extras: Optional[dict] = None,
             directory: Optional[str] = None) -> BaselineStats:
        manifest, buffers = serialize(state, arena=self._arena)
        arena_reused = bool(self._arena and self._arena.last_reused)
        manifest.extras = extras or {}
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, PAYLOAD_FILE)
        else:
            path = self.path(step)
        t0 = time.perf_counter()
        total = 0
        with open(path, "wb", buffering=self.buffer_size) as f:
            header = manifest.to_json().encode()
            f.write(len(header).to_bytes(8, "little"))
            f.write(header)
            total += 8 + len(header)
            for rec, buf in zip(manifest.records, buffers):
                # per-tensor pickled metadata then raw data — mimics
                # torch.save's interleaved small writes
                meta = pickle.dumps((rec.name, rec.dtype, rec.shape))
                f.write(len(meta).to_bytes(4, "little"))
                f.write(meta)
                f.write(memoryview(buf).cast("B"))
                total += 4 + len(meta) + buf.nbytes
            f.flush()
            os.fsync(f.fileno())
        if directory is not None:
            meta = json.loads(manifest.to_json())
            meta["layout_version"] = layout.SHARDED_LAYOUT_VERSION
            with open(os.path.join(directory, layout.MANIFEST_FILE),
                      "w") as f:
                json.dump(meta, f)
        return BaselineStats(total, time.perf_counter() - t0,
                             arena_reused=arena_reused)

    def load(self, step: int, like=None, directory: Optional[str] = None):
        path = (os.path.join(directory, PAYLOAD_FILE)
                if directory is not None else self.path(step))
        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            manifest = Manifest.from_json(f.read(hlen).decode())
            stream = bytearray(manifest.total_bytes)
            pos = 0
            for rec in manifest.records:
                mlen = int.from_bytes(f.read(4), "little")
                pickle.loads(f.read(mlen))
                chunk = f.read(rec.nbytes)
                if len(chunk) != rec.nbytes:
                    raise layout.TornCheckpointError(
                        f"{path}: tensor {rec.name} truncated "
                        f"({len(chunk)}/{rec.nbytes} bytes)")
                stream[pos:pos + rec.nbytes] = chunk
                pos += rec.nbytes
        return deserialize(manifest, stream, like=like), manifest
