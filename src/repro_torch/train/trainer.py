"""Training loop with FastPersist checkpointing as a first-class feature
(the counterpart of ``repro.train.trainer``), driven through the unified
:class:`repro_torch.core.engine.CheckpointEngine`:

  baseline               : train step → rank-0 synchronous torch.save-style
                           write (completed SaveHandle)
  fastpersist            : train step → parallel NVMe write (completed
                           SaveHandle)
  fastpersist-pipelined  : the write overlaps the next iteration; before
                           the next step updates the state IN PLACE the
                           trainer waits for the previous save's
                           device→host SNAPSHOT (engine.wait_snapshot).

The trainer runs on ``device`` ("cuda" by default) and raises when that
device is unavailable; only a caller that asks for "cpu" gets the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.retention import RetentionManager, RetentionPolicy
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import (TrainState, init_train_state,
                                     make_train_step)
from repro_torch.tree import tree_map


@dataclass
class CheckpointPolicy(CheckpointSpec):
    """The trainer's checkpointing: a :class:`CheckpointSpec`, handed to
    the engine as it is, plus the save cadence, retention and restore
    width. ``backend=None`` picks ``fastpersist-pipelined``, or
    ``fastpersist-tiered-pipelined`` when ``upload_store`` is set;
    ``"none"`` builds no engine."""
    backend: Optional[str] = None
    every: int = 1                     # paper: per-iteration
    retention: Optional[RetentionPolicy] = None   # None = keep everything
    #: parallel-restore reader workers for ``Trainer.restore()``:
    #: "auto" sizes to the saved shard count (capped by CPUs), an int
    #: forces that many, None keeps the single-reader load
    restore_readers: Optional[object] = "auto"

    def __post_init__(self):
        if self.backend is None:
            self.backend = ("fastpersist-tiered-pipelined"
                            if self.upload_store is not None
                            else "fastpersist-pipelined")


@dataclass
class TrainerConfig:
    model: ModelConfig
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    gas: int = 1
    seed: int = 0
    opt: AdamConfig = field(default_factory=AdamConfig)
    checkpoint: Optional[CheckpointPolicy] = None
    log_every: int = 10


def resolve_device(device) -> torch.device:
    """The trainer's device; raises when CUDA is asked for and missing
    (never a silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev


class Trainer:
    def __init__(self, cfg: TrainerConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg.model)
        self.data = TokenStream(DataConfig(cfg.model.vocab_size,
                                           cfg.seq_len, cfg.global_batch,
                                           cfg.seed), device=self.device)
        self.train_step = make_train_step(self.model, cfg.opt, cfg.gas)
        self.state: Optional[TrainState] = None
        self.engine: Optional[CheckpointEngine] = None
        self._retain: Optional[RetentionManager] = None
        self.iter_times = []
        self.ckpt_stall = 0.0
        #: SaveHandle of every save this trainer submitted, in order
        self.saves = []
        if cfg.checkpoint and cfg.checkpoint.backend != "none":
            self._setup_checkpointer(cfg.checkpoint)

    def _setup_checkpointer(self, pol: CheckpointPolicy):
        self.engine = CheckpointEngine(pol)
        # GC follows the engine's volume mapping (or deleting a step would
        # strand its striped shards), and sees the upload and peer queues,
        # so it never deletes a step whose remote COMMIT has not landed
        # (DESIGN §8) or whose replication is short of the target (§11)
        if pol.retention:
            self._retain = RetentionManager(
                pol.directory, pol.retention, self.engine.volume_roots(),
                upload=self.engine.upload_manager,
                peers=self.engine.peer_replicator)

    # ------------------------------------------------------------ state
    def init_state(self, seed: Optional[int] = None):
        seed = self.cfg.seed if seed is None else seed
        self.state = init_train_state(self.model, seed, self.device)
        if self.engine is not None:
            # fresh state object: the arena's cached layout (and device
            # baseline) belong to the old one
            self.engine.invalidate_arena()
        return self.state

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def restore(self, step: Optional[int] = None,
                tier: str = "local") -> int:
        """Resume from the most recent committed checkpoint (any backend,
        either package) through the parallel restore pipeline
        (``restore_readers``). Returns the step; 0 when there is none.

        ``tier="peer"`` forces hydration from the peer tier (DESIGN.md
        §11; itself falling back to remote when no peer holds a complete
        chain); ``tier="remote"`` from the object tier. With the default
        ``"local"``, a trainer whose local directory holds no committed
        step walks the tiers automatically — peer first when the policy
        replicates to peers, then the upload store (the lost-node
        recovery path, DESIGN.md §8/§11)."""
        assert self.engine is not None, "no checkpoint engine configured"
        if tier not in ("local", "peer", "remote"):
            raise ValueError(f"tier must be 'local', 'peer' or "
                             f"'remote', got {tier!r}")
        forced = tier != "local"
        use_tier = tier
        if not forced and step is None \
                and self.engine.latest_step() is None:
            if self.engine.peer_replicator is not None:
                use_tier = "peer"       # local tier empty/lost → peer
            elif self.engine.remote_store is not None:
                use_tier = "remote"     # ... → remote
        if use_tier == "local":
            step = step if step is not None else self.engine.latest_step()
            if step is None:
                return 0
        # the structure to rebuild, without storage
        like = init_train_state(self.model, self.cfg.seed, "meta")
        readers = (self.cfg.checkpoint.restore_readers
                   if self.cfg.checkpoint else None)
        try:
            restored, manifest = self.engine.load(
                step, like=like, parallel=readers, tier=use_tier)
        except FileNotFoundError:
            # only the AUTOMATIC fallback may degrade to a fresh start; an
            # operator who asked for the peer/remote tier must hear that
            # it is empty (a mistyped store path would otherwise silently
            # retrain from scratch)
            if use_tier != "local" and step is None and not forced:
                return 0                # no tier has a checkpoint
            raise
        # COPY: the tensors are views into the engine's read arena, which
        # the next load refills — the state must own its storage (§7)
        self.state = tree_map(lambda t: t.to(self.device, copy=True),
                              restored)
        self.engine.invalidate_arena()
        extras = manifest.extras
        if "data" in extras:
            self.data = TokenStream.from_state(self.data.cfg, extras["data"],
                                               device=self.device)
        return int(extras.get("step", step if step is not None else 0))

    # ------------------------------------------------------------- loop
    def _save(self, step: int):
        extras = {"step": step, "data": self.data.state()}
        self.saves.append(self.engine.save(self.state, step, extras))

    def run(self, start_step: int = 0):
        if self.state is None:
            self.init_state()
        pol = self.cfg.checkpoint
        metrics = {}
        for step in range(start_step, self.cfg.steps):
            t0 = time.perf_counter()
            batch = next(self.data)
            if self.engine is not None and self.engine.async_save:
                # §4.3 sync point: the previous checkpoint's device→host
                # SNAPSHOT must land before this step updates the state
                # in place; the writes keep overlapping the step, and the
                # engine's submit throttle + drain() stay the durability
                # sync points
                t_w = time.perf_counter()
                self.engine.wait_snapshot()
                self.ckpt_stall += time.perf_counter() - t_w
            self.state, metrics = self.train_step(self.state, batch)
            self._sync()
            if pol and self.engine is not None \
                    and (step + 1) % pol.every == 0:
                self._save(step + 1)
                if self._retain is not None:
                    self._retain.after_commit()
            self.iter_times.append(time.perf_counter() - t0)
            if (step + 1) % self.cfg.log_every == 0:
                print(f"step {step+1}: loss={float(metrics['loss']):.4f} "
                      f"it={np.mean(self.iter_times[-self.cfg.log_every:])*1e3:.1f}ms")
        if self.engine is not None:
            t_w = time.perf_counter()
            self.engine.drain()     # commit stragglers, park the worker
            # a CLEAN exit also flushes the upload and peer tiers (their
            # workers are daemon threads — returning now would abandon
            # the tail generations' remote/peer COMMITs)
            self.engine.wait_uploaded()
            self.engine.wait_replicated()
            self.ckpt_stall += time.perf_counter() - t_w
        self._sync()
        return self.state, metrics
