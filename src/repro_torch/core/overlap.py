"""Analytic overlap / recovery models (paper Eq. 1, Eq. 2, Table 1).

Eq. 1:  B_C(M) >= S_C(M) / (T_F(M) + T_B(M))
        minimum write bandwidth that hides checkpoint latency behind the
        next iteration's forward+backward.

Eq. 2:  n/2 * m * t
        expected GPU-seconds lost per interruption when checkpointing
        every n iterations on m GPUs with iteration time t.

A copy of ``repro.core.overlap`` with one change: the accelerator's peak
FLOP rate is a required argument of :func:`estimate_iteration`. The
reference's V100 and TPU peaks do not carry over; the caller states the
rate of the card it models (for an H100 SXM, the dense bf16 tensor-core
peak from the vendor's data sheet).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import Topology, predict_write_seconds, \
    select_writers


@dataclass(frozen=True)
class IterationModel:
    """Compute-time model for one data-parallel training iteration."""
    t_forward: float
    t_backward: float
    t_optimizer: float

    @property
    def fb(self):
        return self.t_forward + self.t_backward

    @property
    def total(self):
        return self.t_forward + self.t_backward + self.t_optimizer


def estimate_iteration(cfg: ModelConfig, global_batch: int, seq_len: int,
                       n_accel: int, peak_flops: float,
                       mfu: float = 0.45, gas: int = 1) -> IterationModel:
    """Napkin model: fwd = 2·N_active·D, bwd = 2× fwd, optimizer ~5% —
    matches the paper's '>90% of compute is fwd+bwd' observation.
    ``peak_flops`` is one accelerator's peak rate (FLOP/s); no default."""
    tokens = global_batch * seq_len * gas
    flops_fwd = 2 * cfg.active_param_count() * tokens
    t_fwd = flops_fwd / (n_accel * peak_flops * mfu)
    t_bwd = 2 * t_fwd
    return IterationModel(t_fwd, t_bwd, 0.05 * (t_fwd + t_bwd))


def required_bandwidth(ckpt_bytes: int, it: IterationModel) -> float:
    """Eq. 1: bytes/sec needed to fully hide the checkpoint write."""
    return ckpt_bytes / it.fb


def checkpoint_seconds(ckpt_bytes: int, topo: Topology,
                       strategy: str = "auto",
                       writers_per_node: int = 2) -> float:
    writers = select_writers(topo, strategy, writers_per_node, ckpt_bytes)
    return predict_write_seconds(topo, ckpt_bytes, writers)


def recovery_overhead_gpu_seconds(n_interval: int, m_gpus: int,
                                  t_iter: float) -> float:
    """Eq. 2: expected GPU-seconds of recomputation per interruption."""
    return n_interval / 2 * m_gpus * t_iter


def staging_seconds(ckpt_bytes: int, topo: Topology,
                    steady_state: bool = True) -> float:
    """Device→host serialize time (§4.3 'read GPU tensors into pinned
    CPU memory'). The FIRST save through a ``SerializeArena`` pays
    allocation + page-fault + copy (~2× the copy alone); steady-state
    saves refill the arena in place and pay the copy only — the
    DataStates-LLM lazy-pinned-buffer effect the arena reproduces."""
    copy = ckpt_bytes / (topo.rank_stage_gbps * 1e9)
    return copy if steady_state else 2.0 * copy


def chunk_overlap_fraction(ckpt_bytes: int, chunk_bytes: int) -> float:
    """Fraction of the device→arena staging copy hidden behind the next
    iteration by CHUNKED snapshotting (DESIGN.md §10).

    With a monolithic snapshot the whole copy gates the next step
    (fraction 0). Split into n chunks, the main thread only waits for
    the snapshot worker's in-flight chunk boundary: in the bandwidth-
    bound limit everything except the equivalent of one chunk overlaps,
    so the hidden fraction is 1 - 1/n. ``chunk_bytes <= 0`` means
    monolithic."""
    if chunk_bytes <= 0 or ckpt_bytes <= 0:
        return 0.0
    n = -(-ckpt_bytes // chunk_bytes)       # ceil
    return max(0.0, 1.0 - 1.0 / n)


def effective_overhead(it: IterationModel, ckpt_seconds: float,
                       pipelined: bool, serialize_s: float = 0.0,
                       snapshot_overlap: float = 0.0) -> float:
    """Per-iteration slowdown fraction due to checkpointing every step.

    Pipelined: the write overlaps fwd+bwd of the next iteration; only the
    excess beyond the overlap window stalls the next optimizer step.
    Unpipelined: the full write sits on the critical path.

    ``serialize_s`` (device→arena staging, see :func:`staging_seconds`)
    sits on the critical path by default: the optimizer updates the state
    in place, so the snapshot must complete before the next step —
    pipelining hides the WRITE, never the staging copy.

    ``snapshot_overlap`` (0..1, see :func:`chunk_overlap_fraction`)
    models the chunked snapshot stage: that fraction of the staging
    copy ALSO overlaps the next iteration's fwd+bwd window, competing
    with the write for it. Only the unhidden remainder plus whatever
    spills past the window stalls. At 0 this reduces exactly to the
    monolithic formula."""
    f = min(1.0, max(0.0, snapshot_overlap))
    if pipelined:
        stall = serialize_s * (1.0 - f) \
            + max(0.0, ckpt_seconds + serialize_s * f - it.fb)
    else:
        # no write pipelining → nothing for the snapshot to hide behind
        stall = serialize_s + ckpt_seconds
    return stall / it.total
