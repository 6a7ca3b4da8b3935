"""Checkpoint core of the PyTorch port: the on-disk format and host I/O
(copies of the JAX package's pure-POSIX modules), the torch serializer,
GPU snapshot arena, checkpointer and engine, and the durability tiers
(object-store upload, peer replication, retention, serving reads).
Exports what ``repro.core`` exports, less its backend registry and its
pre-engine pipelined wrapper: the port's backends are one fixed table
(``engine.BACKENDS``), and ``fastpersist-pipelined`` is its async save.
Nothing here imports jax."""
from repro_torch.core import layout
from repro_torch.core.aio import backend_available, resolve_backend
from repro_torch.core.arena import SerializeArena
from repro_torch.core.baseline import BaselineCheckpointer, BaselineStats
from repro_torch.core.checkpointer import (FastPersistCheckpointer,
                                           FastPersistConfig, SaveStats)
from repro_torch.core.engine import (BACKENDS, CheckpointEngine,
                                     CheckpointSpec, EngineStats, SaveHandle,
                                     available_backends)
from repro_torch.core.delta import (DeltaPlan, DeltaSpan, apply_delta,
                                    build_delta, dirty_byte_spans)
from repro_torch.core.layout import (DELTA_LAYOUT_VERSION, LAYOUT_VERSION,
                                     SHARDED_LAYOUT_VERSION, CheckpointError,
                                     TornCheckpointError, committed_steps)
from repro_torch.core.overlap import (IterationModel, checkpoint_seconds,
                                      effective_overhead, estimate_iteration,
                                      recovery_overhead_gpu_seconds,
                                      required_bandwidth, staging_seconds)
from repro_torch.core.partition import (Extent, Topology, WritePlan,
                                        make_plan, predict_write_seconds,
                                        select_writers)
from repro_torch.core.serializer import (ByteStreamView, Manifest,
                                         TensorRecord, deserialize,
                                         serialize)
from repro_torch.core.upload import (LocalObjectStore, ObjectStore,
                                     UploadManager, UploadStats, hydrate,
                                     make_store, register_store_scheme,
                                     remote_steps)
from repro_torch.core.writer import (WriteStats, WriterConfig,
                                     aligned_buffer, write_stream)
