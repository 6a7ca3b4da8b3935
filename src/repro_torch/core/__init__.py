"""Checkpoint core of the PyTorch port: the on-disk format and host I/O
(copies of the JAX package's pure-POSIX modules) plus the torch
serializer, GPU snapshot arena, checkpointer and engine."""
from repro_torch.core.checkpointer import (FastPersistCheckpointer,
                                           FastPersistConfig, SaveStats)
from repro_torch.core.engine import (CheckpointEngine, CheckpointSpec,
                                     SaveHandle, available_backends)
from repro_torch.core.partition import Topology
from repro_torch.core.writer import WriterConfig

__all__ = ["CheckpointEngine", "CheckpointSpec", "FastPersistCheckpointer",
           "FastPersistConfig", "SaveHandle", "SaveStats", "Topology",
           "WriterConfig", "available_backends"]
