"""PyTorch + CUDA port of the FastPersist reproduction (``repro``).

Same module names and places as the JAX package; imports nothing of it
and no JAX. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``."""
