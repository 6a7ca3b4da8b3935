"""Sharding rules of the port. Only the byte math of the ZeRO-1 restore
ownership is here; the reference's mesh and ``PartitionSpec`` helpers
are XLA-only (ROADMAP.md queue A item 7)."""
