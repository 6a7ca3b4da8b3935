"""Sharding of the port: the spec rules of the reference's mesh
(``specs``: TP on ``model``, DP and ZeRO-1 over ``data``, each leaf's
shard shape and slice, ZeRO-1 ownership of a checkpoint's byte stream)
and expert parallelism across processes (``moe_ep``)."""
