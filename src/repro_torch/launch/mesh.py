"""Meshes of the port (the counterpart of ``repro.launch.mesh``).

``Mesh`` describes a device mesh and holds no device state: the dry run
(``launch/dryrun.py``) and the sharding rules (``sharding/specs.py``)
read only its axis names and sizes. ``init_process_mesh`` lays a mesh
over the ranks of a ``torch.distributed`` world, and ``run_ranks``
starts such a world on one machine.

The process-group backend is always the caller's choice, never guessed:
``gloo`` for ranks on the CPU, and ``gloo`` for several ranks on ONE
card as well (NCCL refuses two ranks on one GPU); ``nccl`` only where
each rank has a GPU of its own. The repo's tests and ``chip_smoke.py``
(one card) run ``gloo`` only; the ``nccl`` route is not exercised.
"""
from __future__ import annotations

import itertools
import queue as queue_mod
import socket
import time
import traceback
from collections import OrderedDict
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes, in order (``shape`` as the reference's
    ``mesh.shape``: an ordered mapping)."""
    axis_names: tuple
    shape: OrderedDict

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n


def make_mesh(shape, axis_names) -> Mesh:
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
    return Mesh(tuple(axis_names),
                OrderedDict(zip(axis_names, (int(s) for s in shape))))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ``data``/``model``; 2 x 16 x 16 with a ``pod`` axis."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_cpu_mesh() -> Mesh:
    """One device with the production axis names (smoke tests)."""
    return make_mesh((1, 1), ("data", "model"))


@dataclass(frozen=True)
class ProcessMesh(Mesh):
    """A mesh laid over the ranks of a ``torch.distributed`` world:
    this rank's coordinates and the process group of this rank's line
    along each axis."""
    coords: dict = field(default_factory=dict)
    groups: dict = field(default_factory=dict)


def mesh_coords(rank: int, shape) -> tuple:
    """Row-major coordinates of ``rank`` (``jax.make_mesh``'s order on
    host devices: the last axis varies fastest)."""
    out = []
    for s in reversed(tuple(shape)):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def init_process_mesh(shape, axis_names, *, backend: str,
                      device) -> ProcessMesh:
    """Lay a mesh of ``shape`` over the initialized default world (its
    size must be the mesh's) and return this rank's ``ProcessMesh``.
    ``device`` is where the rank's tensors live: ``nccl`` refuses any
    but a CUDA device. Creates one process group per line of each axis; every rank calls
    ``dist.new_group`` for every line in the same order, as the call
    requires."""
    import torch.distributed as dist
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs CUDA tensors")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if not dist.is_initialized():
        raise RuntimeError("init_process_mesh needs the default process "
                           "group initialized (see run_ranks)")
    base = make_mesh(shape, axis_names)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != base.size:
        raise ValueError(f"mesh {dict(base.shape)} has {base.size} "
                         f"positions; the world has {world} ranks")
    dims = tuple(base.shape.values())
    coords = mesh_coords(rank, dims)
    groups = {}
    for a, name in enumerate(base.axis_names):
        others = [range(s) if i != a else [0] for i, s in enumerate(dims)]
        for fixed in itertools.product(*others):
            line = []
            for j in range(dims[a]):
                c = list(fixed)
                c[a] = j
                line.append(_rank_of(c, dims))
            g = dist.new_group(line, backend=backend)
            if rank in line:
                groups[name] = g
    return ProcessMesh(base.axis_names, base.shape,
                       coords=dict(zip(base.axis_names, coords)),
                       groups=groups)


def _rank_of(coords, dims) -> int:
    r = 0
    for c, s in zip(coords, dims):
        r = r * s + c
    return r


def free_port() -> int:
    """A free TCP port on localhost (bound once, then released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, args, results):
    import torch.distributed as dist
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{port}", world_size=world, rank=rank)
        out = fn(rank, *args)
        results.put((rank, True, out))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, args=(), *, backend: str, timeout: float):
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (the ``spawn``
    start method) joined in one default process group of ``backend`` on a
    free localhost port. Returns the ranks' return values in rank order.
    Raises if any rank raises, exits non-zero or has not finished within
    ``timeout`` seconds (the rest are then terminated): a hung rendezvous
    fails instead of hanging. ``fn`` must be importable by name, and its
    arguments and result picklable."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, backend, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got, errors = {}, {}
    try:
        # drain the queue before joining; stop at the first failure (the
        # other ranks may be waiting on the failed one in a collective)
        while len(got) < world and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    time.sleep(1.0)                 # let its report land
                    if results.empty():
                        break
                continue
            (got if ok else errors)[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1) if not errors
                   else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    codes = [p.exitcode for p in procs]
    if errors or len(got) < world or any(c != 0 for c in codes):
        detail = "".join(f"\n--- rank {r} ---\n{tb}"
                         for r, tb in sorted(errors.items()))
        raise RuntimeError(f"run_ranks: {len(got)} of {world} ranks "
                           f"finished within {timeout} s; exit codes "
                           f"{codes}{detail}")
    return [got[r] for r in range(world)]
