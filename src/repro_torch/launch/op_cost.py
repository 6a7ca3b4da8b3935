"""Operation cost of an eager PyTorch program, counted per aten op (the
counterpart of ``repro.launch.hlo_cost``, which reads optimized HLO).

``OpCost`` is a ``TorchDispatchMode``: every aten op that runs inside it
— forward, the autograd backward, and on meta tensors as on real ones —
is counted as it runs, and ``aggregate()`` returns the reference's keys:

  * flops        — the matmul-class ops (``mm``, ``addmm``, ``bmm``,
                   ``baddbmm``, ``mv``, ``dot``; ``einsum`` and ``@``
                   lower to them): 2 · prod(result) · prod(contracting
                   dims); an add fused into ``addmm``/``baddbmm`` is not
                   counted, as the reference counts dots only
  * bytes        — Σ operand + result bytes of every op that is not a
                   view (views move nothing) and not an uninitialized
                   allocation. An eager program does not fuse: every
                   intermediate is written and read again, so this is an
                   UPPER bound on what XLA's fused program moves (the
                   reference counts a fusion's call site only)
  * collectives  — bytes per kind (``all-reduce``, ``all-gather``,
                   ``reduce-scatter``, ``all-to-all``, ``broadcast``) of
                   each c10d op the program issues: the bytes of its
                   result tensors, as the reference counts them

``by_op`` keeps the bytes per aten op name ({name: bytes}), so that two
counts of one program (on the card and on meta tensors) can be told
apart op by op.

No trip counts: a Python loop over layers runs every iteration, each
counted as it runs. Composite ops are counted as the ops they decompose
into, with or without autograd (``torch.inference_mode`` hands the mode
``matmul`` and ``einsum`` whole). The exception is ``F.one_hot``, whose
decomposition ATen picks by device: zeros + ``scatter_`` on CUDA,
arange + ``eq`` + a cast on meta (and on the CPU under
``inference_mode``). A ``TorchFunctionMode`` sees it above that choice
and counts it as ONE op named ``one_hot``, with its operand and result
bytes as any other op; the aten ops it runs inside are not counted. So
a program counts the same bytes on every device. A kernel launched
outside aten (the port's CUDA kernels, through ``ctypes``) is not
seen.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = {"allreduce_": "all-reduce", "allreduce_coalesced_":
               "all-reduce", "allgather_": "all-gather",
               "_allgather_base_": "all-gather",
               "allgather_into_tensor_coalesced_": "all-gather",
               "reduce_scatter_": "reduce-scatter",
               "_reduce_scatter_base_": "reduce-scatter",
               "reduce_scatter_tensor_coalesced_": "reduce-scatter",
               "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
               "broadcast_": "broadcast"}
#: the op counted whole (the builtin, whatever later rebinds ``F.one_hot``)
_ONE_HOT = F.one_hot
#: allocations whose result nothing has written yet
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _prod(xs) -> int:
    return math.prod(int(v) for v in xs)


def matmul_flops(name: str, args, out) -> int:
    """2 · prod(result) · prod(contracting dims) of one matmul-class op
    (0 for any other op)."""
    if name in ("mm", "bmm", "mv", "dot"):
        a = args[0]
    elif name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        return 0
    return 2 * _prod(out.shape) * int(a.shape[-1])


class _OneHot(TorchFunctionMode):
    """The function-level half of :class:`OpCost`: runs ``F.one_hot``
    with the aten count paused and counts it once. A mode, and not an
    explicit one-hot in the models, because the models call
    ``F.one_hot`` as the reference's do, and the per-op byte table that
    chip_smoke.py phase 13 (c) prints and holds across devices keeps
    one ``one_hot`` row for it."""

    def __init__(self, cost: "OpCost"):
        super().__init__()
        self.cost = cost

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not _ONE_HOT:
            return func(*args, **kwargs)
        self.cost._paused += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self.cost._paused -= 1
        self.cost.n_ops += 1
        self.cost._count_bytes("one_hot", args, kwargs, out)
        return out


class OpCost(TorchDispatchMode):
    """Count the aten ops run inside ``with OpCost() as c:``; read
    ``c.aggregate()`` after."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {}
        self.n_ops = 0
        self.by_op = {}
        self._paused = 0
        self._depth = 0
        self._one_hot = _OneHot(self)

    def __enter__(self):
        # the dispatch handler re-enters this mode (``with self``) to
        # decompose; the function mode belongs to the outermost entry
        if self._depth == 0:
            self._one_hot.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._one_hot.__exit__(*exc)

    def _count_bytes(self, name, args, kwargs, out):
        n = sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        self.bytes += n
        self.by_op[name] = self.by_op.get(name, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        # a composite op (``matmul``, ``einsum`` under inference mode,
        # where autograd does not decompose them first) is counted as
        # the ops it decomposes into
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.n_ops += 1
        if func.namespace == "c10d":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self.coll[kind] = self.coll.get(kind, 0) + sum(
                    _nbytes(t) for t in _tensors(args[0]))
            return out
        self.flops += matmul_flops(name, args, out)
        if not func.is_view and name not in _UNWRITTEN:
            self._count_bytes(name, args, kwargs, out)
        return out

    def aggregate(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": {k: float(v) for k, v in self.coll.items()},
                "n_ops": self.n_ops}


def aggregate(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under ``OpCost`` and return its
    aggregate."""
    with OpCost() as c:
        fn(*args, **kwargs)
    return c.aggregate()
