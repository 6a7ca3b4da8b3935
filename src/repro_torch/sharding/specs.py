"""Sharding rules of the port (the counterpart of
``repro.sharding.specs``): Megatron-style TP on the ``model`` axis, DP
over (``pod``, ``data``), ZeRO-1 optimizer-state sharding over ``data``.

A spec is a tuple with one entry per dim of its leaf: an axis name, a
tuple of axis names, or ``None`` (a ``PartitionSpec``'s content; a
one-axis tuple is written as the axis name, as ``PartitionSpec`` keeps
it). ``replicated_specs`` gives the empty spec ``()``, as ``P()``.

All rules are DIVISIBILITY-AWARE: a dim that the model-axis size does
not divide stays replicated (e.g. arctic's 56 Q heads shard on the fused
head·dim axis of 7168 instead). Per-layer stacked leaves keep a leading
layer axis that is never sharded. The name sets and rules are copies of
the reference's, so both packages give every leaf the same spec
(tests/test_torch_specs.py). The reference's ``to_shardings`` has no
counterpart: ``shard_shape`` and ``local_slice`` take its place.

ZeRO-1 note (DESIGN.md §6): sharding optimizer state over ``data`` is
the analogue of FastPersist's byte-partitioning across DP ranks — each
DP rank persists exactly the state it owns; ``zero1_ownership`` projects
it onto the checkpoint's byte stream for the owned-span restore.
"""
from __future__ import annotations

from typing import Tuple

# leaf names whose LAST dim carries TP (column-parallel)
_COL = {"wq", "wk", "wv", "wi", "wg", "in_proj", "wq_a", "wq_b",
        "wkv_a", "wkv_b", "bq", "bk", "bv"}
# leaf names whose SECOND-TO-LAST dim carries TP (row-parallel)
_ROW = {"wo", "out_proj"}
_REPLICATED = {"router", "conv_w", "conv_b", "dt_bias", "A_log", "D",
               "norm", "ln", "ln1", "ln2", "ln1b", "ln2b", "ln_x",
               "q_norm", "kv_norm", "final_norm", "enc_norm", "vis_proj",
               "step"}


def map_with_path(fn, tree, path=()):
    """``tree`` (nested dicts, NamedTuples, lists, tuples) with
    ``fn(path, leaf)`` at every leaf. ``path`` is a tuple of strings: a
    dict key, ``.field`` for a NamedTuple field, the index of a sequence
    item (the reference's key-path names)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _axes(axes):
    """A spec entry: one axis as its name, several as a tuple."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _msize(mesh) -> int:
    return mesh.shape["model"]


def param_spec(path, shape, mesh, n_stack_axes: int = 0) -> tuple:
    """The spec of one parameter leaf.

    n_stack_axes: how many leading stacked-layer axes the leaf has (1 for
    transformer/ssm stacks, 2 for zamba2 (group, layer) stacks, 0 for
    unstacked leaves like embed)."""
    name = path[-1]
    m = _msize(mesh)
    rank = len(shape)
    body = shape[n_stack_axes:]
    spec = [None] * rank

    def ok(dim):
        return body[dim] % m == 0

    if name in _REPLICATED or rank == n_stack_axes or len(body) <= 1:
        return tuple(spec)
    # MoE expert stacks: (..., E, d, ff) rank-3 bodies under wi/wg/wo —
    # expert-parallel on the E axis
    if name in ("wi", "wg", "wo") and len(body) == 3:
        if body[0] % m == 0:
            spec[n_stack_axes] = "model"
        return tuple(spec)
    if name == "embed":
        if body[0] % m == 0:
            spec[n_stack_axes] = "model"     # vocab-parallel embedding
        return tuple(spec)
    if name == "lm_head":
        if body[-1] % m == 0:
            spec[rank - 1] = "model"
        return tuple(spec)
    if name in _COL:
        if ok(-1):
            spec[rank - 1] = "model"
        return tuple(spec)
    if name in _ROW:
        if ok(-2):
            spec[rank - 2] = "model"
        return tuple(spec)
    return tuple(spec)


def _stack_axes_for(path) -> int:
    if "ssm_layers" in path:       # zamba2: (group, layer, ...)
        return 2
    if "inv_norms" in path:
        return 1
    if any(n in ("layers", "enc_layers", "dec_layers") for n in path):
        return 1
    return 0


def param_specs(params_tree, mesh):
    """The spec tree of a model's parameters (meta tensors will do)."""
    return map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh,
                                      _stack_axes_for(path)),
        params_tree)


def zero1_specs(params_tree, mesh):
    """Optimizer-state specs: TP spec + shard the first still-replicated,
    divisible dim over ``data`` (ZeRO-1)."""
    d = mesh.shape.get("data", 1)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = list(param_spec(path, shape, mesh, _stack_axes_for(path)))
        for i, (s, dim) in enumerate(zip(spec, shape)):
            if s is None and dim % d == 0 and dim >= d:
                spec[i] = "data"
                break
        return tuple(spec)

    return map_with_path(one, params_tree)


def batch_specs(batch_tree, mesh):
    """Input batches: leading (global-)batch dim over (pod, data)."""
    dp = dp_axes(mesh)
    dpsize = 1
    for a in dp:
        dpsize *= mesh.shape[a]

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if shape and shape[0] % dpsize == 0 and shape[0] > 1:
            spec[0] = _axes(dp)
        return tuple(spec)

    return map_with_path(one, batch_tree)


def cache_specs(cache_tree, mesh, batch_size: int):
    """KV/SSM cache specs: batch dim over (pod, data) when divisible,
    else the sequence dim over ``model`` (long-context single-request)."""
    dp = dp_axes(mesh)
    dpsize = 1
    for a in dp:
        dpsize *= mesh.shape[a]
    m = _msize(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        # the batch axis: the first axis equal to batch_size
        b_ax = next((i for i, s in enumerate(shape) if s == batch_size),
                    None)
        if b_ax is not None and batch_size % dpsize == 0 and batch_size > 1:
            spec[b_ax] = _axes(dp)
        # shard the (large) sequence axis over model if present+divisible
        if path[-1] in ("k", "v", "latent"):
            seq_ax = (b_ax + 1) if b_ax is not None else len(shape) - 3
            if shape[seq_ax] % m == 0 and shape[seq_ax] >= m * 128:
                spec[seq_ax] = "model"
        return tuple(spec)

    return map_with_path(one, cache_tree)


def replicated_specs(tree):
    """The empty (fully replicated) spec for every leaf of a state tree —
    the safe default for a rank-elastic restore onto a mesh the writer
    never saw; swap in :func:`param_specs` / :func:`zero1_specs` leaves
    where the target mesh should shard."""
    return map_with_path(lambda path, leaf: (), tree)


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a leaf of ``shape`` under
    ``spec``: each dim divided by the sizes of the axes it is split
    over. The rules only split dims those sizes divide."""
    shape = tuple(shape)
    out = list(shape)
    for i, entry in enumerate(spec):
        n = 1
        for a in _entry_axes(entry):
            n *= mesh.shape[a]
        if shape[i] % n:
            raise ValueError(f"dim {i} of {shape} does not split over "
                             f"{entry!r} ({n})")
        out[i] = shape[i] // n
    return tuple(out)


def local_slice(t, spec, mesh, coords: dict | None = None):
    """The shard of tensor ``t`` that the device at mesh ``coords``
    ({axis: index}; by default ``mesh.coords``, a ``ProcessMesh``'s own
    rank) holds under ``spec``: for a dim split over several axes, the
    shard index is row-major over them, as JAX orders it."""
    coords = mesh.coords if coords is None else coords
    idx = []
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            idx.append(slice(None))
            continue
        n, k = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            k = k * mesh.shape[a] + coords[a]
        step = t.shape[i] // n
        idx.append(slice(k * step, (k + 1) * step))
    return t[tuple(idx)]


def zero1_ownership(records, n_readers: int) -> dict:
    """Project ZeRO-1 ownership onto the checkpoint BYTE stream for the
    parallel restore path (``partition.make_read_plan``): map each
    manifest record to the tensor-relative byte ranges each DP reader
    rank owns, ``{name: [(reader, lo, hi), ...]}``.

    Mirrors :func:`zero1_specs`'s rule in the only form that stays
    byte-contiguous on disk: a leaf whose LEADING dim divides by
    ``n_readers`` is split into row blocks (contiguous bytes in C
    order — rank *r* reads exactly its optimizer-state shard); any
    other leaf falls back to balanced byte striping, so the union of
    all ranks' spans always covers every tensor exactly once (the
    load-then-allgather invariant). ``records`` are manifest
    ``TensorRecord``s — their ``shape``/``nbytes`` describe the
    ON-STREAM layout, which is what restore reads."""
    own = {}
    for rec in records:
        n = rec.nbytes
        if n == 0:
            own[rec.name] = []
            continue
        rows = rec.shape[0] if rec.shape else 0
        if rows and rows % n_readers == 0 and n % rows == 0:
            row_bytes = n // rows
            blk = (rows // n_readers) * row_bytes
            own[rec.name] = [(r, r * blk, (r + 1) * blk)
                             for r in range(n_readers)]
        else:
            base, rem = divmod(n, n_readers)
            ranges, lo = [], 0
            for r in range(n_readers):
                ln = base + (1 if r < rem else 0)
                if ln:
                    ranges.append((r, lo, lo + ln))
                lo += ln
            own[rec.name] = ranges
    return own
