"""Expert-parallel MoE across processes (the counterpart of
``repro.sharding.moe_ep``, where ``jax.shard_map`` runs the body).

Each rank of a ``ProcessMesh`` (``launch/mesh.py``) runs the whole model
on its data shard's tokens, so activations are replicated over the
``model`` axis and split over ``data``, as in the reference:

  * the dispatch gathers are LOCAL: every model rank already holds the
    tokens it needs, so no collective moves them;
  * expert weights are split over ``model`` (E_loc = E / |model|,
    ``local_params``); each rank runs only its experts and contributes
    zeros for tokens routed elsewhere;
  * one ``all_reduce(SUM)`` over the ``model`` group combines the
    experts' outputs — the reference's ``psum``, and the layer's only
    collective in the forward.

The aux loss is each data shard's own load-balance loss, averaged over
the ``data`` group (the reference's ``pmean``), not the aux of the
global batch.

Gradients: every model rank computes the same loss on the replicated
output, so the cotangent of each rank's partial output is the output's
own cotangent: the sum's backward passes it on unchanged (a backward
that summed again would scale it by |model|). The replicated inputs of
the partial path (the tokens gathered for the local experts and the gate
values) carry the other half of the Megatron pair: identity forward,
``all_reduce(SUM)`` backward, so the gradient of x and of the router is
the full one on every rank, and each expert slice gets its own. The
data-shard mean's backward divides by |data|: summing the ranks'
gradients over ``data`` (as data parallelism does) gives the gradient of
the mean.

With a ``Mesh`` that only describes a mesh (no processes; the dry run
on meta tensors), the body runs once over the global batch: the data
shards as its groups, all experts local, no collective. Its operations
are the ranks' own, summed over the mesh, except that the router's
logits, which every model rank computes for its tokens, are counted
once per data shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import layers as ly
from repro_torch.sharding.specs import local_slice

_EXPERT_LEAVES = ("wi", "wg", "wo")


#: every tensor handed to a collective is cloned contiguous: gloo reads a
#: tensor's memory in storage order, so two ranks whose strides differ
#: would sum mismatched elements (a broadcast of a strided tensor into a
#: contiguous one delivers them permuted)


class _SumOverModel(torch.autograd.Function):
    """all_reduce(SUM) forward; the cotangent passes on unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all_reduce(SUM) of the cotangent backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOverData(torch.autograd.Function):
    """all_reduce mean forward; the cotangent over |data| backward."""

    @staticmethod
    def forward(ctx, t, group, n):
        import torch.distributed as dist
        ctx.n = n
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _local_moe(p, x, cfg, *, n_groups, e0, capacity_factor, to_model=None):
    """The per-shard body (moe_ep.py:34-85 of the reference), over
    ``n_groups`` groups of x's tokens at once. p holds this rank's expert
    slices (E_loc, D, F) and the replicated router; experts e0 .. e0 +
    E_loc are local. Returns (partial out (B, L, D), aux).

    As the reference: C from the LOCAL token count; f32 router logits
    (``ly.moe_route``: ties go to the lower expert, as ``lax.top_k``);
    the (token, k) pairs sorted stably by (group, expert), a pair at
    position ≥ C in its expert dropped; the expert einsums in x's dtype.
    ``.at[dest].set(mode="drop")`` is a write into a buffer with one
    spare slot at E_loc·C, cut off after. ``to_model`` wraps the inputs
    of the partial path (see the module docstring)."""
    B, L, D = x.shape
    E = cfg.moe.n_experts
    E_loc = p["wi"].shape[0]
    r = ly.moe_route(p, x, cfg, n_groups=n_groups,
                     capacity_factor=capacity_factor)
    G, T, C = r.G, r.T, r.C
    K = r.gate_i.shape[-1]
    dev = x.device
    xt, gate_v = x.reshape(G * T, D), r.gate_v
    if to_model is not None:
        xt, gate_v = to_model(xt), to_model(gate_v)
    TK = T * K
    # each (group, token, k) keyed by group, then expert
    key = (r.gate_i.reshape(G, TK)
           + E * torch.arange(G, device=dev)[:, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    counts = torch.zeros(G * E, dtype=torch.long, device=dev).index_add_(
        0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(G * TK, device=dev) - starts[sorted_key]
    sorted_g, sorted_e = sorted_key // E, sorted_key % E
    keep = (sorted_e >= e0) & (sorted_e < e0 + E_loc) & (pos_in_e < C)
    S = G * E_loc * C
    slot = ((sorted_g * E_loc + (sorted_e - e0).clamp(0, E_loc - 1)) * C
            + pos_in_e.clamp(0, C - 1))
    dest = torch.where(keep, slot, S)
    src_tok = torch.full((S + 1,), G * T, dtype=torch.long, device=dev)
    src_tok[dest] = order // K                       # (g·T + t)
    x_pad = torch.cat([xt, xt.new_zeros(1, D)])
    ex_in = x_pad[src_tok[:S]].reshape(G, E_loc, C, D)   # LOCAL gather
    ex_out = ly._expert_ffn(p, ex_in, "g")
    slot_tk = torch.full((G * TK,), S, dtype=torch.long, device=dev)
    slot_tk[order] = dest
    out_pad = torch.cat([ex_out.reshape(S, D), ex_out.new_zeros(1, D)])
    picked = out_pad[slot_tk].reshape(G, T, K, D)
    partial = torch.einsum("gtk,gtkd->gtd", gate_v.to(x.dtype), picked)
    aux = ly._moe_aux(cfg, r, F.one_hot(r.gate_i, E).float())
    return partial.reshape(B, L, D), aux


def expert_range(mesh, n_experts: int):
    """(e0, E_loc): the experts this rank's ``model`` coordinate holds."""
    n_model = mesh.shape["model"]
    if n_experts % n_model:
        raise ValueError(f"{n_experts} experts do not split over "
                         f"{n_model} model ranks")
    E_loc = n_experts // n_model
    return mesh.coords["model"] * E_loc, E_loc


#: the spec of one layer's expert stack (E, ...): experts over ``model``
EXPERT_SPEC = ("model", None, None)


def local_params(params, mesh):
    """``params`` (a model's tree) with every MoE expert stack — a
    ``wi``/``wg``/``wo`` leaf (L, E, ...) under ``mlp`` — cut to this
    rank's slice (``specs.local_slice`` under ``(None,) +
    EXPERT_SPEC``), cloned so the full stack can be freed; every other
    leaf is kept as it is (replicated)."""
    def walk(tree, in_mlp):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_mlp or k == "mlp")
            elif in_mlp and k in _EXPERT_LEAVES and v.dim() == 4:
                out[k] = local_slice(v, (None,) + EXPERT_SPEC,
                                     mesh).clone()
            else:
                out[k] = v
        return out
    return walk(params, False)


def make_moe_ep(mesh):
    """Returns ``moe_kernel(p, x, cfg) -> (out, aux)`` for
    ``transformer._block``: x is this rank's tokens (B_loc, L, D) and p
    its layer's MoE params with LOCAL expert slices (``local_params``).
    ``dense_residual`` is added after the reduction, on the full x.

    ``mesh``: a ``ProcessMesh`` runs across its processes; a ``Mesh``
    (a description) takes meta tensors only — the dry run's count of the
    whole mesh's work (see the module docstring)."""
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    n_data = 1
    for a in data_axes:
        n_data *= mesh.shape[a]
    groups = mesh.groups if isinstance(mesh, ProcessMesh) else None
    if groups is not None and len(data_axes) > 1:
        raise ValueError("moe_ep across processes takes one data axis; "
                         f"the mesh has {data_axes}")

    def moe_kernel(p, x, cfg):
        cf = cfg.moe.capacity_factor
        if groups is None:
            if x.device.type != "meta":
                raise ValueError("a mesh description runs meta tensors "
                                 "only; pass a ProcessMesh")
            out, aux = _local_moe(p, x, cfg, n_groups=n_data, e0=0,
                                  capacity_factor=cf)
        else:
            e0, E_loc = expert_range(mesh, cfg.moe.n_experts)
            if p["wi"].shape[0] != E_loc:
                raise ValueError(f"expert stack of {p['wi'].shape[0]} on "
                                 f"a rank that holds {E_loc}: pass "
                                 f"local_params")
            g_model = groups["model"]
            out, aux = _local_moe(
                p, x, cfg, n_groups=1, e0=e0, capacity_factor=cf,
                to_model=lambda t: _CopyToModel.apply(t, g_model))
            out = _SumOverModel.apply(out, g_model)
            if data_axes:
                aux = _MeanOverData.apply(aux, groups[data_axes[0]],
                                          n_data)
        if cfg.moe.dense_residual:
            out = out + ly.mlp(p["dense"], x, gated=cfg.gated_mlp,
                               act=F.silu)
        return out, aux

    return moe_kernel
