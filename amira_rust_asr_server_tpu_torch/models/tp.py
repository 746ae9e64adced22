"""Layers split over a device mesh: the port's counterpart of what GSPMD
does with the reference's sharded parameters.

``parallel/mesh.shard_params`` turns every parameter into a DTensor on a
``torch.distributed`` device mesh and registers :class:`Gathered` over it,
so any code that reads the parameter (``module.weight``) gets the whole
tensor, gathered over the mesh. The layers here read the DTensor itself
(:func:`sharded`) and split their work over the ``model`` axis instead:

- a dense layer whose weight ``[out, in]`` is ``Shard(0)`` over ``model``
  (column-parallel) computes its slice of the output features, then
  all-gathers them; ``Shard(1)`` (row-parallel) takes its slice of the
  input features and all-reduces the partial products;
- a convolution whose weight ``[out, in/g, k]`` is ``Shard(0)`` computes
  its output channels (a grouped one from the matching input channels),
  then all-gathers them;
- a mixture-of-experts layer whose expert stacks are ``Shard(0)`` runs its
  experts on every token and all-reduces the gated sum (expert
  parallelism).

Activations are plain tensors, whole over the ``model`` axis; each rank
holds its own share of the batch on the ``data`` axis. A parameter's view
is gathered over ``data`` (FSDP shards) and keeps its ``model`` shard, and
its gradient is declared ``Partial`` over ``data``, since each data rank
saw its own batch: DTensor's backward then all-reduces (replicated) or
reduce-scatters (FSDP) it into the parameter's placement. The activation
collectives are three autograd functions on the ``model`` group, Megatron's
copy (identity, gradient all-reduced), reduce and gather.

Nothing here runs without a mesh: a parameter that is not a DTensor
takes the plain path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Gathered(nn.Module):
    """The parametrization of a parameter placed on a mesh: whoever reads
    it gets the whole tensor, with its gradient declared ``Partial`` over
    ``data`` and replicated elsewhere."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return param_view(x)


def sharded(module: nn.Module, name: str):
    """The DTensor behind ``module.<name>`` when the parameter is placed on
    a mesh, else None."""
    if not parametrize.is_parametrized(module, name):
        return None
    return getattr(module.parametrizations, name).original


def param_view(p, keep: Optional[str] = None) -> torch.Tensor:
    """The plain tensor a rank computes with: ``p`` gathered over every
    mesh axis but ``keep``, whose shard it keeps."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    names = mesh.mesh_dim_names
    target = [pl if names[i] == keep else Replicate()
              for i, pl in enumerate(p.placements)]
    if torch.is_inference_mode_enabled():
        # serving: no gradient, and DTensor's redistribute has no
        # inference-mode path in every torch release (2.11 raises on
        # aten.detach_), so it runs outside it
        with torch.inference_mode(False), torch.no_grad():
            return p.redistribute(mesh, target).to_local()
    grads = [Partial() if names[i] == DATA_AXIS else pl
             for i, pl in enumerate(target)]
    return p.redistribute(mesh, target).to_local(grad_placements=grads)


def model_shard(p) -> Optional[int]:
    """The tensor dim ``p`` is sharded on over ``model``, or None."""
    names = p.device_mesh.mesh_dim_names or ()
    if MODEL_AXIS not in names:
        return None
    pl = p.placements[names.index(MODEL_AXIS)]
    return pl.dim if pl.is_shard() else None


def _model(p):
    mesh = p.device_mesh
    return (mesh.get_group(MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS),
            mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS)))


class _Copy(torch.autograd.Function):
    """Identity; the gradient is summed over the group (each rank's
    gradient is its share of the input's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """Sum over the group; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Concatenate the group's tensors along ``dim`` in rank order; the
    gradient is this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim, rank, size):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.dim, ctx.lo, ctx.n = dim, rank * x.shape[dim], x.shape[dim]
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None, \
            None, None


def linear(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, lin.weight, lin.bias)`` in the working type, split over
    ``model`` when the weight is sharded there."""
    w = sharded(lin, "weight")
    dim = None if w is None else model_shard(w)
    if dim is None:
        return nn.functional.linear(x, lin.weight, lin.bias)
    group, rank, size = _model(w)
    w_loc = param_view(w, keep=MODEL_AXIS)
    x = _Copy.apply(x, group)
    if dim == 0:   # column-parallel: this rank's output features
        y = _Gather.apply(nn.functional.linear(x, w_loc), group,
                          x.dim() - 1, rank, size)
    else:          # row-parallel: this rank's input features
        k = w_loc.shape[1]
        y = _Reduce.apply(nn.functional.linear(x.narrow(-1, rank * k, k),
                                               w_loc), group)
    return y if lin.bias is None else y + lin.bias


def conv1d(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``F.conv1d`` of ``x [B, C, T]`` (already padded) with ``conv``'s
    weight, bias, stride and groups, split over ``model`` when the output
    channels are sharded there."""
    f = nn.functional.conv1d
    w = sharded(conv, "weight")
    dim = None if w is None else model_shard(w)
    if dim is None:
        return f(x, conv.weight, conv.bias, stride=conv.stride,
                 groups=conv.groups)
    if dim != 0:
        raise ValueError(f"a convolution shards its output channels, not "
                         f"dim {dim}")
    group, rank, size = _model(w)
    w_loc = param_view(w, keep=MODEL_AXIS)
    x = _Copy.apply(x, group)
    groups = conv.groups
    if groups > 1:  # each rank's groups read their own input channels
        if groups % size:
            raise ValueError(f"{groups} groups over {size} ranks")
        cin = x.shape[1] // size
        x, groups = x.narrow(1, rank * cin, cin), groups // size
    y = _Gather.apply(f(x, w_loc, None, stride=conv.stride, groups=groups),
                      group, 1, rank, size)
    return y + conv.bias[:, None]


def experts(moe: nn.Module):
    """``(w1, b1, w2, b2, first, group)``: this rank's expert stacks, the
    index of its first expert and the group to sum over (None when every
    rank runs every expert)."""
    w1 = sharded(moe, "w1")
    if w1 is None or model_shard(w1) != 0:
        return moe.w1, moe.b1, moe.w2, moe.b2, 0, None
    group, rank, _ = _model(w1)
    local = [param_view(sharded(moe, n), keep=MODEL_AXIS)
             for n in ("w1", "b1", "w2", "b2")]
    return (*local, rank * local[0].shape[0], group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_over(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)
