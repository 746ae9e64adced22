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
- attention computes its share of the heads on each rank (:class:`Heads`):
  the rows of those heads in q, k and v, read from the whole qkv weight
  (``Shard(0)`` of ``[3d, d]`` does not fall on heads), and the matching
  input columns of the output projection, whose partial products are
  summed over the group; when the heads do not divide over ``model``,
  attention stays whole, as ``fit_spec`` drops an axis that does not
  divide;
- a mixture-of-experts layer whose expert stacks are ``Shard(0)`` runs its
  experts on every token and all-reduces the gated sum (expert
  parallelism).

Activations between these layers are plain tensors, whole over the
``model`` axis, except inside the encoder's blocks under
:class:`TimeShards` (Megatron-SP, the sequence-parallel loss): there each
rank holds its share of the frames through the norms, residuals, gains and
feed-forwards, the sequence is gathered only into the projections that
need it (attention's, the conv module's pointwise ones) and the partial
products come back reduce-scattered over time. Each rank holds its own
share of the batch on the ``data`` axis. A parameter's view is gathered
over ``data`` (FSDP shards) and keeps its ``model`` shard, and its
gradient is declared ``Partial`` over ``data``, since each data rank saw
its own batch (and over ``model`` where each model rank computed its own
share of the work: its heads, its frames): DTensor's backward then
all-reduces (replicated) or reduce-scatters (sharded) it into the
parameter's placement. The activation collectives are autograd functions
on the ``model`` group.

Nothing here runs without a mesh, nor on a ``model`` axis of 1: a
parameter that is not a DTensor, or not split over more than one rank,
takes the plain path, with no collective.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F
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


def param_view(p, keep: Optional[str] = None,
               split: bool = False) -> torch.Tensor:
    """The plain tensor a rank computes with: ``p`` gathered over every
    mesh axis but ``keep``, whose shard it keeps. ``split``: each rank of
    ``model`` computes its own share of the work with it, so its gradient
    is declared ``Partial`` over ``model`` too."""
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
    partial = (DATA_AXIS, MODEL_AXIS) if split else (DATA_AXIS,)
    grads = [Partial() if names[i] in partial and names[i] != keep else pl
             for i, pl in enumerate(target)]
    return p.redistribute(mesh, target).to_local(grad_placements=grads)


def model_group(p) -> Optional[Tuple[object, int, int]]:
    """``(group, rank, size)`` of the ``model`` axis of ``p``'s mesh, or
    None when ``p`` is not placed on a mesh with a ``model`` axis of more
    than one rank (the plain path)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return None
    mesh = p.device_mesh
    names = mesh.mesh_dim_names or ()
    if MODEL_AXIS not in names:
        return None
    size = mesh.size(names.index(MODEL_AXIS))
    if size == 1:
        return None
    return mesh.get_group(MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS), size


def model_shard(p) -> Optional[int]:
    """The tensor dim ``p`` is sharded on over a ``model`` axis of more
    than one rank, or None (the plain path)."""
    if model_group(p) is None:
        return None
    pl = p.placements[p.device_mesh.mesh_dim_names.index(MODEL_AXIS)]
    return pl.dim if pl.is_shard() else None


# -- the collectives ----------------------------------------------------------
def _all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group,
                    size: int) -> torch.Tensor:
    """The group's sum of ``x``, this rank's block of ``dim``."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group,
                size: int) -> torch.Tensor:
    """``x``'s blocks along ``split_dim`` sent to the group's ranks in
    order, the blocks received concatenated along ``cat_dim`` in rank
    order."""
    send = torch.stack(x.chunk(size, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat_dim)


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
    gradient is this rank's slice (every rank's consumer computed the
    same)."""

    @staticmethod
    def forward(ctx, x, group, dim, rank, size):
        ctx.dim, ctx.lo, ctx.n = dim, rank * x.shape[dim], x.shape[dim]
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None, \
            None, None


class _Split(torch.autograd.Function):
    """This rank's block of ``dim`` (a copy of its own); the gradient is
    the group's blocks gathered whole (every rank's producer computed the
    same)."""

    @staticmethod
    def forward(ctx, x, group, dim, rank, size):
        ctx.group, ctx.dim, ctx.size = group, dim, size
        n = x.shape[dim] // size
        return x.narrow(dim, rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.size), None, None, \
            None, None


class _GatherSum(torch.autograd.Function):
    """Concatenate the group's tensors along ``dim``; the gradient is the
    group's sum of each rank's, this rank's block (every rank's consumer
    computed its own share)."""

    @staticmethod
    def forward(ctx, x, group, dim, size):
        ctx.group, ctx.dim, ctx.size = group, dim, size
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.size), None, \
            None, None


class _ScatterSum(torch.autograd.Function):
    """The group's sum of ``x``, this rank's block of ``dim``; the gradient
    is the group's blocks gathered whole."""

    @staticmethod
    def forward(ctx, x, group, dim, size):
        ctx.group, ctx.dim, ctx.size = group, dim, size
        return _reduce_scatter(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.size), None, None, \
            None


class _Relayout(torch.autograd.Function):
    """From blocks of ``cat_dim`` (whole ``split_dim``) on each rank to
    blocks of ``split_dim`` (whole ``cat_dim``): one all-to-all, its
    gradient the reverse one."""

    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim, size):
        ctx.args = group, split_dim, cat_dim, size
        return _all_to_all(x, split_dim, cat_dim, group, size)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, cat_dim, size = ctx.args
        return _all_to_all(g, cat_dim, split_dim, group, size), None, None, \
            None, None


class _GatherLinear(torch.autograd.Function):
    """``F.linear`` of ``x`` gathered over time (dim 1) from the group's
    time blocks, keeping only this rank's block for the backward, which
    gathers it again (Megatron-SP): the input's gradient is the group's
    sum, reduce-scattered back over time."""

    @staticmethod
    def forward(ctx, x, w, b, group, size):
        ctx.group, ctx.size, ctx.has_bias = group, size, b is not None
        ctx.save_for_backward(x, w)
        return F.linear(_all_gather(x, 1, group, size), w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        whole = _all_gather(x, 1, ctx.group, ctx.size)
        dx = _reduce_scatter(g @ w, 1, ctx.group, ctx.size)
        dw = g.reshape(-1, g.shape[-1]).t() @ whole.reshape(-1, w.shape[1])
        db = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return dx, dw, db, None, None


# -- tensor-parallel layers -----------------------------------------------------
def linear(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, lin.weight, lin.bias)`` in the working type, split over
    ``model`` when the weight is sharded there."""
    w = sharded(lin, "weight")
    dim = model_shard(w)
    if dim is None:
        return F.linear(x, lin.weight, lin.bias)
    group, rank, size = model_group(w)
    w_loc = param_view(w, keep=MODEL_AXIS)
    x = _Copy.apply(x, group)
    if dim == 0:   # column-parallel: this rank's output features
        y = _Gather.apply(F.linear(x, w_loc), group, x.dim() - 1, rank,
                          size)
    else:          # row-parallel: this rank's input features
        k = w_loc.shape[1]
        y = _Reduce.apply(F.linear(x.narrow(-1, rank * k, k), w_loc), group)
    return y if lin.bias is None else y + lin.bias


def conv1d(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``F.conv1d`` of ``x [B, C, T]`` (already padded) with ``conv``'s
    weight, bias, stride and groups, split over ``model`` when the output
    channels are sharded there."""
    w = sharded(conv, "weight")
    dim = model_shard(w)
    if dim is None:
        return F.conv1d(x, conv.weight, conv.bias, stride=conv.stride,
                        groups=conv.groups)
    if dim != 0:
        raise ValueError(f"a convolution shards its output channels, not "
                         f"dim {dim}")
    group, rank, size = model_group(w)
    w_loc = param_view(w, keep=MODEL_AXIS)
    x = _Copy.apply(x, group)
    groups = conv.groups
    if groups > 1:  # each rank's groups read their own input channels
        if groups % size:
            raise ValueError(f"{groups} groups over {size} ranks")
        cin = x.shape[1] // size
        x, groups = x.narrow(1, rank * cin, cin), groups // size
    y = _Gather.apply(F.conv1d(x, w_loc, None, stride=conv.stride,
                               groups=groups), group, 1, rank, size)
    return y + conv.bias[:, None]


def experts(moe: nn.Module):
    """``(w1, b1, w2, b2, first, group)``: this rank's expert stacks, the
    index of its first expert and the group to sum over (None when every
    rank runs every expert)."""
    w1 = sharded(moe, "w1")
    if model_shard(w1) != 0:
        return moe.w1, moe.b1, moe.w2, moe.b2, 0, None
    group, rank, _ = model_group(w1)
    local = [param_view(sharded(moe, n), keep=MODEL_AXIS)
             for n in ("w1", "b1", "w2", "b2")]
    return (*local, rank * local[0].shape[0], group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_over(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def split_read(module: nn.Module, name: str) -> torch.Tensor:
    """``module.<name>`` whole, its gradient declared ``Partial`` over
    ``model`` (each model rank uses it for its own share of the work)."""
    p = sharded(module, name)
    return getattr(module, name) if p is None else param_view(p, split=True)


# -- attention over heads -------------------------------------------------------
class Heads:
    """The heads of an attention layer (``models/encoder.MHSA``) that this
    rank computes, and the projections in and out of them: ``n`` heads
    from head ``h0``, each ``dh`` wide. Both the batch attention and the
    streaming chunk's (``ops/streaming.py``) run through it.

    Without a split (no mesh, a ``model`` axis of 1, heads that do not
    divide over it, or the int8 path, whose packed weights are whole) it
    holds every head and :meth:`project` / :meth:`combine` are the layer's
    own qkv and output projections (``working_type``: in the working type
    even where the layer serves int8, as the streaming chunk encoder reads
    the unquantized weights). Split, rank ``r`` of ``m`` takes heads
    ``[r H / m, (r + 1) H / m)``: :meth:`project` multiplies by their rows
    of q, k and v, taken from the whole qkv weight (its ``Shard(0)`` rows
    do not fall on heads), and :meth:`combine` by the matching input
    columns of the output projection (placed column-parallel), a
    row-parallel product summed over the group, the bias added once. Both
    weights are read with their gradients ``Partial`` over ``model``. With
    ``seq`` (:class:`TimeShards`) the input is this rank's time block,
    gathered over time into the projection, and the output's sum is
    reduce-scattered back over time."""

    def __init__(self, mhsa: nn.Module, seq: Optional["TimeShards"] = None,
                 working_type: bool = False):
        cfg = mhsa.cfg
        self.mhsa, self.seq = mhsa, seq
        self.d, h = cfg.d_model, cfg.n_heads
        self.dh = self.d // h
        self.dense = linear if working_type else (lambda lin, x: lin(x))
        split = model_group(sharded(mhsa.qkv, "weight"))
        if (split is None or h % split[2]
                or (mhsa.qkv.quant and not working_type)):
            if seq is not None:
                raise ValueError(f"{h} heads do not split over the time "
                                 "shards' group")
            self.group, self.h0, self.n = None, 0, h
            return
        self.group, self.rank, self.size = split
        self.n = h // self.size
        self.h0 = self.rank * self.n

    @property
    def split(self) -> bool:
        return self.group is not None

    def project(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x [B, T, d]`` (with ``seq``: this rank's time block) -> q, k, v
        of this rank's heads, each ``[B, T, n * dh]`` (``T`` whole)."""
        width = self.n * self.dh
        if not self.split:
            return self.dense(self.mhsa.qkv, x).split(width, dim=-1)
        qkv = self.mhsa.qkv
        lo = self.h0 * self.dh
        rows = torch.cat([torch.arange(part * self.d + lo,
                                       part * self.d + lo + width,
                                       device=x.device)
                          for part in range(3)])
        w = split_read(qkv, "weight").index_select(0, rows)
        b = split_read(qkv, "bias").index_select(0, rows)
        if self.seq is not None:
            y = self.seq.gather_linear(x, w, b)
        else:
            y = F.linear(_Copy.apply(x, self.group), w, b)
        return y.split(width, dim=-1)

    def combine(self, o: torch.Tensor) -> torch.Tensor:
        """This rank's heads' outputs ``[B, T, n * dh]`` -> the output
        projection ``[B, T, d]`` (with ``seq``: this rank's time block)."""
        out = self.mhsa.out
        if not self.split:
            return self.dense(out, o)
        cols = torch.arange(self.h0 * self.dh, (self.h0 + self.n) * self.dh,
                            device=o.device)
        y = F.linear(o, split_read(out, "weight").index_select(1, cols))
        if self.seq is not None:
            return self.seq.scatter(y) + split_read(out, "bias")
        return _Reduce.apply(y, self.group) + out.bias

    def whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` over this rank's heads on ``dim`` -> every head's (the
        streaming cache stays whole on every rank; serving only)."""
        if not self.split:
            return t
        return _Gather.apply(t, self.group, dim, self.rank, self.size)


# -- the encoder's blocks on time shards ---------------------------------------
class TimeShards:
    """The sequence-parallel layout of the encoder's blocks (Megatron-SP)
    over a ``model`` group of ``size`` ranks: activations ``[B, T, d]``
    are held as time blocks, rank ``r`` holding frames ``[r n, (r + 1)
    n)``, ``n = T / size`` (:meth:`split` pads ``T`` with masked frames).
    Norms, residuals, gains and the feed-forwards' activations stay on the
    blocks; a projection that needs every frame gathers them
    (:meth:`gather_linear`, which keeps only this rank's block for the
    backward) and its partial products come back reduce-scattered
    (:meth:`scatter`); the conv module's depthwise convolution runs on its
    channel share over every frame (:meth:`to_time` brings it back).

    Every rank computes its own share of the work, so each parameter a
    block reads under it whole has its gradient declared ``Partial`` over
    ``model`` (:func:`split_read`, :meth:`block`): the sum over the group
    is the whole gradient."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    @classmethod
    def over(cls, mesh, cfg) -> Optional["TimeShards"]:
        """The layout over ``mesh``'s ``model`` axis for a model of config
        ``cfg``, or None where the blocks stay whole: a ``model`` axis of 1,
        or widths, heads or experts that do not divide over it (as
        ``fit_spec`` drops an axis that does not divide)."""
        size = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
        if (size == 1 or cfg.d_model % size or cfg.n_heads % size
                or cfg.moe_experts % size):
            return None
        return cls(mesh.get_group(MODEL_AXIS),
                   mesh.get_local_rank(MODEL_AXIS), size)

    # -- the layout
    def split(self, x: torch.Tensor, pad_mask: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [B, T, d]``, whole on every rank (the same values), padded
        on time to a multiple of the group with masked frames -> (this
        rank's block, the padded mask ``[B, T_pad]``, whole)."""
        pad = -x.shape[1] % self.size
        x = F.pad(x, (0, 0, 0, pad))
        pad_mask = F.pad(pad_mask, (0, pad), value=False)
        return (_Split.apply(x, self.group, 1, self.rank, self.size),
                pad_mask)

    def join(self, x: torch.Tensor, t: int) -> torch.Tensor:
        """The group's time blocks -> ``[B, t, d]`` whole on every rank,
        the padding cut (its consumer computes the same on every rank)."""
        return _Gather.apply(x, self.group, 1, self.rank,
                             self.size)[:, :t]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The time blocks gathered whole for a consumer that computes its
        own share on each rank (its gradient summed over the group)."""
        return _GatherSum.apply(x, self.group, 1, self.size)

    def scatter(self, y: torch.Tensor) -> torch.Tensor:
        """Each rank's partial ``[B, T, d]`` -> the group's sum, this
        rank's time block."""
        return _ScatterSum.apply(y, self.group, 1, self.size)

    def to_time(self, y: torch.Tensor) -> torch.Tensor:
        """``[B, T, c]``, this rank's block of the last dim over every
        frame -> ``[B, T / size, c * size]``, every channel of this rank's
        frames."""
        return _Relayout.apply(y, self.group, 1, y.dim() - 1, self.size)

    def gather_linear(self, x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor]) -> torch.Tensor:
        """``F.linear`` of the time blocks gathered whole, saving only this
        rank's block for the backward."""
        return _GatherLinear.apply(x, w, b, self.group, self.size)

    # -- the parameters
    def block(self, module: nn.Module, name: str, dim: int = 0
              ) -> torch.Tensor:
        """This rank's block of ``dim`` of ``module.<name>``: the local
        shard where the parameter is sharded so (its gradient complete for
        the block), else a copy out of the whole parameter (its gradient
        ``Partial`` over ``model``)."""
        p = sharded(module, name)
        if model_shard(p) == dim:
            return param_view(p, keep=MODEL_AXIS)
        whole = split_read(module, name)
        n = whole.shape[dim] // self.size
        return whole.index_select(dim, torch.arange(
            self.rank * n, (self.rank + 1) * n, device=whole.device))

    def layer_norm(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, ln.normalized_shape,
                            split_read(ln, "weight"), split_read(ln, "bias"),
                            ln.eps)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               seq: Optional[TimeShards] = None) -> torch.Tensor:
    """``ln(x)``; under ``seq`` on this rank's time block."""
    return ln(x) if seq is None else seq.layer_norm(ln, x)
