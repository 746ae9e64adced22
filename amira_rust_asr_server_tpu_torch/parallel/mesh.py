"""The device mesh and the placement rules (port of parallel/mesh.py).

A ``torch.distributed`` device mesh with ``data`` and ``model`` axes, one
rank per device: parameters are placed as DTensors, tensor-parallel over
``model`` (column and row splits of the dense layers, the output channels
of the convolutions, the experts of a mixture-of-experts layer) and, with
FSDP, also sharded over ``data``; the batch is split over ``data``. Where
the reference leaves the collectives to GSPMD, the port's layers make them
(``models/tp.py``).

The rule, :func:`param_spec`, is the reference's, read on the reference's
path and shape of each parameter (``convert.jax_leaf``), then mapped onto
the torch dims: a torch ``Linear.weight`` is the transpose of the flax
kernel and a convolution's weight ``[out, in/g, k]`` is the flax ``[k,
in/g, out]`` reversed, so column-parallel ``P(None, "model")`` becomes
``Shard(0)`` of a ``Linear`` weight.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from ..convert import jax_leaf
from ..models.tp import DATA_AXIS, MODEL_AXIS, Gathered

# a reference PartitionSpec: one mesh axis name or None per dim
Spec = Tuple[Optional[str], ...]


def mesh_device_type() -> str:
    """The device type of the default process group's ranks."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Optional[Dict[str, int]] = None):
    """The ``(data, model)`` mesh over every rank of the default process
    group. ``shape`` maps axis name -> size; None/{} puts every rank on
    ``data`` (pure data parallelism)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if not shape:
        shape = {DATA_AXIS: world, MODEL_AXIS: 1}
    sizes = (shape.get(DATA_AXIS, 1), shape.get(MODEL_AXIS, 1))
    n = sizes[0] * sizes[1]
    if n != world:
        raise ValueError(f"mesh needs {n} devices, have {world} (one rank "
                         "per device)")
    return init_device_mesh(mesh_device_type(), sizes,
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def param_spec(path: str, shape: Tuple[int, ...]) -> Spec:
    """The reference's tensor-parallel spec of one parameter, by its
    reference path and shape (megatron-style):

    - embeddings [V, E]: vocab rows over model;
    - mixture-of-experts stacks [E, d, f] / [E, f, d] and their biases
      [E, f] / [E, d]: the expert dim over model (expert parallelism);
    - other matrices [in, out]: the output dim when it is at least the
      input dim (column-parallel: up projections, qkv, gates, the vocab),
      else the input dim (row-parallel: projections back down);
    - conv kernels [k, in, out]: the output channels;
    - biases, norms and other vectors: replicated.
    """
    ndim = len(shape)
    if ndim < 2:
        return (None,) * ndim
    name = path.lower()
    if "embed" in name:
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    if "ff2" in name and ndim == 3:
        return (MODEL_AXIS, None, None)
    if "ff2" in name and ndim == 2 and name.endswith(("b1", "b2")):
        return (MODEL_AXIS, None)
    if ndim == 2:
        d_in, d_out = shape
        return (None, MODEL_AXIS) if d_out >= d_in else (MODEL_AXIS, None)
    if ndim == 3:
        return (None, None, MODEL_AXIS)
    return (None,) * ndim


def fit_spec(spec: Spec, shape: Tuple[int, ...], data: int, model: int,
             fsdp: bool = False) -> Spec:
    """``spec`` on a ``data x model`` mesh: an axis is dropped where the
    dim does not divide by it (replicated: correctness first); with
    ``fsdp`` the largest dim not already sharded that divides by ``data``
    is sharded over it (ZeRO-3)."""
    fixed = [ax if ax == MODEL_AXIS and shape[d] % model == 0 else None
             for d, ax in enumerate(spec)]
    if fsdp and data > 1:
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if fixed[d] is None and shape[d] % data == 0:
                fixed[d] = DATA_AXIS
                break
    return tuple(fixed)


def param_placements(model: nn.Module, mesh_shape: Dict[str, int],
                     fsdp: bool = False) -> Dict[str, Tuple[Spec, tuple]]:
    """For every parameter of ``model`` by state-dict name: (its reference
    spec on the mesh, over the reference's dims; its DTensor placements,
    one per mesh axis ``(data, model)``). Needs no process group."""
    from torch.distributed.tensor import Replicate, Shard
    data, size = mesh_shape.get(DATA_AXIS, 1), mesh_shape.get(MODEL_AXIS, 1)
    out = {}
    for name, p in model.named_parameters():
        path, perm = jax_leaf(name, p.dim())
        jshape = tuple(p.shape[perm.index(j)] for j in range(p.dim()))
        spec = fit_spec(param_spec(path, jshape), jshape, data, size, fsdp)
        placements = tuple(
            Shard(perm.index(spec.index(ax))) if ax in spec else Replicate()
            for ax in (DATA_AXIS, MODEL_AXIS))
        out[name] = (spec, placements)
    return out


def make_param_shardings(mesh, model: nn.Module, fsdp: bool = False
                         ) -> Dict[str, tuple]:
    """The DTensor placements of every parameter of ``model`` on ``mesh``,
    by state-dict name."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {k: v[1] for k, v in param_placements(model, shape,
                                                 fsdp).items()}


def place_each(model: nn.Module, placements: Dict[str, tuple],
               make) -> nn.Module:
    """Turn every parameter of ``model`` into the DTensor ``make(tensor,
    its placements)`` in place, behind the :class:`~models.tp.Gathered`
    parametrization, so code that reads it gets the whole tensor and the
    split layers (``models/tp.py``) read the shard."""
    for mod_name, mod in list(model.named_modules()):
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{mod_name}.{pname}" if mod_name else pname
            mod._parameters[pname] = nn.Parameter(
                make(p.detach(), placements[full]),
                requires_grad=p.requires_grad)
            parametrize.register_parametrization(mod, pname, Gathered(),
                                                 unsafe=True)
    return model


def shard_params(mesh, model: nn.Module, fsdp: bool = False) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` in place, each a DTensor
    with :func:`make_param_shardings`' placements (:func:`place_each`).
    Every rank must hold the same weights (seeded alike, or loaded from
    one checkpoint); ranks other than 0 take rank 0's. ``parallel/
    multihost.place_global`` places them without a collective."""
    from torch.distributed.tensor import distribute_tensor
    return place_each(model, make_param_shardings(mesh, model, fsdp),
                      lambda t, pl: distribute_tensor(t, mesh, pl))


def local_shard(full: torch.Tensor, mesh, placements: tuple
                ) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full`` under
    ``placements`` (one per mesh dim), as a DTensor holds it: each
    ``Shard(d)`` mesh dim in order takes its chunk of dim ``d`` (the
    placements here shard only dims that divide, ``fit_spec``)."""
    from torch.distributed.tensor import Shard
    for dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            full = full.chunk(mesh.size(dim), dim=pl.dim)[
                mesh.get_local_rank(dim)]
    return full


def is_sharded(model: nn.Module) -> bool:
    """Whether ``model``'s parameters are placed on a mesh."""
    return any(parametrize.is_parametrized(m) for m in model.modules())


def plain_name(name: str) -> str:
    """A placed model's state-dict name under the plain model's name
    (``a.parametrizations.w.original`` -> ``a.w``)."""
    if ".parametrizations." not in name:
        return name
    head, _, rest = name.partition(".parametrizations.")
    return f"{head}.{rest.rpartition('.original')[0]}"


def plain_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` under the plain model's names: a placed
    parameter is its DTensor (its global shape, its local shard)."""
    return {plain_name(k): t for k, t in model.state_dict().items()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole weights of a model placed on a mesh, under the plain
    model's state-dict names (every rank gets them)."""
    return {name: t.full_tensor() if hasattr(t, "full_tensor") else t
            for name, t in plain_state(model).items()}


def data_sharding(mesh) -> tuple:
    """The placements of a batch-major input: the batch over ``data``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if n == DATA_AXIS else Replicate()
                 for n in mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    """The placements of a value every rank holds whole."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def data_slice(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a batch-major tensor (dim 0 over ``data``)."""
    n = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over "
                         f"{n} data ranks")
    return x.chunk(n)[mesh.get_local_rank(DATA_AXIS)]
