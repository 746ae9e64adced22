"""Pipeline parallelism (GPipe) for the conformer encoder (port of
parallel/pipeline.py).

The L conformer blocks are cut into S stages of L/S blocks, stage i on
rank i of a ``stage`` mesh, and M microbatches flow from stage to stage:
each stage receives a microbatch's activations ``[B/M, T', d_model]`` from
the one before (``recv``), runs its blocks and sends the result on
(``send``). The blocking receive makes the reference's (M + S - 1)-tick
wavefront: stage i works on microbatch t - i at tick t, and the bubble is
(S - 1) / (M + S - 1). The last stage's output goes to every rank
(``broadcast``, the reference's psum from the last stage), and the
prologue (subsampler) and epilogue (output projection) run on every rank,
as the reference runs them outside its ``shard_map``.

The backward is the reverse wavefront, written out in
:class:`_GPipe`: the last stage starts from its output's gradient, each
stage recomputes its blocks' forward on the microbatch it kept, takes the
gradients of its blocks' parameters and of its input, and sends the
latter back one stage. Point-to-point send and receive are not
differentiable in ``torch.distributed``, so the schedule is one autograd
function; the gradients equal the single-rank ones. Each stage's blocks'
gradients land on the rank that holds the stage; the prologue's is
summed over the stages (only stage 0's is not zero), so every rank holds
it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from .mesh import mesh_device_type

STAGE_AXIS = "stage"


def make_pp_mesh(n_stages: int):
    """The 1-D ``stage`` mesh this rank belongs to: the world's ranks in
    groups of ``n_stages`` consecutive ranks, each group one pipeline (a
    world larger than ``n_stages`` runs replicas of it)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_stages > world:
        raise ValueError(f"need {n_stages} devices, have {world}")
    if world % n_stages:
        raise ValueError(f"{world} ranks do not split into pipelines of "
                         f"{n_stages} stages")
    mesh = init_device_mesh(mesh_device_type(), (world // n_stages,
                                                 n_stages),
                            mesh_dim_names=("replica", STAGE_AXIS))
    return mesh[STAGE_AXIS]


def stack_block_params(encoder, n_layers: int
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """The blocks' parameters stacked on a leading ``[L]`` dim, by their
    name within a block, and the rest of the encoder's (subsampler, output
    projection) by name."""
    blocks = [dict(getattr(encoder, f"block{i}").named_parameters())
              for i in range(n_layers)]
    stacked = {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}
    rest = {k: v for k, v in encoder.named_parameters()
            if not k.startswith("block")}
    return stacked, rest


def _run(blocks, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    for block in blocks:
        x = block(x, mask)
    return x


class _GPipe(torch.autograd.Function):
    """The stage-sharded block stack: ``x [B, T', d]`` (the prologue's
    output; stage 0 reads it) -> the last stage's output on every rank."""

    @staticmethod
    def forward(ctx, x, pad_mask, n_micro, mesh, blocks, *params):
        group = mesh.get_group()
        s, stage = mesh.size(), mesh.get_local_rank()
        peer = [dist.get_global_rank(group, i) for i in range(s)]
        xs, masks = x.chunk(n_micro), pad_mask.chunk(n_micro)
        inputs, outs = [], []
        for mb in range(n_micro):
            h = xs[mb]
            if stage > 0:
                h = torch.empty_like(h)
                dist.recv(h, peer[stage - 1], group=group)
            inputs.append(h)
            h = _run(blocks, h, masks[mb]).contiguous()
            if stage < s - 1:
                dist.send(h, peer[stage + 1], group=group)
            outs.append(h)
        y = (torch.cat(outs) if stage == s - 1
             else torch.empty_like(x).contiguous())
        dist.broadcast(y, peer[s - 1], group=group)
        ctx.mesh, ctx.blocks, ctx.params = mesh, blocks, params
        ctx.inputs, ctx.masks = inputs, masks
        return y

    @staticmethod
    def backward(ctx, gy):
        mesh, blocks, params = ctx.mesh, ctx.blocks, ctx.params
        group = mesh.get_group()
        s, stage = mesh.size(), mesh.get_local_rank()
        peer = [dist.get_global_rank(group, i) for i in range(s)]
        n_micro = len(ctx.inputs)
        gys = gy.contiguous().chunk(n_micro)
        gparams: List = [None] * len(params)
        gxs: List = [None] * n_micro
        for mb in reversed(range(n_micro)):
            g = gys[mb]
            if stage < s - 1:
                g = torch.empty_like(ctx.inputs[mb])
                dist.recv(g, peer[stage + 1], group=group)
            with torch.enable_grad():
                h = ctx.inputs[mb].detach().requires_grad_(True)
                out = _run(blocks, h, ctx.masks[mb])
                grads = torch.autograd.grad(out, (h, *params), g,
                                            allow_unused=True)
            for i, gp in enumerate(grads[1:]):
                if gp is not None:
                    gparams[i] = gp if gparams[i] is None else gparams[i] + gp
            if stage > 0:
                dist.send(grads[0].contiguous(), peer[stage - 1],
                          group=group)
            else:
                gxs[mb] = grads[0]
        gx = (torch.cat(gxs) if stage == 0
              else torch.zeros_like(gy)).contiguous()
        dist.all_reduce(gx, group=group)  # stage 0's, on every rank
        return (gx, None, None, None, None, *gparams)


def pipeline_encode(model, features: torch.Tensor, lengths: torch.Tensor,
                    mesh, n_microbatches: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder forward with its block stack pipelined over ``mesh``
    (:func:`make_pp_mesh`); the contract of ``model.encode``: ``[B,
    n_mels, T] + [B] -> ([B, T', d_enc], [B])``, equal to it. Every rank
    holds the model; a stage runs its own blocks."""
    cfg = model.config
    encoder = model.encoder
    s, stage = mesh.size(), mesh.get_local_rank()
    if cfg.n_layers % s:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by {s} "
                         "stages")
    b = features.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} "
                         "microbatches")
    per = cfg.n_layers // s
    blocks = [getattr(encoder, f"block{i}")
              for i in range(stage * per, (stage + 1) * per)]
    params = [p for blk in blocks for p in blk.parameters()]
    x, enc_lens, pad_mask = encoder.prologue(features, lengths)
    y = _GPipe.apply(x, pad_mask, n_microbatches, mesh, blocks, *params)
    return encoder.epilogue(y, pad_mask), enc_lens
