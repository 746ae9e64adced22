"""What the encoder's blocks save for the backward, and the collective
bytes per layer of the split attention and of the time-sharded blocks.

:func:`saved_in_blocks` counts what autograd saves while the blocks run
forward. ``python -m amira_rust_asr_server_tpu_torch.parallel.memory``
runs, for each configuration (``tiny``, the test worlds' batch of 2 x
0.2 s; ``wide``: ``tiny`` at d 256, 4 heads, 4 blocks, feed-forward x 4,
conv kernel 9, subsampling 8, a batch of 2 x 30 s, T' = 376), a world of
two CPU ranks over gloo (``data`` 1 x ``model`` 2) that makes one loss
forward and backward three ways on the same seeded weights and batch: the
plain model with the plain loss, the placed model (FSDP) with
``make_seq_parallel_loss`` (``seq``), and the placed model with the plain
loss (tensor parallelism, ``tp``); ``attention`` is the saved float
``[B, h, T, T]`` tensors (scores and probabilities) alone. It prints one
JSON line per configuration and rank, then the collective bytes per layer,
by formula from the shapes, at ``large`` (d 1024, 8 heads, 17 blocks) for
``model`` = 2. Bytes only: it times nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Dict, Iterator

import numpy as np
import torch

from ..models import Transducer
from ..models.presets import LARGE, TINY
from .launch import spawn_world
from .mesh import make_mesh, shard_params
from .train import TrainBatch, loss_fn, make_seq_parallel_loss


@contextlib.contextmanager
def saved_in_blocks(encoder: torch.nn.Module) -> Iterator[Dict]:
    """Count what autograd saves for the backward while the encoder's
    blocks run forward (``torch.autograd.graph.saved_tensors_hooks``,
    entered around each block): yields a dict whose ``"storages"`` maps
    each storage saved, counted once (parameters and gathered weights
    included), to ``(bytes, shape, dtype)`` of the first tensor saved on
    it, and whose ``"bytes"`` is their sum. Not for a model with remat
    on: these hooks would take the place of the checkpoints' own."""
    out: Dict = {"bytes": 0, "storages": {}}

    def pack(t: torch.Tensor) -> torch.Tensor:
        st = t.untyped_storage()
        if st.data_ptr() not in out["storages"]:
            out["storages"][st.data_ptr()] = (st.nbytes(), tuple(t.shape),
                                              t.dtype)
            out["bytes"] += st.nbytes()
        return t

    hooks = []

    def enter(module, args):
        hooks.append(torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t))
        hooks[-1].__enter__()

    def leave(module, args, result):
        hooks.pop().__exit__(None, None, None)

    blocks = [m for name, m in encoder.named_children()
              if name.startswith("block")]
    handles = [h for b in blocks for h in (
        b.register_forward_pre_hook(enter), b.register_forward_hook(leave))]
    try:
        yield out
    finally:
        for h in handles:
            h.remove()


WIDE = dataclasses.replace(TINY, d_model=256, n_heads=4, n_layers=4,
                           ff_expansion=4, conv_kernel=9,
                           subsampling_factor=8, subsampling_dim=64,
                           d_enc=256)
CONFIGS = {"tiny": (TINY, 3200), "wide": (WIDE, 480000)}


def _batch_for(cfg, n: int) -> TrainBatch:
    rng = np.random.default_rng(0)
    return TrainBatch(
        torch.from_numpy((rng.standard_normal((2, n)) * 0.1).astype(
            np.float32)),
        torch.tensor([n, n - 800], dtype=torch.int32),
        torch.from_numpy(rng.integers(0, cfg.blank_id, (2, 4)).astype(
            np.int32)),
        torch.tensor([4, 2], dtype=torch.int32))


def _attention_bytes(storages) -> int:
    return sum(n for n, s, dt in storages.values()
               if len(s) == 4 and dt.is_floating_point and s[2] == s[3])


def _count(rank: int, world: int):
    """Every configuration's three counts on this rank."""
    mesh = make_mesh({"data": 1, "model": world})
    lines = []
    for name, (cfg, n) in CONFIGS.items():
        batch = _batch_for(cfg, n)
        line = {"config": name, "rank": rank, "d_model": cfg.d_model,
                "n_heads": cfg.n_heads, "n_layers": cfg.n_layers}
        for kind in ("plain", "seq", "tp"):
            model = Transducer(cfg).init_weights(
                torch.Generator().manual_seed(0))
            loss = loss_fn
            if kind != "plain":
                shard_params(mesh, model, fsdp=kind == "seq")
            if kind == "seq":
                loss = make_seq_parallel_loss(mesh)
            with saved_in_blocks(model.encoder) as saved:
                value = loss(model, batch)
            value.backward()
            line[f"{kind}_bytes"] = saved["bytes"]
            line[f"{kind}_attention_bytes"] = _attention_bytes(
                saved["storages"])
            line[f"{kind}_loss"] = float(value.detach())
        line["seq_share"] = line["seq_bytes"] / line["plain_bytes"]
        line["seq_attention_share"] = (line["seq_attention_bytes"]
                                       / line["plain_attention_bytes"])
        lines.append(line)
    return lines


def collective_bytes(cfg, tokens: int, m: int, itemsize: int = 4) -> dict:
    """Bytes each rank receives per conformer layer in one forward, by
    formula from the shapes: an all-gather brings ``(m - 1) / m`` of the
    whole tensor, a ring all-reduce ``2 (m - 1) / m`` of it, a
    reduce-scatter ``(m - 1) / m`` of it, an all-to-all ``(m - 1) / m`` of
    the block each rank holds. Weights that a rank reads whole are
    gathered over ``model`` (biases, norms and gains left out)."""
    d = cfg.d_model
    share = (m - 1) / m
    act = tokens * d * itemsize  # one [B, T, d] activation, whole
    attn_weights = share * 4 * d * d * itemsize  # qkv [3d, d] + out [d, d]
    return {
        # before: qkv and out column-parallel, their outputs all-gathered
        "attention_column_gather": share * act * (3 + 1),
        # split by heads: both weights gathered whole, the output
        # projection's partial products all-reduced
        "attention_heads": attn_weights + 2 * share * act,
        # a block on time shards: five gathers over time (ff1, qkv, pw1,
        # pw2, ff2), three reduce-scatters (ff1, attention, ff2), two
        # all-to-alls of the conv module's channel blocks, and the weights
        # read whole (qkv, out, pw1 [2d, d]; the others are local shards)
        "seq_block": ((5 + 3) * share * act + 2 * share * act / m
                      + attn_weights + share * 2 * d * d * itemsize),
    }


def main() -> None:
    for lines in spawn_world(_count, 2, timeout_s=900.0):
        for line in lines:
            print(json.dumps(line))
    t_prime = 376  # a 30 s utterance through the 8x subsampler
    for batch in (1, 16):
        print(json.dumps({
            "collective_bytes_per_layer": "large", "model": 2,
            "batch": batch, "t_prime": t_prime, "dtype": "float32",
            **{k: round(v) for k, v in collective_bytes(
                LARGE, batch * t_prime, 2).items()}}))


if __name__ == "__main__":
    main()
