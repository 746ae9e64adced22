"""The training step of the three model families (port of
parallel/train.py).

One step: features -> encoder -> the family's loss -> gradients -> global
norm clipping -> AdamW, on the model's device. The features go through
``ops/kernels/mel.py`` (``csrc/mel.cu`` on the card, its plain version on
the CPU); no gradient flows into the audio. The encoder runs in f32 with
TF32 off (``device.py``), as the reference's trainer runs it. The losses
are plain torch: the memory-light RNN-T loss (``ops/rnnt_loss.py``), the
CTC forward algorithm (``ops/ctc.py``) and the AED cross-entropy, each
normalized per label so learning rates transfer between the families.

Sharded training: :func:`init_training` with a mesh (``parallel/mesh.py``)
places the parameters, tensor-parallel over ``model`` and, with ``fsdp``,
sharded over ``data``; AdamW's moments then take the same placements. The
step splits the batch over ``data``: each rank's loss is its share of the
global per-label loss, DTensor's backward reduces every gradient into its
parameter's placement, ``clip_grad_norm_`` takes the global norm over the
DTensor gradients, and the loss comes back replicated.
:func:`make_seq_parallel_loss` also shards the time axis over ``model``,
through the encoder's blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Union

import torch
import torch.distributed as dist
from torch.nn.utils import parametrize

from ..device import disable_tf32
from ..models.reference_init import init_reference_weights
from ..models.tp import TimeShards
from ..ops.ctc import ctc_loss
from ..ops.kernels.mel import log_mel_features
from ..ops.rnnt_loss import transducer_loss
from .mesh import DATA_AXIS, MODEL_AXIS, data_slice, is_sharded, shard_params

Schedule = Callable[[int], float]


class TrainBatch(NamedTuple):
    audio: torch.Tensor        # [B, N] f32 waveforms
    audio_lens: torch.Tensor   # [B] int32
    labels: torch.Tensor       # [B, U] int32
    label_lens: torch.Tensor   # [B] int32

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(x.to(device) for x in self))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """``optax.schedules.warmup_cosine_decay_schedule`` as a plain function
    of the step count: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` at
    ``decay_steps`` (the warmup included) and flat after it."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:  # warmup_steps <= 0 skips the warmup
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(float(count - warmup_steps), cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


class OptState(NamedTuple):
    """The optimizer's state: AdamW's moments and the schedule's count."""
    adamw: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The reference's ``optax.chain(clip_by_global_norm(clip),
    adamw(lr, weight_decay=weight_decay))``: β 0.9 / 0.999, ε 1e-8, the
    decay on every parameter (optax's ``adamw`` with no mask), the decay
    and the step both scaled by the step's learning rate. ``lr`` is a float
    or a schedule ``count -> lr``; step ``i`` (from 0) takes ``lr(i)``, as
    optax does, so a warmup from 0 moves nothing at step 0."""

    lr: Union[float, Schedule]
    weight_decay: float = 1e-3
    clip: float = 1.0

    def init(self, params) -> OptState:
        scheduled = callable(self.lr)
        adamw = torch.optim.AdamW(
            params, lr=1.0 if scheduled else self.lr, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.weight_decay)
        factor = self.lr if scheduled else (lambda count: 1.0)
        return OptState(adamw, torch.optim.lr_scheduler.LambdaLR(adamw,
                                                                 factor))


def make_optimizer(lr: Union[float, Schedule] = 1e-4,
                   weight_decay: float = 1e-3, clip: float = 1.0
                   ) -> Optimizer:
    return Optimizer(lr, weight_decay, clip)


def _features(model, batch: TrainBatch):
    return log_mel_features(batch.audio, batch.audio_lens,
                            n_mels=model.config.n_mels)


def _per_label(losses: torch.Tensor, batch: TrainBatch) -> torch.Tensor:
    """Sum over the batch over its label count (at least 1)."""
    return losses.sum() / torch.clamp(batch.label_lens.sum(), min=1).to(
        losses.dtype)


def _label_count(batch: TrainBatch) -> torch.Tensor:
    return torch.clamp(batch.label_lens.sum(), min=1).to(torch.float32)


def _token_count(batch: TrainBatch) -> torch.Tensor:
    """The AED loss's count: every label and each lane's EOS."""
    return torch.clamp((batch.label_lens + 1).sum(), min=1).to(torch.float32)


def loss_fn(model, batch: TrainBatch) -> torch.Tensor:
    """The transducer's loss, normalized per label."""
    feats, feat_lens = _features(model, batch)
    enc, enc_lens = model.encode(feats, feat_lens)
    return _per_label(transducer_loss(model, enc, enc_lens, batch.labels,
                                      batch.label_lens), batch)


def ctc_loss_fn(model, batch: TrainBatch) -> torch.Tensor:
    """The CTC family's loss, with the transducer's per-label
    normalization."""
    feats, feat_lens = _features(model, batch)
    enc, enc_lens = model.encode(feats, feat_lens)
    return _per_label(ctc_loss(model.log_probs(enc), enc_lens, batch.labels,
                               batch.label_lens, model.config.blank_id),
                      batch)


def aed_loss_fn(model, batch: TrainBatch) -> torch.Tensor:
    """The AED family's teacher-forced cross-entropy (``models/aed.py``),
    already a mean per token with the EOS position."""
    feats, feat_lens = _features(model, batch)
    return model.loss(feats, feat_lens, batch.labels, batch.label_lens)


# what each loss is normalized by: the sharded step scales each rank's
# loss by its share of the global count
loss_fn.count = ctc_loss_fn.count = _label_count
aed_loss_fn.count = _token_count


def _time_sharded(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` laid out with ``dim`` sharded over ``model`` (each model rank
    keeps its slice), then gathered whole for the next consumer (the
    subsampler): the reference's ``with_sharding_constraint`` on the
    features, which GSPMD follows with the gather its convolutions
    need."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    sub = mesh[MODEL_AXIS]
    t = DTensor.from_local(x, sub, [Replicate()], run_check=False)
    return t.redistribute(sub, [Shard(dim)]).full_tensor()


def make_seq_parallel_loss(mesh, base: str = "rnnt"):
    """The RNN-T (``base="rnnt"``) or CTC loss with sequence-parallel
    layouts (Megatron-SP): the features ``[B, n_mels, T]`` sharded on
    time over ``model`` (the subsampler then runs on the gathered
    sequence), the encoder's blocks on time shards ``[B, T' / m, d]``
    (``models/tp.TimeShards``: norms, residuals, gains and feed-forwards
    on each rank's frames, the sequence gathered into attention's
    projections, split by heads, and the conv module's; each rank saves
    about 1/m of the blocks' activations for the backward), the encoder
    output leaving the blocks laid out on time and gathered for the loss,
    the batch over ``data`` (the step's split). Equal to the plain loss.
    Where the model's widths, heads or experts do not divide over
    ``model``, the blocks run on the whole sequence."""
    if base not in ("rnnt", "ctc"):
        raise ValueError(f"unknown base loss {base!r}")

    def f(model, batch: TrainBatch) -> torch.Tensor:
        feats, feat_lens = _features(model, batch)
        seq = TimeShards.over(mesh, model.config)
        enc, enc_lens = model.encode(_time_sharded(mesh, feats, 2),
                                     feat_lens, seq)
        if base == "ctc":
            losses = ctc_loss(model.log_probs(enc), enc_lens, batch.labels,
                              batch.label_lens, model.config.blank_id)
        else:
            losses = transducer_loss(model, enc, enc_lens, batch.labels,
                                     batch.label_lens)
        return _per_label(losses, batch)

    f.count = _label_count
    return f


def make_train_step(model: torch.nn.Module, optimizer: Optimizer, mesh=None,
                    loss=loss_fn):
    """A step ``(opt_state, batch) -> loss`` that updates ``model`` in
    place: zero-grad, the loss, backward, clipping by the global norm,
    AdamW and the schedule's step. The loss comes back as a 0-d tensor on
    the model's device; the caller decides when to read it. ``loss`` is a
    callable ``(model, batch) -> scalar`` (:func:`ctc_loss_fn`,
    :func:`aed_loss_fn` for the other families).

    With ``mesh``, ``model`` must already be placed on it
    (:func:`init_training`); ``loss`` then needs a ``count(batch)``, what
    it is normalized by (the three above have one), and every rank passes
    the whole batch, of which it takes its share over ``data``. Each
    step's gradient norm before clipping is kept in ``step.grad_norm``."""
    if mesh is not None and not is_sharded(model):
        raise ValueError("a training mesh needs the model placed on it: "
                         "init_training(..., mesh=) or shard_params")
    if mesh is not None and not hasattr(loss, "count"):
        raise ValueError("a sharded step needs loss.count(batch), what the "
                         "loss is normalized by")
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    if device.type == "cuda":
        disable_tf32()
        # reproducible steps, as the reference's XLA steps are: cuDNN's
        # convolution backward may otherwise pick algorithms that
        # accumulate in an order that changes from run to run
        torch.backends.cudnn.deterministic = True

    def sharded_loss(batch: TrainBatch) -> torch.Tensor:
        """This rank's share of the global loss: its batch's loss scaled
        by its share of the global count. Gathered parameters are gathered
        once for the step (``parametrize.cached``)."""
        local = TrainBatch(*(data_slice(mesh, x) for x in batch))
        total = loss.count(batch)
        with parametrize.cached():
            return loss(model, local) * (loss.count(local) / total)

    def step(opt_state: OptState, batch: TrainBatch) -> torch.Tensor:
        opt_state.adamw.zero_grad(set_to_none=True)
        batch = batch.to(device)
        value = loss(model, batch) if mesh is None else sharded_loss(batch)
        value.backward()
        # clip_grad_norm_ scales by clip / (norm + 1e-6) where optax's
        # clip_by_global_norm scales by clip / norm: a relative 1e-6 / norm
        # on clipped steps, which Adam's normalization all but removes.
        # Over DTensor gradients the norm is the global one (a DTensor)
        norm = torch.nn.utils.clip_grad_norm_(params, optimizer.clip)
        step.grad_norm = (norm.full_tensor() if hasattr(norm, "full_tensor")
                          else norm).detach()
        opt_state.adamw.step()
        opt_state.schedule.step()
        value = value.detach()
        if mesh is not None:  # every rank's share, summed over data
            dist.all_reduce(value, group=mesh.get_group(DATA_AXIS))
        return value

    step.grad_norm = None
    return step


def init_training(model: torch.nn.Module,
                  rng: Union[torch.Generator, int], optimizer: Optimizer,
                  mesh=None, fsdp: bool = False) -> OptState:
    """Seeded weights and a fresh optimizer state over the model's
    parameters. ``rng`` is a ``torch.Generator`` (the port's seeded init,
    ``model.init_weights``) or an int seed, which gives the reference's
    ``Model.init(PRNGKey(seed))`` weights (``models/reference_init.py``),
    as the reference's trainers seed theirs. With ``mesh`` the weights
    are then placed on it (``shard_params``; ``fsdp`` shards them over
    ``data`` too), and AdamW's moments follow the placements."""
    if fsdp and mesh is None:
        raise ValueError("fsdp shards over a mesh's data axis: pass mesh")
    if isinstance(rng, torch.Generator):
        model.init_weights(rng)
    else:
        init_reference_weights(model, rng)
    if mesh is not None:
        shard_params(mesh, model, fsdp=fsdp)
    return optimizer.init(model.parameters())
