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

The reference's sharded training (a device mesh, FSDP and the
sequence-parallel loss) is refused by name: it is parallelism, ROADMAP.md
queue 1, item 14.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Union

import torch

from ..device import disable_tf32
from ..models.reference_init import init_reference_weights
from ..ops.ctc import ctc_loss
from ..ops.kernels.mel import log_mel_features
from ..ops.rnnt_loss import transducer_loss

NOT_PORTED = ("is not ported yet (ROADMAP.md queue 1, item 14: parallelism "
              "and MoE)")

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


def make_seq_parallel_loss(mesh, base: str = "rnnt"):
    raise NotImplementedError(f"the sequence-parallel loss {NOT_PORTED}")


def make_train_step(model: torch.nn.Module, optimizer: Optimizer, mesh=None,
                    loss=loss_fn):
    """A step ``(opt_state, batch) -> loss`` that updates ``model`` in
    place: zero-grad, the loss, backward, clipping by the global norm,
    AdamW and the schedule's step. The loss comes back as a 0-d tensor on
    the model's device; the caller decides when to read it. ``loss`` is a
    callable ``(model, batch) -> scalar`` (:func:`ctc_loss_fn`,
    :func:`aed_loss_fn` for the other families)."""
    if mesh is not None:
        raise NotImplementedError(f"a training mesh {NOT_PORTED}")
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    if device.type == "cuda":
        disable_tf32()
        # reproducible steps, as the reference's XLA steps are: cuDNN's
        # convolution backward may otherwise pick algorithms that
        # accumulate in an order that changes from run to run
        torch.backends.cudnn.deterministic = True

    def step(opt_state: OptState, batch: TrainBatch) -> torch.Tensor:
        opt_state.adamw.zero_grad(set_to_none=True)
        value = loss(model, batch.to(device))
        value.backward()
        # clip_grad_norm_ scales by clip / (norm + 1e-6) where optax's
        # clip_by_global_norm scales by clip / norm: a relative 1e-6 / norm
        # on clipped steps, which Adam's normalization all but removes
        torch.nn.utils.clip_grad_norm_(params, optimizer.clip)
        opt_state.adamw.step()
        opt_state.schedule.step()
        return value.detach()

    return step


def init_training(model: torch.nn.Module,
                  rng: Union[torch.Generator, int], optimizer: Optimizer,
                  mesh=None, fsdp: bool = False) -> OptState:
    """Seeded weights and a fresh optimizer state over the model's
    parameters. ``rng`` is a ``torch.Generator`` (the port's seeded init,
    ``model.init_weights``) or an int seed, which gives the reference's
    ``Model.init(PRNGKey(seed))`` weights (``models/reference_init.py``),
    as the reference's trainers seed theirs."""
    if mesh is not None or fsdp:
        raise NotImplementedError(f"sharded training (mesh, fsdp) "
                                  f"{NOT_PORTED}")
    if isinstance(rng, torch.Generator):
        model.init_weights(rng)
    else:
        init_reference_weights(model, rng)
    return optimizer.init(model.parameters())
