"""RNN-T (transducer) loss that never holds the whole lattice (port of
ops/rnnt_loss.py).

The joint lattice ``[B, T, U+1, V]`` is computed one block of
:data:`FRAME_BLOCK` frames at a time: each block's logits are
log-softmaxed and reduced at once to the two log-probs the recurrence
reads, blank and the next label (``[B, Tc, U+1]`` each). Each block runs
under ``torch.utils.checkpoint`` (non-reentrant), so autograd saves only
the block's inputs and recomputes its joint in the backward pass, as XLA
rematerializes the reference's per-frame joint.

The recurrence is the reference's, one frame at a time over ``[B, U+1]``:

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1])

solved per frame with a prefix: ``alpha_row = A + logcumsumexp(c - A)``,
where ``A`` is the cumulative sum of the label log-probs and ``c`` the
blank transitions into the frame. Label transitions at and past a lane's
``label_len`` are masked with the finite ``NEG_INF`` before they enter
the sums, and each lane's likelihood is the terminal ``alpha[t, U] +
blank[t, U]`` picked at ``t = enc_len - 1``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.decoder_joint import joint_full

NEG_INF = -1e30

# Frames per joint block. A block's [B, Tc, U+1, J] hidden and [B, Tc, U+1,
# V] logits, log-softmax and their gradients live only while the block is
# computed (in the forward pass, then again in the backward pass), so the
# loss's peak beyond its inputs and the weights' gradients is about six
# such f32 tensors, 24 * B * Tc * (U+1) * max(V, J) bytes, plus the
# gathered [B, T, U+1] pair: at the flagship's V = 1030 with a 16 x 6 s
# synthspeech batch (U+1 = 25, T = 76) that is ~40 MB where the whole
# lattice alone takes 125 MB, and ~356 MB at 30 s with 224 labels (T = 376)
# where the lattice alone takes 5.6 GB.
FRAME_BLOCK = 4


def _block_log_probs(log_probs_fn, enc_blk, pick, u_valid):
    """One frame block's blank and label log-probs, ``[B, Tc, U+1]`` each;
    label transitions at and past ``label_len`` are ``NEG_INF``. One
    gather of ``pick [B, 1, U+1, 2]`` (blank, next label) copies them out,
    so no view keeps the block's lattice alive after the block."""
    lp = log_probs_fn(enc_blk)                           # [B, Tc, U+1, V]
    b, tc, u1, _ = lp.shape
    lp_blank, lp_label = torch.gather(
        lp, 3, pick.expand(b, tc, u1, 2)).unbind(-1)
    return lp_blank, torch.where(u_valid[:, None, :], lp_label, NEG_INF)


def rnnt_loss(log_probs_fn, enc: torch.Tensor, enc_lens: torch.Tensor,
              labels: torch.Tensor, label_lens: torch.Tensor,
              blank_id: int) -> torch.Tensor:
    """Negative log-likelihood per sequence, ``[B]``.

    Args:
      log_probs_fn: ``enc_block [B, Tc, D] -> log-probs [B, Tc, U+1, V]``,
        the joint against this batch's prediction-net outputs (the closure
        holds them; see :func:`transducer_loss`).
      enc: ``[B, T, D]`` encoder output (or its joint projection).
      enc_lens: ``[B]`` valid frame counts.
      labels: ``[B, U]`` target labels.
      label_lens: ``[B]`` valid label counts.
    """
    b, t_max, _ = enc.shape
    u_max = labels.shape[1]
    dev = enc.device
    labels_ext = F.pad(labels.long().to(dev), (0, 1))          # [B, U+1]
    pick = torch.stack([torch.full_like(labels_ext, blank_id), labels_ext],
                       dim=-1)[:, None]                      # [B, 1, U+1, 2]
    u_idx = torch.arange(u_max + 1, device=dev)
    u_valid = u_idx[None, :] < label_lens.to(dev)[:, None]
    blanks, labs = [], []
    for t0 in range(0, t_max, FRAME_BLOCK):
        args = (log_probs_fn, enc[:, t0:t0 + FRAME_BLOCK], pick, u_valid)
        if torch.is_grad_enabled():
            lp_b, lp_l = checkpoint(_block_log_probs, *args,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            lp_b, lp_l = _block_log_probs(*args)
        blanks.append(lp_b)
        labs.append(lp_l)
    lp_blank = torch.cat(blanks, dim=1)                        # [B, T, U+1]
    # A[t, u]: the label log-probs consumed moving 0 -> u within frame t
    a_cum = torch.cumsum(F.pad(torch.cat(labs, dim=1)[:, :, :-1], (1, 0)),
                         dim=2)

    alpha = torch.where(u_idx == 0, 0.0, NEG_INF).to(
        lp_blank.dtype).expand(b, u_max + 1)
    blank_prev = torch.zeros_like(alpha)
    alphas = []
    for a_t, blank_t in zip(a_cum.unbind(1), lp_blank.unbind(1)):
        alpha = a_t + torch.logcumsumexp(alpha + blank_prev - a_t, dim=1)
        alphas.append(alpha)
        blank_prev = blank_t
    # each frame's terminal candidate alpha[t, U] + blank[t, U], at
    # U = label_len, picked at t = enc_len - 1
    ends = label_lens.to(dev).long()[:, None, None].expand(b, t_max, 1)
    terminals = torch.gather(torch.stack(alphas, dim=1) + lp_blank, 2,
                             ends)[..., 0]                     # [B, T]
    pick = (torch.arange(t_max, device=dev)[None, :]
            == (enc_lens.to(dev)[:, None] - 1))
    return -torch.where(pick, terminals, 0.0).sum(dim=1)


def joint_loss(joint, enc: torch.Tensor, pred_seq: torch.Tensor,
               enc_lens: torch.Tensor, labels: torch.Tensor,
               label_lens: torch.Tensor, blank_id: int) -> torch.Tensor:
    """:func:`rnnt_loss` over a joint network (``models/decoder_joint.py``
    ``Joint``) and the prediction net's outputs ``pred_seq [B, U+1, P]``:
    both projections are made once, and each frame block's lattice is the
    joint's output layer over their sums."""
    enc_pre = joint.enc_proj(enc)                              # [B, T, J]
    pred_pre = joint.pred_proj(pred_seq)                       # [B, U+1, J]

    def log_probs_fn(enc_blk):
        hidden = torch.relu(enc_blk[:, :, None, :] + pred_pre[:, None])
        return torch.log_softmax(joint.out(hidden), dim=-1)

    return rnnt_loss(log_probs_fn, enc_pre, enc_lens, labels, label_lens,
                     blank_id)


def joint_loss_lattice(joint, enc: torch.Tensor, pred_seq: torch.Tensor,
                       enc_lens: torch.Tensor, labels: torch.Tensor,
                       label_lens: torch.Tensor, blank_id: int
                       ) -> torch.Tensor:
    """The plain version of :func:`joint_loss`, for checks: the whole
    ``[B, T, U+1, V]`` lattice (``joint_full``), log-softmaxed, then the
    same recurrence reading it."""
    b, t_max, _ = enc.shape
    lattice = torch.log_softmax(joint_full(joint, enc, pred_seq), dim=-1)
    rows = torch.arange(b, device=enc.device)[:, None]
    frames = torch.arange(t_max, dtype=torch.float32, device=enc.device)
    return rnnt_loss(lambda blk: lattice[rows, blk[:, :, 0].long()],
                     frames[None, :, None].expand(b, t_max, 1), enc_lens,
                     labels, label_lens, blank_id)


def _pred_seq(model, enc: torch.Tensor, labels: torch.Tensor):
    state0 = model.init_state(enc.shape[0], dtype=enc.dtype,
                              device=enc.device)
    return model.predict_forward(labels, state0)[0]            # [B, U+1, P]


def transducer_loss(model, enc: torch.Tensor, enc_lens: torch.Tensor,
                    labels: torch.Tensor, label_lens: torch.Tensor
                    ) -> torch.Tensor:
    """:func:`joint_loss` bound to a ``Transducer``: the prediction net runs
    teacher-forced over ``[SOS, labels]`` first."""
    return joint_loss(model.joint, enc, _pred_seq(model, enc, labels),
                      enc_lens, labels, label_lens, model.config.blank_id)


def transducer_loss_lattice(model, enc: torch.Tensor, enc_lens: torch.Tensor,
                            labels: torch.Tensor, label_lens: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of :func:`transducer_loss`, for checks."""
    return joint_loss_lattice(model.joint, enc, _pred_seq(model, enc, labels),
                              enc_lens, labels, label_lens,
                              model.config.blank_id)


def rnnt_loss_oracle(log_probs, enc_len: int, labels, blank_id: int
                     ) -> float:
    """O(T*U) NumPy reference DP for tests: log_probs [T, U+1, V]."""
    u_len = len(labels)
    alpha = np.full((enc_len, u_len + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(enc_len):
        for u in range(u_len + 1):
            if t == 0 and u == 0:
                continue
            acc = -np.inf
            if t > 0:
                acc = np.logaddexp(
                    acc, alpha[t - 1, u] + log_probs[t - 1, u, blank_id])
            if u > 0:
                acc = np.logaddexp(
                    acc, alpha[t, u - 1] + log_probs[t, u - 1, labels[u - 1]])
            alpha[t, u] = acc
    return float(-(alpha[enc_len - 1, u_len]
                   + log_probs[enc_len - 1, u_len, blank_id]))
