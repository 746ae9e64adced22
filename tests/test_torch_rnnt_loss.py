"""PyTorch port: the memory-light RNN-T loss against the JAX reference.

Weights are the JAX package's ``Transducer.init(PRNGKey(0))`` on ``tiny``,
carried over by ``convert.from_jax_params``; JAX gradients cross over
through the same converter, so each port ``.grad`` meets its counterpart
by name. Inputs are numpy-seeded. Tolerances:

- against the float64 NumPy DP oracle: 1e-4 absolute;
- ``rnnt_loss`` against JAX ``rnnt_loss`` on a ragged batch: value and
  gradient w.r.t. the lattice within rel 1e-5 / atol 1e-5;
- ``transducer_loss`` on ``tiny``: loss rel 1e-5, every parameter
  gradient (and the encoder output's) atol 1e-5 / rel 1e-4;
- ``pred_forward`` and ``joint_full``: atol 1e-5.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.ops.rnnt_loss import NEG_INF as JAX_NEG_INF
from amira_rust_asr_server_tpu.ops.rnnt_loss import \
    rnnt_loss as jax_rnnt_loss
from amira_rust_asr_server_tpu.ops.rnnt_loss import \
    transducer_loss as jax_transducer_loss
from amira_rust_asr_server_tpu_torch.convert import from_jax_params, to_model
from amira_rust_asr_server_tpu_torch.ops.rnnt_loss import (FRAME_BLOCK,
                                                           NEG_INF,
                                                           rnnt_loss,
                                                           rnnt_loss_oracle,
                                                           transducer_loss)

torch.set_num_threads(2)
BLANK = 5
VOCAB = 6


def _random_case(rng, t, u):
    """Random log-prob lattice [T, U+1, V] + labels (the reference test's)."""
    logits = rng.standard_normal((t, u + 1, VOCAB)).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(0, BLANK, u).astype(np.int32)
    return log_probs, labels


def lattice_fn(lattice: torch.Tensor):
    """A ``log_probs_fn`` that looks each block's frames up in ``lattice
    [B, T, U+1, V]``; the "encoder output" is the frame index."""
    def fn(enc_blk):
        idx = enc_blk[:, :, 0].long()
        rows = torch.arange(lattice.shape[0])[:, None]
        return lattice[rows, idx]
    return fn


def frame_index(b, t):
    return torch.arange(t, dtype=torch.float32)[None, :, None].repeat(b, 1, 1)


@pytest.mark.parametrize("t,u", [(1, 0), (3, 1), (5, 3), (8, 6), (12, 4)])
def test_matches_oracle(t, u):
    rng = np.random.default_rng(t * 100 + u)
    log_probs, labels = _random_case(rng, t, u)
    got = rnnt_loss(lattice_fn(torch.from_numpy(log_probs)[None]),
                    frame_index(1, t), torch.tensor([t]),
                    torch.from_numpy(labels.reshape(1, u)),
                    torch.tensor([u]), BLANK)
    want = rnnt_loss_oracle(log_probs, t, labels, BLANK)
    assert abs(float(got[0]) - want) < 1e-4


def test_ragged_batch_value_and_lattice_gradient_match_jax():
    """Lanes shorter than the batch in frames and in labels (one with no
    label at all): the loss and its gradient w.r.t. every lattice entry,
    the masked ones included, equal JAX's; nothing is NaN."""
    rng = np.random.default_rng(7)
    t, u = 10, 5
    assert t > FRAME_BLOCK  # a full block and a ragged one
    cases = [(6, 3), (10, 5), (4, 0)]
    lattice = np.stack([_random_case(rng, t, u)[0] for _ in cases])
    labels = np.stack([rng.integers(0, BLANK, u).astype(np.int32)
                       for _ in cases])
    enc_lens = np.array([c[0] for c in cases], np.int32)
    label_lens = np.array([c[1] for c in cases], np.int32)

    def jax_total(lat):
        def fn(enc_t):
            idx = enc_t[:, 0].astype(jnp.int32)
            return jnp.take_along_axis(lat, idx[:, None, None, None],
                                       axis=1)[:, 0]
        enc = jnp.tile(jnp.arange(t, dtype=jnp.float32)[None, :, None],
                       (3, 1, 1))
        losses = jax_rnnt_loss(fn, enc, jnp.asarray(enc_lens),
                               jnp.asarray(labels), jnp.asarray(label_lens),
                               BLANK)
        return losses.sum(), losses

    (_, want), want_grad = jax.value_and_grad(jax_total, has_aux=True)(
        jnp.asarray(lattice))

    lat = torch.from_numpy(lattice).requires_grad_()
    got = rnnt_loss(lattice_fn(lat), frame_index(3, t),
                    torch.from_numpy(enc_lens), torch.from_numpy(labels),
                    torch.from_numpy(label_lens), BLANK)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert torch.isfinite(lat.grad).all()
    np.testing.assert_allclose(lat.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5)
    for i, (tl, ul) in enumerate(cases):
        want_i = rnnt_loss_oracle(lattice[i], tl, labels[i][:ul], BLANK)
        assert abs(float(got[i].detach()) - want_i) < 1e-4


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model) of ``tiny`` at PRNGKey(0)."""
    jm = JaxTransducer.from_preset("tiny")
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, to_model(jax.device_get(params), jm.config)


def loss_inputs(cfg, b=3, t=2 * FRAME_BLOCK + 3, u=5, seed=9):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, cfg.d_enc)).astype(np.float32)
    labels = rng.integers(0, cfg.blank_id, (b, u)).astype(np.int32)
    enc_lens = np.array([t, t - 5, 4][:b], np.int32)
    label_lens = np.array([u, 2, 0][:b], np.int32)
    return enc, enc_lens, labels, label_lens


def test_transducer_loss_and_gradients_match_jax(tiny):
    jm, params, model = tiny
    enc, enc_lens, labels, label_lens = loss_inputs(jm.config)

    def jax_total(p, e):
        return jax_transducer_loss(
            jm, p, e, jnp.asarray(enc_lens), jnp.asarray(labels),
            jnp.asarray(label_lens)).sum()

    want, (g_params, g_enc) = jax.value_and_grad(jax_total, (0, 1))(
        params, jnp.asarray(enc))
    want_grads = from_jax_params(jax.device_get(g_params), jm.config)

    model.zero_grad(set_to_none=True)
    enc_t = torch.from_numpy(enc).requires_grad_()
    got = transducer_loss(model, enc_t, torch.from_numpy(enc_lens),
                          torch.from_numpy(labels),
                          torch.from_numpy(label_lens)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(enc_t.grad.numpy(), np.asarray(g_enc),
                               atol=1e-5, rtol=1e-4)
    compared = 0
    for name, p in model.named_parameters():
        if name.startswith("encoder."):
            assert p.grad is None  # the loss starts at the encoder output
            continue
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        compared += 1
    assert compared == len([k for k in want_grads
                            if not k.startswith("encoder.")])
    with torch.no_grad():  # the path without checkpoints: the same value
        again = transducer_loss(model, enc_t, torch.from_numpy(enc_lens),
                                torch.from_numpy(labels),
                                torch.from_numpy(label_lens)).sum()
    assert float(again) == float(got.detach())


def test_pred_forward_and_joint_full_match_jax(tiny):
    jm, params, model = tiny
    cfg = jm.config
    enc, _, labels, _ = loss_inputs(cfg, t=7)
    state0 = jm.init_state(3)
    want_seq, (want_h, want_c) = jm.predict_forward(
        params, jnp.asarray(labels), state0)
    with torch.no_grad():
        seq, (h, c) = model.predict_forward(torch.from_numpy(labels),
                                            model.init_state(3))
        lattice = model.joint_full(torch.from_numpy(enc), seq)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=1e-5)
    want_lat = jm.joint_full(params, jnp.asarray(enc), want_seq)
    assert lattice.shape == (3, 7, labels.shape[1] + 1, cfg.vocab_size)
    np.testing.assert_allclose(lattice.numpy(), np.asarray(want_lat),
                               atol=1e-5)


def test_loss_saves_no_lattice(tiny):
    """Autograd saves no ``[B, T, U+1, V]`` lattice, nor any block of one:
    with T = 4 blocks, every saved activation is smaller than the lattice
    and none has the lattice's layout ``[B, Tc, U+1, V or J]`` (the blocks
    are checkpointed)."""
    _, _, model = tiny
    cfg = model.config
    b, t, u = 2, 4 * FRAME_BLOCK, 7  # (U+1) * V above d_enc and d_joint
    enc, enc_lens, labels, label_lens = loss_inputs(cfg, b=b, t=t, u=u)
    shapes = []
    weights = {p.data_ptr() for p in model.parameters()}

    def pack(x):
        if x.data_ptr() not in weights:  # the weights are saved as they are
            shapes.append(tuple(x.shape))
        return x

    model.zero_grad(set_to_none=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = transducer_loss(model, torch.from_numpy(enc),
                               torch.from_numpy(enc_lens),
                               torch.from_numpy(labels),
                               torch.from_numpy(label_lens)).sum()
    loss.backward()
    lattice = b * t * (u + 1) * cfg.vocab_size
    assert shapes
    assert max(int(np.prod(s)) for s in shapes) < lattice
    assert [s for s in shapes if len(s) == 4 and s[2] == u + 1
            and s[3] in (cfg.vocab_size, cfg.d_joint)] == []
    assert model.joint.out.w.grad.abs().max() > 0


def test_one_block_of_the_lattice_lives_at_a_time():
    """Each block's log-probs are freed before the next block computes its
    own, in the forward pass and in the backward's recomputation: nothing
    the loss keeps (a view of a block's gathered log-probs, say) holds a
    block's lattice alive."""
    rng = np.random.default_rng(3)
    t, u = 3 * FRAME_BLOCK, 4
    lattice = torch.from_numpy(np.stack(
        [_random_case(rng, t, u)[0]])).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, BLANK, (1, u)).astype(
        np.int32))
    alive, calls = [], []
    look_up = lattice_fn(lattice)

    def fn(enc_blk):
        lp = look_up(enc_blk)  # a fresh [1, Tc, U+1, V] tensor
        calls.append(sum(r() is not None for r in alive))
        alive.append(weakref.ref(lp))
        return lp

    loss = rnnt_loss(fn, frame_index(1, t), torch.tensor([t]), labels,
                     torch.tensor([u]), BLANK)
    loss.sum().backward()
    assert len(calls) == 6 and calls == [0] * 6  # 3 forward, 3 recomputed
    assert torch.isfinite(lattice.grad).all()


def test_module_keeps_the_reference_constants():
    assert NEG_INF == JAX_NEG_INF
