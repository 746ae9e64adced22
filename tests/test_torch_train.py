"""PyTorch port: training (losses, optimizer, data side, checkpoints and the
trainer CLI) against the JAX reference.

Weights are the JAX package's ``init(PRNGKey(0))`` on ``tiny``, carried
over by ``convert.from_jax_params``; JAX gradients cross over through the
same converter, so each port ``.grad`` meets its counterpart by name.
Inputs come from seeded numpy generators. Tolerances:

- ``ctc_loss``: value and gradient w.r.t. the logits within rel 1e-5 /
  atol 1e-5 of JAX's, and of ``F.ctc_loss``'s (the test oracle only; the
  trainer never calls it) as ``tests/test_ctc.py`` holds JAX's;
- ``CTCModel.loss`` and ``AEDModel.loss``: value rel 1e-5, every
  parameter gradient atol 1e-5 / rel 1e-4;
- the schedule: rel 1e-6 of optax's (which computes in f32);
- three optimizer steps per family from the same init on the same batches:
  each loss within rel 1e-4 of JAX's, and every parameter within
  ``2 * lr * steps`` of JAX's. Adam divides each gradient by its own
  running size, so an element whose gradient is near zero can move by up
  to ``lr`` in either direction on a sign the two frameworks' roundings
  decide; that, per step, is the most two correct AdamW steps can differ;
- the data side (``pad_batch``, the synthetic, digit, synthspeech and
  manifest streams, ``load_wav``): bit for bit;
- the checkpoint round trip: parameters bit-equal, decode identical.

The section at the end runs on the card only (its ``dev`` fixture skips it
elsewhere): the memory-light loss against the full lattice at the
flagship's joint widths, and the log-mel kernel inside a train step against
its plain version.
"""

import dataclasses
import json
import subprocess
import sys
import types
import wave

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amira_rust_asr_server_tpu_torch import train as cli
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import (from_jax_params,
                                                     load_checkpoint,
                                                     load_npz, to_model)
from amira_rust_asr_server_tpu_torch.errors import (ConfigValidationError,
                                                    DeviceError)
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.aed import AEDModel
from amira_rust_asr_server_tpu_torch.models.ctc import CTCModel
from amira_rust_asr_server_tpu_torch.models import reference_init
from amira_rust_asr_server_tpu_torch.models.presets import LARGE, TINY
from amira_rust_asr_server_tpu_torch.ops import features
from amira_rust_asr_server_tpu_torch.ops import kernels
from amira_rust_asr_server_tpu_torch.ops.ctc import NEG_INF, ctc_loss
from amira_rust_asr_server_tpu_torch.ops.greedy import \
    greedy_decode_transducer
from amira_rust_asr_server_tpu_torch.ops.kernels.mel import log_mel_features
from amira_rust_asr_server_tpu_torch.ops.rnnt_loss import (
    joint_loss, joint_loss_lattice, transducer_loss, transducer_loss_lattice)
from amira_rust_asr_server_tpu_torch.parallel import (TrainBatch,
                                                      aed_loss_fn,
                                                      ctc_loss_fn,
                                                      init_training, loss_fn,
                                                      make_optimizer,
                                                      make_train_step)
from amira_rust_asr_server_tpu_torch.parallel import data
from amira_rust_asr_server_tpu_torch.parallel.train import \
    warmup_cosine_decay_schedule
from amira_rust_asr_server_tpu_torch.runtime.pipeline import check_supported
from amira_rust_asr_server_tpu_torch.runtime.reload import hot_swap
from amira_rust_asr_server_tpu_torch.server import build_state
from amira_rust_asr_server_tpu_torch.testing import (digit_batches,
                                                     digits_vocab_map,
                                                     pcm16_digits,
                                                     random_sentence,
                                                     synthspeech_batches,
                                                     write_digits_vocab)
from amira_rust_asr_server_tpu_torch.testing import digits as port_digits
from amira_rust_asr_server_tpu_torch.testing import synthspeech
from amira_rust_asr_server_tpu_torch.utils import platform
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
BLANK = 6
V = 7
FAMILIES = {"transducer": loss_fn, "ctc": ctc_loss_fn, "aed": aed_loss_fn}
NO_REF = "the JAX package, this case's oracle, needs flax and optax"


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    """build_state probes the platform: its cloud probe answers without the
    metadata request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules, the oracles: imported here, so the file
    imports where they are absent and its card section runs there."""
    pytest.importorskip("flax", reason=NO_REF)
    pytest.importorskip("optax", reason=NO_REF)
    import jax
    import jax.numpy as jnp
    import optax

    from amira_rust_asr_server_tpu.models import (AEDModel, CTCModel,
                                                   Transducer as JaxTr)
    from amira_rust_asr_server_tpu.ops.ctc import ctc_loss as jax_ctc_loss
    from amira_rust_asr_server_tpu.parallel import data as jax_data
    from amira_rust_asr_server_tpu.parallel import train as jax_train
    from amira_rust_asr_server_tpu.testing import digits as jax_digits
    from amira_rust_asr_server_tpu.testing import synthspeech as jax_synth
    from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, ctc_loss=jax_ctc_loss,
        data=jax_data, train=jax_train, digits=jax_digits, synth=jax_synth,
        Vocabulary=JaxVocabulary,
        models={"transducer": JaxTr, "ctc": CTCModel, "aed": AEDModel},
        losses={"transducer": jax_train.loss_fn,
                "ctc": jax_train.ctc_loss_fn, "aed": jax_train.aed_loss_fn})


def assert_batches_equal(got: TrainBatch, want) -> None:
    for name in TrainBatch._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- the CTC loss -------------------------------------------------------------
def torch_oracle(logits, log_lens, labels, lab_lens):
    """``F.ctc_loss`` per example and its gradient w.r.t. the logits."""
    tl = torch.tensor(logits, requires_grad=True)
    tlp = F.log_softmax(tl, dim=-1).transpose(0, 1)
    flat = np.concatenate([labels[i, :lab_lens[i]]
                           for i in range(len(lab_lens))]).astype(np.int64)
    ref = F.ctc_loss(tlp, torch.tensor(flat), torch.tensor(log_lens),
                     torch.tensor(lab_lens), blank=BLANK, reduction="none",
                     zero_infinity=False)
    ref.sum().backward()
    return ref.detach().numpy(), tl.grad.numpy()


def port_ctc(logits, log_lens, labels, lab_lens):
    tl = torch.tensor(logits, requires_grad=True)
    got = ctc_loss(torch.log_softmax(tl, dim=-1), torch.tensor(log_lens),
                   torch.tensor(labels), torch.tensor(lab_lens), BLANK)
    got.sum().backward()
    return got.detach().numpy(), tl.grad.numpy()


def jax_ctc(ref, logits, log_lens, labels, lab_lens):
    jax, jnp = ref.jax, ref.jnp

    def total(lg):
        losses = ref.ctc_loss(jax.nn.log_softmax(lg, axis=-1),
                              jnp.asarray(log_lens), jnp.asarray(labels),
                              jnp.asarray(lab_lens), BLANK)
        return losses.sum(), losses
    (_, losses), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(logits))
    return np.asarray(losses), np.asarray(grad)


def ctc_case(name):
    """``tests/test_ctc.py``'s cases: a repeated label (the skip is
    forbidden) with a lane of no label; short lanes; all-blank with a
    static zero-width label array."""
    if name == "repeated_label":
        rng = np.random.default_rng(0)
        logits = rng.standard_normal((4, 12, V)).astype(np.float32)
        labels = rng.integers(0, V - 1, (4, 5)).astype(np.int32)
        labels[1, 1] = labels[1, 0]
        return (logits, np.array([12, 9, 7, 5], np.int32), labels,
                np.array([5, 4, 0, 2], np.int32))
    if name == "short_lanes":
        rng = np.random.default_rng(1)
        logits = rng.standard_normal((3, 10, V)).astype(np.float32)
        labels = rng.integers(0, V - 1, (3, 4)).astype(np.int32)
        return (logits, np.array([10, 6, 8], np.int32), labels,
                np.array([4, 1, 3], np.int32))
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 6, V)).astype(np.float32)
    return (logits, np.array([6, 4], np.int32), np.zeros((2, 0), np.int32),
            np.zeros(2, np.int32))


@pytest.mark.parametrize("case", ["repeated_label", "short_lanes",
                                  "static_l0"])
def test_ctc_loss_matches_jax_and_torch_oracle(ref, case):
    logits, log_lens, labels, lab_lens = ctc_case(case)
    got, g_got = port_ctc(logits, log_lens, labels, lab_lens)
    want, g_want = jax_ctc(ref, logits, log_lens, labels, lab_lens)
    oracle, g_oracle = torch_oracle(logits, log_lens, labels, lab_lens)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_got, g_want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_got, g_oracle, rtol=1e-4, atol=1e-5)
    if case == "static_l0":  # the all-blank path's probability
        lp = np.asarray(ref.jax.nn.log_softmax(logits, axis=-1))
        expect = [-lp[i, :log_lens[i], BLANK].sum() for i in range(2)]
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def test_ctc_loss_impossible_alignment_is_huge_and_finite(ref):
    """More labels than frames: no path; the loss is on NEG_INF's scale,
    finite, and JAX's; its gradient has no NaN."""
    logits = np.zeros((1, 2, V), np.float32)
    args = (np.array([2], np.int32), np.array([[0, 1, 2]], np.int32),
            np.array([3], np.int32))
    got, g_got = port_ctc(logits, *args)
    want, _ = jax_ctc(ref, logits, *args)
    assert np.isfinite(got[0]) and got[0] > 1e20
    assert got[0] == pytest.approx(float(want[0]), rel=1e-6)
    assert np.isfinite(g_got).all()
    assert -NEG_INF == pytest.approx(1e30)


# -- the families' losses -----------------------------------------------------
@pytest.fixture(scope="module")
def jax_models(ref):
    """{family: (JAX model, params at PRNGKey(0))} on ``tiny``."""
    out = {}
    for fam, cls in ref.models.items():
        m = cls.from_preset("tiny")
        out[fam] = (m, m.init(ref.jax.random.PRNGKey(0)))
    return out


def host(tree):
    """A JAX tree's leaves as numpy arrays."""
    import jax
    return jax.device_get(tree)


def port_of(jax_models, family):
    jm, params = jax_models[family]
    return to_model(host(params), jm.config, family)


def assert_grads_match(model, jax_grads, cfg, family, atol=1e-5, rtol=1e-4):
    want = from_jax_params(host(jax_grads), cfg, family)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("family", ["ctc", "aed"])
def test_family_loss_and_gradients_match_jax(ref, jax_models, family):
    jm, params = jax_models[family]
    cfg = jm.config
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, cfg.n_mels, 40)).astype(np.float32)
    feat_lens = np.array([40, 27], np.int32)
    labels = rng.integers(0, cfg.blank_id, (2, 5)).astype(np.int32)
    label_lens = np.array([5, 2], np.int32)
    args = (feats, feat_lens, labels, label_lens)
    want, grads = ref.jax.jit(ref.jax.value_and_grad(jm.loss))(
        params, *(ref.jnp.asarray(a) for a in args))
    model = port_of(jax_models, family)
    got = model.loss(*(torch.from_numpy(a) for a in args))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert_grads_match(model, grads, cfg, family)


# -- the reference's seeded init ----------------------------------------------
def test_threefry_bits_equal_jax(ref):
    jax = ref.jax
    key = jax.random.PRNGKey(3)
    mine = reference_init.prng_key(3)
    assert np.array_equal(np.array(reference_init.split(mine, 4)),
                          np.asarray(jax.random.split(key, 4)))
    assert np.array_equal(np.array(reference_init.fold_in(mine, 987654321)),
                          np.asarray(jax.random.fold_in(key, 987654321)))
    np.testing.assert_array_equal(
        reference_init.uniform(mine, (3, 7), 0.0, 1.0),
        np.asarray(jax.random.uniform(key, (3, 7))))
    # XLA fuses the affine map into one rounding: within an ulp
    np.testing.assert_allclose(
        reference_init.uniform(mine, (3, 7), -0.5, 2.0),
        np.asarray(jax.random.uniform(key, (3, 7), minval=-0.5, maxval=2.0)),
        rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("seed", [0, 7])
def test_reference_init_equals_jax_init(ref, family, seed):
    """``init_training(model, seed, ...)`` gives the JAX package's
    ``init(PRNGKey(seed))`` weights (LayerScale on, so its gains count),
    within an ulp of each normal (erfinv in float64 against XLA's float32
    polynomial): rel 1e-5, atol 1e-6."""
    cfg = dataclasses.replace(TINY, layerscale=0.1)
    jm = ref.models[family](cfg)
    want = from_jax_params(host(jm.init(ref.jax.random.PRNGKey(seed))),
                           cfg, family)
    model = {"transducer": Transducer, "ctc": CTCModel,
             "aed": AEDModel}[family](cfg)
    init_training(model, seed, make_optimizer())
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# -- the optimizer ------------------------------------------------------------
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedule_matches_optax(ref, warmup):
    ours = warmup_cosine_decay_schedule(0.0, 2e-3, warmup, 15,
                                        end_value=2e-4)
    theirs = ref.optax.schedules.warmup_cosine_decay_schedule(
        0.0, 2e-3, warmup, 15, end_value=2e-4)
    got = [ours(i) for i in range(20)]
    want = [float(theirs(i)) for i in range(20)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == (0.0 if warmup else 2e-3)
    assert got[-1] == pytest.approx(2e-4, rel=1e-9)  # flat past the decay


def test_a_warmup_from_zero_moves_nothing_at_step_zero():
    model = Transducer(TINY)
    opt = make_optimizer(warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10))
    state = init_training(model, torch.Generator().manual_seed(0), opt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, opt)
    batch = next(data.synthetic_batches(2, 4000, 4, 16, 15))
    step(state, batch)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    step(state, batch)
    assert not torch.equal(model.joint.out.w, before["joint.out.w"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_three_steps_match_jax(ref, jax_models, family):
    """Three steps of the port's train step against JAX's
    ``make_train_step(make_optimizer())`` from the same converted init on
    the same ``synthetic_batches``."""
    jm, params = jax_models[family]
    cfg = jm.config
    jax_train, jax_loss, port_loss = (ref.train, ref.losses[family],
                                      FAMILIES[family])
    model = port_of(jax_models, family)
    lr = 1e-4  # make_optimizer's default in both packages
    j_opt = jax_train.make_optimizer()
    j_state = j_opt.init(params)
    j_step = jax_train.make_train_step(jm, j_opt, donate=False,
                                       loss=jax_loss)
    opt = make_optimizer()
    state = opt.init(model.parameters())
    step = make_train_step(model, opt, loss=port_loss)
    j_batches = ref.data.synthetic_batches(2, 6400, 6, cfg.vocab_size,
                                           cfg.blank_id, seed=3)
    batches = data.synthetic_batches(2, 6400, 6, cfg.vocab_size,
                                     cfg.blank_id, seed=3)
    j_params = params
    for i in range(3):
        j_params, j_state, j_loss = j_step(j_params, j_state,
                                           next(j_batches))
        loss = step(state, next(batches))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4,
                                   err_msg=f"step {i}")
    want = from_jax_params(host(j_params), cfg, family)
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2 * lr * 3, err_msg=name)
        moved = max(moved, float((p.detach() - from_jax_params(
            host(params), cfg, family)[name]).abs().max()))
    assert moved > lr  # the steps moved the weights


def test_refusals_name_the_parallelism_item():
    """A server's mesh of more than one device outside a world of one
    process per device is refused naming the launcher that starts one,
    and one that does not cover the world naming both sizes; the sharded
    step and FSDP refuse what they cannot place, by name."""
    mesh = Config(mesh_shape={"data": 2, "model": 1})
    with pytest.raises(ConfigValidationError,
                       match="torchrun --nproc-per-node 2"):
        check_supported(mesh, torch.device("cpu"), world_size=1)
    with pytest.raises(ConfigValidationError, match="covers 2 devices but "
                                                    "the world has 4"):
        check_supported(mesh, torch.device("cpu"), world_size=4)
    check_supported(mesh, torch.device("cpu"), world_size=2)
    model = Transducer(TINY)
    opt = make_optimizer()
    with pytest.raises(ValueError, match="init_training"):
        make_train_step(model, opt, mesh=object())
    with pytest.raises(ValueError, match="fsdp"):
        init_training(model, torch.Generator(), opt, fsdp=True)


# -- remat --------------------------------------------------------------------
def test_remat_training_matches_no_remat():
    """Recomputed blocks change memory, not math (the port of
    ``tests/test_parallel.py::test_remat_training_matches_no_remat``); the
    flag never reaches a forward without autograd."""
    base = Transducer(TINY).init_weights(torch.Generator().manual_seed(0))
    remat = Transducer(dataclasses.replace(TINY, remat=True))
    remat.load_state_dict(base.state_dict())
    rng = np.random.default_rng(0)
    batch = TrainBatch(
        audio=torch.from_numpy((rng.standard_normal((2, 3200)) * 0.1
                                ).astype(np.float32)),
        audio_lens=torch.tensor([3200, 2400], dtype=torch.int32),
        labels=torch.from_numpy(rng.integers(0, 15, (2, 4)).astype(
            np.int32)),
        label_lens=torch.tensor([4, 2], dtype=torch.int32))
    l1 = loss_fn(base, batch)
    l1.backward()
    l2 = loss_fn(remat, batch)
    l2.backward()
    np.testing.assert_allclose(float(l1.detach()), float(l2.detach()),
                               rtol=1e-5)
    for (name, a), b in zip(base.named_parameters(), remat.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    with torch.inference_mode():
        feats, lens = log_mel_features(batch.audio, batch.audio_lens,
                                       n_mels=TINY.n_mels)
        a, _ = base.encode(feats, lens)
        b, _ = remat.encode(feats, lens)
    assert torch.equal(a, b)


# -- the data side ------------------------------------------------------------
def test_pad_batch_matches_jax(ref):
    rng = np.random.default_rng(4)
    waves = [rng.standard_normal(n).astype(np.float32)
             for n in (900, 1500, 2000)]
    labels = [[1, 2, 3], [4] * 9, []]
    got = data.pad_batch(waves, labels, 1600, 6)
    assert_batches_equal(got, ref.data.pad_batch(waves, labels, 1600, 6))
    assert got.labels.dtype == torch.int32


def stream_of(stream, data_mod, digits_mod, synth_mod):
    if stream == "synthetic":
        return data_mod.synthetic_batches(3, 8000, 10, 1030, 1024, seed=2)
    if stream == "digits":
        return digits_mod.digit_batches(4, audio_bucket=40000,
                                        label_bucket=10, seed=1,
                                        max_words=9)
    long = stream == "synthspeech_long"
    return synth_mod.synthspeech_batches(
        2, audio_bucket=160000 if long else 48000,
        label_bucket=40 if long else 24, seed=5, max_len=10, long_form=long)


@pytest.mark.parametrize("stream", ["synthetic", "digits", "synthspeech",
                                    "synthspeech_long"])
def test_batch_streams_match_jax(ref, stream):
    got = stream_of(stream, data, port_digits, synthspeech)
    want = stream_of(stream, ref.data, ref.digits, ref.synth)
    for _ in range(2):
        assert_batches_equal(next(got), next(want))


def write_wav(path, samples, channels=1):
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    if channels == 2:
        pcm = np.stack([pcm, pcm[::-1]], axis=1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def test_load_wav_and_manifest_batches_match_jax(ref, tmp_path):
    rng = np.random.default_rng(6)
    stereo = tmp_path / "stereo.wav"
    write_wav(stereo, 0.3 * rng.standard_normal(3000), channels=2)
    np.testing.assert_array_equal(data.load_wav(str(stereo)),
                                  ref.data.load_wav(str(stereo)))
    vocab = Vocabulary.load("model-repo/vocab.txt")
    manifest = synthspeech.write_manifest(tmp_path / "m", vocab, n_utts=5,
                                          seed=3)
    jax_manifest = ref.synth.write_manifest(
        tmp_path / "j", ref.Vocabulary.load("model-repo/vocab.txt"),
        n_utts=5, seed=3)
    lines = [json.loads(x) for x in open(manifest)]
    jax_lines = [json.loads(x) for x in open(jax_manifest)]
    assert ([(e["text"], e["token_ids"]) for e in lines]
            == [(e["text"], e["token_ids"]) for e in jax_lines])
    for a, b in zip(lines, jax_lines):
        assert (open(a["audio_filepath"], "rb").read()
                == open(b["audio_filepath"], "rb").read())
    got = data.manifest_batches(str(manifest), vocab, 2, 96000, 24,
                                shuffle_seed=1, epochs=2)
    want = ref.data.manifest_batches(
        str(manifest), ref.Vocabulary.load("model-repo/vocab.txt"), 2, 96000,
        24, shuffle_seed=1, epochs=2)
    got, want = list(got), list(want)
    assert len(got) == len(want) == 4  # two full batches of 2 per epoch
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


def test_digits_vocab_matches_jax(ref, tmp_path):
    jax_digits = ref.digits
    assert digits_vocab_map() == jax_digits.digits_vocab_map()
    write_digits_vocab(tmp_path / "a.txt")
    jax_digits.write_digits_vocab(tmp_path / "b.txt")
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt"
                                                 ).read_bytes()
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        assert (random_sentence(rng_a, 2, 14)
                == jax_digits.random_sentence(rng_b, 2, 14))


# -- testing/synthspeech.py: the cases of tests/test_synthspeech.py -----------
def test_tone_code_unique_and_banded(ref):
    seen = set()
    for tok in range(synthspeech.FIRST_ID, synthspeech.LAST_ID + 1):
        f1, f2 = synthspeech._tone_freqs(tok)
        assert 200 <= f1 <= 1550 and 1650 <= f2 <= 6900
        key = (round(f1, 3), round(f2, 3))
        assert key not in seen
        seen.add(key)
        assert (f1, f2) == ref.synth._tone_freqs(tok)


def test_synth_deterministic_without_rng(ref):
    a = synthspeech.synth_token_ids([5, 900, 42], noise=0.0)
    b = synthspeech.synth_token_ids([5, 900, 42], noise=0.0)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and np.abs(a).max() <= 1.0
    np.testing.assert_array_equal(
        synthspeech.synth_token_ids([5, 900, 42], noise=0.02, rate=1.1,
                                    rng=np.random.default_rng(1)),
        ref.synth.synth_token_ids([5, 900, 42], noise=0.02, rate=1.1,
                                  rng=np.random.default_rng(1)))


def test_rate_scales_duration():
    slow = synthspeech.synth_token_ids([10, 20], rate=0.8)
    fast = synthspeech.synth_token_ids([10, 20], rate=1.3)
    assert len(slow) > len(fast)


def test_unrenderable_ids_skipped():
    only_specials = synthspeech.synth_token_ids([0, 1024], noise=0.0)
    with_tok = synthspeech.synth_token_ids([0, 7, 1024], noise=0.0)
    assert len(with_tok) > len(only_specials)


def test_random_token_ids_in_range(ref):
    rng = np.random.default_rng(0)
    rng_ref = np.random.default_rng(0)
    for _ in range(20):
        ids = synthspeech.random_token_ids(rng, 4, 18)
        assert 4 <= len(ids) <= 18
        assert all(synthspeech.FIRST_ID <= i <= synthspeech.LAST_ID
                   for i in ids)
        assert ids == ref.synth.random_token_ids(rng_ref, 4, 18)


def test_synthspeech_batch_shapes():
    batch = next(synthspeech_batches(3, audio_bucket=48000, label_bucket=24,
                                     seed=1, max_len=10))
    assert batch.audio.shape == (3, 48000)
    assert batch.labels.shape == (3, 24)
    assert (batch.label_lens >= 4).all() and (batch.audio_lens > 0).all()
    for i in range(3):
        row = batch.labels[i, :batch.label_lens[i]]
        assert ((row >= synthspeech.FIRST_ID)
                & (row <= synthspeech.LAST_ID)).all()


def test_manifest_roundtrip(tmp_path):
    vocab = Vocabulary.load("model-repo/vocab.txt")
    manifest = synthspeech.write_manifest(tmp_path, vocab, n_utts=3, seed=9)
    lines = [json.loads(ln) for ln in open(manifest)]
    assert len(lines) == 3
    for e in lines:
        assert e["text"] == vocab.decode_tokens(e["token_ids"])
        with wave.open(e["audio_filepath"], "rb") as w:
            assert w.getframerate() == 16000
            assert w.getnframes() > 16000  # >= 1 s of audio
    manifest2 = synthspeech.write_manifest(tmp_path / "again", vocab,
                                           n_utts=3, seed=9)
    lines2 = [json.loads(ln) for ln in open(manifest2)]
    assert ([e["token_ids"] for e in lines]
            == [e["token_ids"] for e in lines2])


# -- checkpoints --------------------------------------------------------------
@pytest.mark.parametrize("family", ["transducer", "ctc", "aed"])
def test_checkpoint_roundtrip(tmp_path, family):
    """Parameters bit-equal after ``save_checkpoint``/``load_checkpoint``,
    and ``convert.load_checkpoint`` reads the same file."""
    cls = {"transducer": Transducer, "ctc": CTCModel, "aed": AEDModel}[family]
    model = cls(TINY).init_weights(torch.Generator().manual_seed(42))
    path = tmp_path / "ckpt.npz"
    model.save_checkpoint(path)
    for restored in (cls(TINY).load_checkpoint(path),
                     load_checkpoint(cls(TINY), path)):
        want = model.state_dict()
        assert set(restored.state_dict()) == set(want)
        for k, v in restored.state_dict().items():
            assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match=".npz"):
        model.save_checkpoint(tmp_path / "ckpt")


def test_checkpoint_drives_identical_decode(tmp_path):
    """``tests/test_checkpoint.py::test_checkpoint_drives_identical_decode``
    at ``tiny``, on the port's ``.npz``."""
    model = Transducer(TINY).init_weights(torch.Generator().manual_seed(1))
    path = tmp_path / "ckpt2.npz"
    model.save_checkpoint(path)
    restored = Transducer(TINY).load_checkpoint(path)
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.standard_normal((1, 8, TINY.d_enc)).astype(
        np.float32))
    with torch.inference_mode():
        r1 = greedy_decode_transducer(model, enc, torch.tensor([8]))
        r2 = greedy_decode_transducer(restored, enc, torch.tensor([8]))
    assert torch.equal(r1.tokens, r2.tokens)
    assert torch.equal(r1.counts, r2.counts)


# -- the trainer CLI ----------------------------------------------------------
def test_cli_synthetic_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "amira_rust_asr_server_tpu_torch.train",
         "--backend", "cpu", "--preset", "tiny", "--synthetic", "--steps",
         "3"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    losses = [float(line.split()[3]) for line in proc.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))  # steps 0 and 2


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(DeviceError):
        cli.main(["--synthetic", "--steps", "1"])


def test_cli_refuses_a_mesh():
    """A mesh larger than the world is refused by name (one rank per
    device: this process alone is a world of one)."""
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 1"):
        cli.main(["--backend", "cpu", "--mesh", "data=2,model=2"])


def test_cli_trains_on_a_one_rank_mesh(tmp_path):
    """``--mesh data=1,model=1`` without torchrun: a one-rank world on a
    file store, the placed model's two steps equal the plain ones."""
    args = ["--backend", "cpu", "--synthetic", "--steps", "2"]
    assert cli.main([*args, "--mesh", "data=1,model=1", "--ckpt-out",
                     str(tmp_path / "mesh.npz")]) == 0
    assert cli.main([*args, "--ckpt-out", str(tmp_path / "one.npz")]) == 0
    got, want = load_npz(tmp_path / "mesh.npz"), load_npz(tmp_path / "one.npz")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_cli_digits_saves_a_checkpoint_the_repository_serves(tmp_path,
                                                             capsys):
    """The digits mode end to end on the CPU, cut to two steps: it writes
    an ``.npz`` and its pointer, and a server whose model repository holds
    them loads the checkpoint by name (the load route's ``hot_swap``) and
    decodes the probe sentence to the trainer's own tokens."""
    repo = tmp_path / "repo"
    repo.mkdir()
    rc = cli.main(["--backend", "cpu", "--digits", "--steps", "2",
                   "--warmup", "1", "--eval-sentences", "2", "--min-acc",
                   "0", "--ckpt-out", str(repo / "digits-run.npz")])
    assert rc == 0
    assert "held-out exact match: " in capsys.readouterr().out
    pointer = json.loads((repo / "digits-run.json").read_text())
    assert pointer["family"] == "transducer" and pointer["preset"] == "tiny"
    assert pointer["held_out_exact_match"] >= 0.0
    state = build_state(
        Config(model_repo_path=str(repo), inference_backend="cpu",
               compute_dtype="float32", batch_buckets=[1],
               vocabulary_path="model-repo/tiny-digits-vocab.txt"),
        preset="tiny", warmup=False)
    hot_swap(state, "digits-run")
    trained = Transducer(TINY).load_checkpoint(repo / "digits-run.npz")
    for name, t in state.pipeline.model.state_dict().items():
        assert torch.equal(t, trained.state_dict()[name]), name
    tr = state.pipeline.process_batch(pcm16_digits(["two", "five", "nine"]))
    assert [int(t) for t in tr.tokens] == pointer["probe"]["tokens"]
    # below --min-acc nothing is written
    rc = cli.main(["--backend", "cpu", "--digits", "--steps", "1",
                   "--warmup", "0", "--eval-sentences", "1",
                   "--ckpt-out", str(tmp_path / "no.npz")])
    assert rc == 1 and not (tmp_path / "no.npz").exists()


# -- on the card ----------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_memory_light_loss_equals_full_lattice_on_gpu(dev):
    """At the flagship's joint widths (B 4, T 76, U 24, V 1030, f32): the
    loss within rel 1e-5 of the full lattice's, each gradient of the
    joint and the prediction net and the encoder output's within rel
    1e-4 of its norm; the joint and the recurrence (from the prediction
    net's outputs, with the weights' gradients allocated) peak below the
    lattice's bytes."""
    cfg = dataclasses.replace(LARGE, n_layers=1)
    model = Transducer(cfg).init_weights(
        torch.Generator().manual_seed(0)).to(dev)
    b, t, u = 4, 76, 24
    rng = np.random.default_rng(11)
    enc = torch.from_numpy(rng.standard_normal((b, t, cfg.d_enc)).astype(
        np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 1024, (b, u)).astype(
        np.int32)).to(dev)
    enc_lens = torch.tensor([76, 70, 60, 40], dtype=torch.int32, device=dev)
    label_lens = torch.tensor([24, 20, 11, 0], dtype=torch.int32, device=dev)
    grads = []
    for fn in (transducer_loss, transducer_loss_lattice):
        model.zero_grad(set_to_none=True)
        x = enc.clone().requires_grad_()
        loss = fn(model, x, enc_lens, labels, label_lens).sum()
        loss.backward()
        grads.append((float(loss.detach()), x.grad, {
            n: p.grad.clone() for n, p in model.named_parameters()
            if not n.startswith("encoder.")}))
    (l1, g1, p1), (l2, g2, p2) = grads
    assert l1 == pytest.approx(l2, rel=1e-5)
    assert float((g1 - g2).norm()) <= 1e-4 * float(g2.norm())
    for name, g in p1.items():
        assert float((g - p2[name]).norm()) <= 1e-4 * float(
            p2[name].norm()), name
    with torch.no_grad():
        pred_seq = model.predict_forward(labels, model.init_state(
            b, device=dev))[0]
    peaks = []
    for fn in (joint_loss, joint_loss_lattice):
        for _ in range(2):  # the first run allocates the weights' gradients
            model.zero_grad(set_to_none=False)
            x = enc.clone().requires_grad_()
            p_in = pred_seq.clone().requires_grad_()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn(model.joint, x, p_in, enc_lens, labels, label_lens,
               cfg.blank_id).sum().backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        peaks.append(peak)
    lattice_bytes = b * t * (u + 1) * cfg.vocab_size * 4
    assert peaks[0] < lattice_bytes < peaks[1]


def test_train_step_mel_kernel_matches_plain_on_gpu(dev):
    """A train step's features go through ``csrc/mel.cu`` (one launch per
    step) and equal the plain version's within rel 1e-3, as phase C holds
    the kernel."""
    batch = next(digit_batches(4, audio_bucket=32000, label_bucket=8))
    audio, lens = batch.audio.to(dev), batch.audio_lens.to(dev)
    got, got_lens = log_mel_features(audio, lens, n_mels=TINY.n_mels)
    want, want_lens = features.log_mel_features(audio, lens,
                                                n_mels=TINY.n_mels)
    assert torch.equal(got_lens, want_lens)
    err = float((got - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max())
    model = Transducer(TINY).to(dev)
    opt = make_optimizer(1e-3)
    state = init_training(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, opt)
    kernels.reset_launch_counts()
    loss = step(state, batch)
    assert kernels.launch_counts()["log_mel"] == 1
    assert torch.isfinite(loss)
