"""PyTorch port: log-mel features against the JAX reference.

Inputs come from a seeded numpy generator and go to both sides as numpy.
The CPU path of the kernel wrapper is the plain PyTorch version, so these
tests pin the arithmetic the CUDA kernel is held against on the card
(tests/test_torch_kernels.py, chip_smoke.py phase C).

Tolerances: both sides compute in f32 and sum in different orders (the
reference's hop-decomposed DFT vs one framed matmul), which shows in log
space where the power is small: 5e-4 absolute on normalized features,
5e-4 against the f64 FFT oracle in log space.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.constants import SAMPLE_RATE
from amira_rust_asr_server_tpu.ops import log_mel_features as jax_log_mel
from amira_rust_asr_server_tpu.ops import mel as jax_mel
from amira_rust_asr_server_tpu.ops.features import log_mel_oracle
from amira_rust_asr_server_tpu.ops.pallas.mel_kernel import \
    log_mel_features_pallas
from amira_rust_asr_server_tpu_torch.ops import features, mel
from amira_rust_asr_server_tpu_torch.ops.kernels import mel as mel_kernel

torch.set_num_threads(2)
ATOL = 5e-4


def waves(rng, lens, n):
    w = np.zeros((len(lens), n), np.float32)
    t = np.arange(n) / SAMPLE_RATE
    for i, m in enumerate(lens):
        w[i, :m] = (rng.standard_normal(m) * 0.1
                    + 0.4 * np.sin(2 * np.pi * (300 + 200 * i) * t[:m]))
    return w


def test_bases_equal_reference():
    np.testing.assert_array_equal(mel.windowed_dft_basis(),
                                  jax_mel.windowed_dft_basis())
    for n_mels in (128, 32):
        np.testing.assert_array_equal(mel.mel_filterbank(n_mels),
                                      jax_mel.mel_filterbank(n_mels))


@pytest.mark.parametrize("n_mels", [128, 32])
def test_ragged_batch_matches_jax(rng, n_mels):
    lens = np.array([16000, 9001, 3000], np.int32)
    w = waves(rng, lens, 16000)
    ref, ref_lens = jax_log_mel(jnp.asarray(w), jnp.asarray(lens),
                                n_mels=n_mels)
    got, got_lens = features.log_mel_features(
        torch.from_numpy(w), torch.from_numpy(lens), n_mels=n_mels)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    # frames past each length are exactly zero
    for i, fl in enumerate(got_lens.numpy()):
        assert np.abs(got.numpy()[i, :, fl:]).max(initial=0.0) == 0.0


def test_kernel_wrapper_matches_pallas_interpret(rng):
    """The wrapper's CPU path against the TPU kernel run as the reference's
    own tests run it (interpret mode)."""
    lens = np.array([12000, 16000], np.int32)
    w = waves(rng, lens, 16000)
    ref, ref_lens = log_mel_features_pallas(
        jnp.asarray(w), jnp.asarray(lens), interpret=True)
    got, got_lens = mel_kernel.log_mel_features(torch.from_numpy(w),
                                                torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_raw_log_mel_matches_fft_oracle(rng):
    n = 8000
    w = waves(rng, [n], n)
    raw = mel_kernel.log_mel_raw(
        features.preprocess(torch.from_numpy(w), torch.tensor([n])), 128)
    oracle = log_mel_oracle(w[0])                     # [n_mels, T] f64
    np.testing.assert_allclose(raw[0].numpy().T, oracle, atol=ATOL, rtol=0)


def test_padding_invariance(rng):
    """A sequence's features do not depend on how far its row is padded."""
    n = 7000
    w = waves(rng, [n], n)
    solo, _ = features.log_mel_features(torch.from_numpy(w),
                                        torch.tensor([n]))
    padded = np.zeros((2, 32000), np.float32)
    padded[0, :n] = w[0]
    padded[1] = waves(rng, [32000], 32000)[0]
    batch, lens = features.log_mel_features(torch.from_numpy(padded),
                                            torch.tensor([n, 32000]))
    t = int(lens[0])
    np.testing.assert_allclose(batch[0, :, :t].numpy(), solo[0].numpy(),
                               atol=1e-5, rtol=0)
    assert np.abs(batch[0, :, t:].numpy()).max() == 0.0


def test_kernel_bases_layout():
    """The CUDA kernel's basis (window rows 56..455, bins padded to 320)
    holds exactly the reference basis, and the rows it skips are zero."""
    basis = mel.windowed_dft_basis()
    re, im, fb = mel_kernel.kernel_bases(torch.device("cpu"), 128)
    off, win, nb = mel_kernel.WIN_OFF, 400, mel_kernel.N_BINS
    np.testing.assert_array_equal(re.numpy()[:, :nb], basis[off:off + win,
                                                            :nb])
    np.testing.assert_array_equal(im.numpy()[:, :nb], basis[off:off + win,
                                                            nb:])
    assert not re.numpy()[:, nb:].any() and not im.numpy()[:, nb:].any()
    outside = np.concatenate([basis[:off], basis[off + win:]])
    assert not outside.any()
    np.testing.assert_array_equal(fb.numpy(), mel.mel_filterbank(128))
