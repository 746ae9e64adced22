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
    """The CUDA kernel's basis (416 rows from window row 56, each bin's re,
    im columns side by side, bins padded to 264) and filterbank (rows padded
    to 264) hold the reference's exactly as three bf16 parts packed in row
    pairs: each part a bf16 value, the parts' sum the f32 value, and the
    rows the kernel skips zero."""
    basis = mel.windowed_dft_basis()
    packed_basis, packed_fb = (x.numpy() for x in mel_kernel.kernel_bases(
        torch.device("cpu"), 128))
    off, rows, nb = mel_kernel.WIN_OFF, mel_kernel.WIN_ROWS, mel_kernel.N_BINS
    assert packed_basis.shape == (3, rows // 2, 2 * mel_kernel.BINS_PAD)
    assert packed_fb.shape == (3, mel_kernel.BINS_PAD // 2, 128)
    parts = unpack_row_pairs(packed_basis)
    pair = parts.astype(np.float64).sum(0).reshape(rows, -1, 2)
    want = np.zeros_like(pair)
    want[:, :nb, 0] = basis[off:off + rows, :nb]
    want[:, :nb, 1] = basis[off:off + rows, nb:]
    np.testing.assert_array_equal(pair, want)
    assert not pair[:, nb:].any() and not pair[400:].any()
    outside = np.concatenate([basis[:off], basis[off + 400:]])
    assert not outside.any()
    fb = np.zeros((mel_kernel.BINS_PAD, 128))
    fb[:nb] = mel.mel_filterbank(128)
    np.testing.assert_array_equal(
        unpack_row_pairs(packed_fb).astype(np.float64).sum(0), fb)


def unpack_row_pairs(words: np.ndarray) -> np.ndarray:
    """``[3, K / 2, N]`` int32 words -> ``[3, K, N]`` f32 bf16 parts."""
    w = words.view(np.uint32)
    out = np.empty((w.shape[0], 2 * w.shape[1], w.shape[2]), np.uint32)
    out[:, 0::2] = w << 16
    out[:, 1::2] = w & np.uint32(0xFFFF0000)
    return out.view(np.float32)


def test_bf16_split3_is_exact():
    """Every f32 value the kernel splits (samples, power; here 1e-30 to
    1e30 and rounding ties) is the exact sum of its three bf16 parts, each
    a bf16 value."""
    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
        np.float32([0.0, -0.0, 1.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                    -1.1754944e-38])]).astype(np.float32)
    parts = mel_kernel.bf16_split3(x)
    assert not (parts.view(np.uint32) & 0xFFFF).any()
    np.testing.assert_array_equal(parts.astype(np.float64).sum(0), x)


def log_mel_bf16x6(xp: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch: both products as the
    six part products ``a_i b_j`` (``i + j <= 2``) of the three bf16 parts
    (``bf16_split3``) of the frames, the power and the kernel's bases; the
    products summed in float64 (each is exact in the kernel's f32
    accumulator), the spectrum and the mel sums held in f32 as the kernel
    holds them."""
    basis, fb = (unpack_row_pairs(x.numpy()).astype(np.float64)
                 for x in mel_kernel.kernel_bases(torch.device("cpu"), n_mels))
    off, rows = mel_kernel.WIN_OFF, mel_kernel.WIN_ROWS
    frames = xp.unfold(1, 512, 160)[:, :, off:off + rows].numpy()

    def product(a, b_parts):
        a_parts = mel_kernel.bf16_split3(a).astype(np.float64)
        terms = [(i, j) for i in range(3) for j in range(3) if i + j <= 2]
        return sum(a_parts[i] @ b_parts[j] for i, j in terms).astype(
            np.float32)

    spec = product(frames, basis)
    power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    return torch.log(torch.from_numpy(product(power, fb)) + 2.0 ** -24)


@pytest.mark.parametrize("audio", ["tiny_digits", "noise"])
def test_bf16x6_split_holds_log_mel_raw(audio):
    """The kernel's split keeps f32's precision: against the DFT in
    float64, its log-mel error stays within the plain f32 version's own
    (largest in bins whose power nears the 2^-24 guard, where the DFT
    cancels), and within the kernel's 1e-3 of the plain version; plain TF32
    would be ~1e-1 off (ops/features.py)."""
    from amira_rust_asr_server_tpu_torch.testing import (DIGIT_WORDS,
                                                         synth_digits)
    rng = np.random.default_rng(17)
    if audio == "tiny_digits":
        w = np.stack([synth_digits([DIGIT_WORDS[j] for j in
                                    rng.integers(0, 10, 4)], noise=0.004,
                                   rng=rng)[:16000] for _ in range(2)])
    else:
        w = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    w = torch.from_numpy(w)
    xp = features.preprocess(w, torch.full((2,), w.shape[1]))
    got = log_mel_bf16x6(xp, 128)
    plain = features.log_mel_raw(xp, 128)
    basis, fb = (torch.from_numpy(x).double() for x in
                 (mel.windowed_dft_basis(), mel.mel_filterbank(128)))
    spec = xp.double().unfold(1, 512, 160) @ basis
    f64 = torch.log((spec[..., :257] ** 2 + spec[..., 257:] ** 2) @ fb
                    + 2.0 ** -24)
    err = (got.double() - f64).abs().max().item()
    err_plain = (plain.double() - f64).abs().max().item()
    assert got.shape == plain.shape
    assert err <= err_plain, (err, err_plain)
    assert (got - plain).abs().max().item() <= 1e-3
