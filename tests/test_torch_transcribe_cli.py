"""PyTorch port: the offline transcription CLI
(``python -m amira_rust_asr_server_tpu_torch.transcribe``, after
``tests/test_transcribe_cli.py``) on the CPU, and the GPU selfcheck's
refusal to run without a card.

The CLI's tokens on the committed tiny-digits weights (the converted
``assets/tiny_digits*.npz``) equal the JAX pipeline's on the orbax tree
they were converted from (f32), and transcribe "two five nine".
"""

import importlib.util
import json
import pathlib
import wave

import jax
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch import transcribe
from amira_rust_asr_server_tpu_torch.errors import DeviceError
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_FAMILY_NPZ,
                                                     TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     synth_digits)

REPO = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def _write_wav(path, samples_f32, channels=1):
    pcm = (np.clip(samples_f32, -1, 1) * 32767).astype("<i2")
    if channels == 2:
        pcm = np.stack([pcm, pcm], axis=1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def test_load_wav_mono_and_stereo(tmp_path):
    sig = 0.25 * np.sin(np.linspace(0, 100, 1600)).astype(np.float32)
    _write_wav(tmp_path / "m.wav", sig)
    _write_wav(tmp_path / "s.wav", sig, channels=2)
    mono = transcribe.load_wav(str(tmp_path / "m.wav"))
    stereo = transcribe.load_wav(str(tmp_path / "s.wav"))
    assert mono.dtype == np.float32 and mono.shape == (1600,)
    np.testing.assert_allclose(mono, stereo, atol=1e-4)
    np.testing.assert_allclose(mono, sig, atol=1e-3)


def test_load_wav_rejects_wrong_rate(tmp_path):
    with wave.open(str(tmp_path / "x.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(b"\x00\x00" * 100)
    with pytest.raises(ValueError, match="16 kHz"):
        transcribe.load_wav(str(tmp_path / "x.wav"))


def _jax_digits_tokens(samples):
    """The JAX pipeline on the tiny-digits orbax tree, f32."""
    model = JaxTransducer.from_preset("tiny")
    params = model.load_checkpoint(
        str(REPO / "model-repo" / "tiny-digits"),
        like=jax.jit(model.init)(jax.random.PRNGKey(0)))
    cfg = JaxConfig(compute_dtype="float32", warmup_on_start=False)
    pipe = JaxPipeline(model, params,
                       JaxVocabulary.load(str(TINY_DIGITS_VOCAB)), cfg)
    return pipe.process_batch_samples(samples).tokens


@pytest.mark.parametrize("family", ["transducer", "ctc", "aed"])
def test_cli_end_to_end_tiny_digits(tmp_path, capsys, family):
    """One JSON line per good file; a bad file is reported on stderr and
    makes the exit code 1 while the good file is still transcribed."""
    sig = synth_digits(["two", "five", "nine"], noise=0.004,
                       rng=np.random.default_rng(0))
    _write_wav(tmp_path / "ok.wav", sig)
    (tmp_path / "bad.wav").write_bytes(b"not a wav")
    npz = (TINY_DIGITS_NPZ if family == "transducer"
           else TINY_DIGITS_FAMILY_NPZ[family])
    rc = transcribe.main([
        str(tmp_path / "bad.wav"), str(tmp_path / "ok.wav"),
        "--preset", "tiny", "--family", family, "--backend", "cpu",
        "--compute-dtype", "float32", "--checkpoint", str(npz),
        "--vocab", str(TINY_DIGITS_VOCAB), "--json"])
    assert rc == 1
    out, err = capsys.readouterr()
    assert "bad.wav" in json.loads(err.strip().splitlines()[-1])["file"]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["file"].endswith("ok.wav")
    assert rec["transcription"] == "two five nine"
    assert rec["audio_seconds"] == round(len(sig) / 16000, 3)
    assert all(isinstance(t, int) for t in rec["tokens"])
    if family == "transducer":
        want = _jax_digits_tokens(transcribe.load_wav(
            str(tmp_path / "ok.wav")))
        assert rec["tokens"] == [int(t) for t in want]


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    _write_wav(tmp_path / "ok.wav", np.zeros(1600, np.float32))
    with pytest.raises(DeviceError):
        transcribe.main([str(tmp_path / "ok.wav"), "--preset", "tiny",
                         "--vocab", str(TINY_DIGITS_VOCAB)])


def test_gpu_selfcheck_refuses_without_cuda(monkeypatch):
    """tools/gpu_selfcheck.py raises DeviceError without a card, before it
    runs any check on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    spec = importlib.util.spec_from_file_location(
        "gpu_selfcheck", REPO / "tools" / "gpu_selfcheck.py")
    selfcheck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(selfcheck)
    ran = []
    monkeypatch.setattr(selfcheck, "run", lambda *a: ran.append(a))
    with pytest.raises(DeviceError):
        selfcheck.main(["--preset", "tiny"])
    assert ran == []
