"""PyTorch port: its own copies of the reference's leaf modules.

The port imports nothing of the JAX package, so ``constants``, ``config``,
``errors``, ``vocab``, ``reliability`` and the spoken-digits audio of
``testing`` are copies. These tests hold each copy against the original:

- ``Config`` gives the same field values for the same defaults, toml, yaml
  and environment layers, and rejects what the reference rejects;
- the error classes keep the reference's names, hierarchy, HTTP statuses
  and codes;
- ``Vocabulary`` decodes, encodes and groups words as the reference does on
  the committed 1025-line ``model-repo/vocab.txt``;
- the constants and the digit audio are equal;
- importing every module of the port (``pkgutil.walk_packages``) loads no
  module of the JAX package (in a subprocess: this process has it loaded).
"""

import dataclasses
import inspect
import os
import pathlib
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from amira_rust_asr_server_tpu import constants as jax_constants
from amira_rust_asr_server_tpu import errors as jax_errors
from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.testing import digits as jax_digits
from amira_rust_asr_server_tpu.utils import platform as jax_platform
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch import constants, errors, testing
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.server import app as server_app
from amira_rust_asr_server_tpu_torch.types import TokenInfo
from amira_rust_asr_server_tpu_torch.utils import platform
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

REPO = pathlib.Path(__file__).resolve().parents[1]

LAYERS = {
    "defaults": ({}, {}),
    "toml": ({"config.toml": 'server_port = 9000\ndecoding_mode = "beam"\n'
                             "batch_buckets = [1, 4]\n"}, {}),
    "yaml": ({"config.toml": "server_port = 9000\n",
              "config.yaml": "server_port: 9100\nbeam_width: 7\n"
                             "audio_sec_buckets: [2.0, 30.0]\n"}, {}),
    "amira_env": ({"config.yaml": "server_port: 9100\n"},
                  {"AMIRA_SERVER_PORT": "9200",
                   "AMIRA_ENABLE_PLATFORM_OPTIMIZATIONS": "false",
                   "AMIRA_INFERENCE_TIMEOUT_SECS": "2.5",
                   "AMIRA_BATCH_BUCKETS": "1,2,8"}),
    "legacy_env": ({}, {"AMIRA_SERVER_PORT": "9200", "SERVER_PORT": "9300",
                        "VOCABULARY_PATH": "/tmp/v.txt"}),
}


@pytest.mark.parametrize("layer", list(LAYERS))
def test_config_layers_match_jax(tmp_path, layer):
    files, env = LAYERS[layer]
    for name, text in files.items():
        (tmp_path / name).write_text(text, encoding="utf-8")
    got = Config.load(search_dir=tmp_path, env=env)
    want = JaxConfig.load(search_dir=tmp_path, env=env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.to_toml() == want.to_toml()
    assert got.to_yaml() == want.to_yaml()


@pytest.mark.parametrize("field, value", [
    ("server_port", 0), ("inference_timeout_secs", 1000.0),
    ("beam_width", 0), ("decoding_mode", "viterbi"),
    ("vocabulary_path", "../../etc/passwd"), ("batch_buckets", [4, 1])])
def test_config_validation_matches_jax(field, value):
    got, want = Config(), JaxConfig()
    setattr(got, field, value)
    setattr(want, field, value)
    with pytest.raises(jax_errors.ConfigValidationError) as w:
        want.validate()
    with pytest.raises(errors.ConfigValidationError) as g:
        got.validate()
    assert str(g.value) == str(w.value)


def test_config_env_parse_error_is_the_ports_own(tmp_path):
    with pytest.raises(errors.ConfigValidationError, match="cannot parse"):
        Config.load(search_dir=tmp_path, env={"AMIRA_SERVER_PORT": "x"})


def _error_classes(module):
    return {n: c for n, c in vars(module).items()
            if inspect.isclass(c) and issubclass(c, Exception)
            and c.__module__ == module.__name__}


def test_error_classes_match_jax():
    got, want = _error_classes(errors), _error_classes(jax_errors)
    assert sorted(got) == sorted(want)
    for name, cls in want.items():
        mine = got[name]
        assert [b.__name__ for b in mine.__mro__] == \
            [b.__name__ for b in cls.__mro__], name
        assert (mine.http_status, mine.code) == (cls.http_status, cls.code)
        assert mine("boom").to_json() == cls("boom").to_json()
    assert not issubclass(errors.DeviceError, jax_errors.AppError)


def test_vocabulary_matches_jax_on_committed_vocab():
    path = REPO / "model-repo" / "vocab.txt"
    got, want = Vocabulary.load(path), JaxVocabulary.load(path)
    assert (len(got), got.max_id) == (len(want), want.max_id) == (1025, 1024)
    ids = np.random.default_rng(5).integers(0, 1030, (20, 30))
    for row in ids:
        assert got.decode_tokens(row) == want.decode_tokens(row)
    for text in ("hello world", "The Cat sat on the mat", "  amira  ", ""):
        assert got.encode_text(text) == want.encode_text(text)
    details = [TokenInfo(id=int(i), time_s=0.04 * k, confidence=0.5 + k / 99)
               for k, i in enumerate(ids[0])]
    assert got.decode_words(details) == want.decode_words(details)
    assert [got.get_token(i) for i in range(1030)] == \
        [want.get_token(i) for i in range(1030)]


def test_constants_match_jax():
    names = [n for n in vars(jax_constants) if n.isupper()]
    assert names and sorted(names) == sorted(
        n for n in vars(constants) if n.isupper())
    for n in names:
        got, want = getattr(constants, n), getattr(jax_constants, n)
        if dataclasses.is_dataclass(want):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, n


def test_digit_audio_matches_jax():
    assert testing.DIGIT_WORDS == jax_digits.DIGIT_WORDS
    words = ["three", "five", "zero", "nine"]
    np.testing.assert_array_equal(testing.synth_digits(words),
                                  jax_digits.synth_digits(words))
    np.testing.assert_array_equal(
        testing.synth_digits(words, noise=0.01,
                             rng=np.random.default_rng(3)),
        jax_digits.synth_digits(words, noise=0.01,
                                rng=np.random.default_rng(3)))


def test_port_imports_nothing_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import amira_rust_asr_server_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    port.__path__, port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "ref = 'amira_rust_asr_server_tpu'\n"
        "bad = [m for m in sys.modules\n"
        "       if m == ref or m.startswith(ref + '.')]\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30


@pytest.fixture
def no_cloud_request(monkeypatch):
    """Both packages' cloud probes without the metadata request."""
    monkeypatch.setattr(platform, "detect_cloud",
                        lambda: platform.CloudInfo(provider="unknown"))
    monkeypatch.setattr(jax_platform, "detect_cloud",
                        lambda: jax_platform.CloudInfo(provider="unknown"))


def test_platform_effective_config_matches_jax(no_cloud_request):
    """For the same config the two probes differ only in the mesh, and the
    mesh rule is the same given the device count: the reference sees the 8
    host devices of the test mesh, the port one CPU device."""
    cfg_kw = dict(inference_backend="cpu", server_port=9123)
    got = platform.initialize_platform(Config(**cfg_kw))
    want = jax_platform.initialize_platform(JaxConfig(**cfg_kw))
    assert got.devices.platform == "cpu" and got.devices.n_devices == 1
    mine = dataclasses.asdict(got.effective_config)
    ref = dataclasses.asdict(want.effective_config)
    assert want.devices.n_devices == 8
    assert ref.pop("mesh_shape") == {"data": 8, "model": 1}
    assert mine.pop("mesh_shape") == {}
    assert mine == ref
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]


def test_platform_mesh_rule_follows_the_device_count(no_cloud_request,
                                                     monkeypatch):
    four = dataclasses.replace(platform.detect_devices(), platform="cuda",
                               n_devices=4)
    monkeypatch.setattr(platform, "detect_devices", lambda: four)
    cfg = platform.initialize_platform(Config()).effective_config
    assert cfg.mesh_shape == {"data": 4, "model": 1}
    kept = platform.initialize_platform(
        Config(mesh_shape={"data": 2, "model": 2})).effective_config
    assert kept.mesh_shape == {"data": 2, "model": 2}


def test_platform_keeps_the_accelerator_backend(no_cloud_request):
    """The reference rewrites inference_backend="tpu" to "cpu" when it sees
    no TPU; the port keeps it (resolve_device then raises DeviceError
    without CUDA): the deliberate deviation of ROADMAP queue 3."""
    got = platform.initialize_platform(Config(inference_backend="tpu"))
    want = jax_platform.initialize_platform(JaxConfig(inference_backend="tpu"))
    assert got.effective_config.inference_backend == "tpu"
    assert want.effective_config.inference_backend == "cpu"


def test_build_state_serves_the_probed_config(no_cloud_request,
                                              monkeypatch):
    calls = []

    def probe(cfg):
        calls.append(cfg)
        return platform.initialize_platform(cfg)

    monkeypatch.setattr(server_app, "initialize_platform", probe)
    kw = dict(audio_sec_buckets=[2.0], batch_buckets=[1],
              checkpoint_path=str(testing.TINY_DIGITS_NPZ),
              vocabulary_path=str(testing.TINY_DIGITS_VOCAB),
              inference_backend="cpu")
    state = server_app.build_state(Config(**kw), preset="tiny", warmup=False)
    state.close()
    assert len(calls) == 1 and state.config.mesh_shape == {}
    state = server_app.build_state(
        Config(enable_platform_optimizations=False, **kw), preset="tiny",
        warmup=False)
    state.close()
    assert len(calls) == 1


def test_cloud_probe_env_checks(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    assert dataclasses.asdict(platform.detect_cloud()) == \
        dataclasses.asdict(jax_platform.detect_cloud()) == \
        dataclasses.asdict(platform.CloudInfo(provider="gcp", tpu_env=True))
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES")
    monkeypatch.delenv("TPU_SKIP_MDS_QUERY", raising=False)
    # the one metadata attempt, failed as it fails with no network
    asked = []

    def no_network(req, timeout):
        asked.append((req.full_url, timeout))
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    assert dataclasses.asdict(platform.detect_cloud()) == \
        dataclasses.asdict(jax_platform.detect_cloud()) == \
        dataclasses.asdict(platform.CloudInfo(provider="unknown"))
    assert len(asked) == 2 and asked[0] == asked[1]
    assert asked[0][1] == 0.3
