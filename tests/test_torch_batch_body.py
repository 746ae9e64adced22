"""PyTorch port: the batch route's native body decoder (``csrc/body.cc``,
``server/body.py``) against the Python path of ``server/app.py``, on the
CPU (g++ only).

Every case runs ``decode_batch_body`` twice, with the native decoder and
without it (the Python path as it was before the decoder): the native path
either takes the body and gives the same samples (``np.array_equal``), the
same other fields and the same ``opaque``, or declines it, and then the
Python path answers, with the same 400 message. The endpoint tests send
the same audio as base64 and as a u8 array on the tiny preset, count both
paths at ``/metrics``, and send every refused body to a server with the
decoder and to one without it.
"""

import asyncio
import base64
import concurrent.futures
import ctypes
import json
import sys
import time
import types

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amira_rust_asr_server_tpu_torch import constants as C
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.errors import RequestValidationError
from amira_rust_asr_server_tpu_torch.reliability import tracing
from amira_rust_asr_server_tpu_torch.runtime.batcher import BatcherStats
from amira_rust_asr_server_tpu_torch.server import (AppState, body,
                                                    build_state, create_app)
from amira_rust_asr_server_tpu_torch.server.app import decode_batch_body
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     pcm16_digits)
from amira_rust_asr_server_tpu_torch.utils import platform

torch.set_num_threads(2)
MAX_SECS = C.MAX_BATCH_AUDIO_LENGTH_SECS


@pytest.fixture(scope="module")
def lib():
    return body.library()


def _state(lib, max_secs=MAX_SECS, workers=2):
    return types.SimpleNamespace(
        config=types.SimpleNamespace(max_batch_audio_length_secs=max_secs),
        body_lib=lib, prometheus=None,
        body_pool=concurrent.futures.ThreadPoolExecutor(workers),
        batcher=types.SimpleNamespace(stats=BatcherStats()))


def _outcome(state, raw):
    """("ok", body, samples, opaque, path) or ("error", answer, path)."""
    stats = state.batcher.stats
    before = stats.body_native_total
    try:
        got = asyncio.run(decode_batch_body(state, raw))
    except RequestValidationError as e:
        path = "native" if stats.body_native_total > before else "python"
        return ("error", (e.http_status, e.to_json()), path)
    path = "native" if stats.body_native_total > before else "python"
    return ("ok", *got, path)


def _compare(lib, raw, max_secs=MAX_SECS):
    """The native and the Python outcomes of ``raw`` agree; returns the
    path the native side took and the Python outcome."""
    fast, slow = _state(lib, max_secs), _state(None, max_secs)
    try:
        a, b = _outcome(fast, raw), _outcome(slow, raw)
    finally:
        fast.body_pool.shutdown()
        slow.body_pool.shutdown()
    assert a[0] == b[0], (a, b)
    if a[0] == "error":
        assert a[1] == b[1]
        return a[-1], b
    _, body_a, samples_a, opaque_a, path = a
    _, body_b, samples_b, opaque_b, _ = b
    assert samples_a.dtype == np.float32 and samples_a.ndim == 1
    assert np.array_equal(samples_a, samples_b)
    assert opaque_a == opaque_b
    if path == "native":
        assert body_a["audio_buffer"] == ""
        body_a = {**body_a, "audio_buffer": body_b["audio_buffer"]}
    assert body_a == body_b
    return path, b


def _pcm(n_bytes: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n_bytes, dtype=np.uint8).tobytes()


def _b64(pcm: bytes) -> str:
    return base64.b64encode(pcm).decode()


def _raw(**kw) -> bytes:
    return json.dumps(kw).encode()


A = _b64(_pcm(6000))  # 3,000 samples, no padding
B = _b64(_pcm(5000, seed=1))  # 2,500 samples, '=='


@pytest.mark.parametrize("seed", range(6))
def test_seeded_bodies_decode_bit_identically(lib, seed):
    rng = np.random.default_rng(seed)
    secs = rng.uniform(2.0, 30.0)
    n = 2 * int(secs * C.SAMPLE_RATE)
    pcm = rng.integers(-32768, 32768, n // 2, dtype=np.int16).astype(
        "<i2").tobytes()
    raw = _raw(audio_buffer=_b64(pcm), opaque={"id": seed})
    path, slow = _compare(lib, raw)
    assert path == "native"
    assert slow[2].shape == (n // 2,)


# (body, path the native side takes, the Python path's answer or None)
CASES = {
    # padding: 2 bytes (one '='), 4 bytes ('=='), and longer with each
    "pad1": (_raw(audio_buffer=_b64(b"\x01\x02")), "native", None),
    "pad2": (_raw(audio_buffer=_b64(b"\x01\x02\x03\x04")), "native", None),
    "pad1_long": (_raw(audio_buffer=_b64(_pcm(5002))), "native", None),
    "pad2_long": (_raw(audio_buffer=B), "native", None),
    "tail_7_chars": (_raw(audio_buffer=_b64(_pcm(8))), "native", None),
    # non-zero bits in the last quantum are dropped, as binascii drops them
    "trailing_bits_pad2": (_raw(audio_buffer="AQIDBB=="), "native", None),
    "trailing_bits_pad1": (_raw(audio_buffer="AQJ="), "native", None),
    "trailing_bits_pad1_long": (_raw(audio_buffer="AQIDBAUGBwh="), "native",
                                None),
    "not_alphabet": (_raw(audio_buffer=A[:8] + "!" + A[9:]), "python",
                     "audio_buffer string must be base64"),
    "space": (_raw(audio_buffer=A[:8] + " " + A[9:]), "python",
              "audio_buffer string must be base64"),
    "escaped_newline": (_raw(audio_buffer=A[:8] + "\n" + A[8:]), "python",
                        "audio_buffer string must be base64"),
    "raw_newline": (b'{"audio_buffer": "' + A[:8].encode() + b"\n"
                    + A[8:].encode() + b'"}', "python",
                    "invalid JSON body"),
    "escaped_slash": (b'{"audio_buffer": "' + A.replace("/", "\\/").encode()
                      + b'"}', "python", None),
    "unicode_escape": (b'{"audio_buffer": "\\u0041' + A[1:].encode() + b'"}',
                       "python", None),
    "not_ascii": (_raw(audio_buffer=A[:8] + "é" + A[9:]), "python",
                  "audio_buffer string must be base64"),
    "not_ascii_raw": (json.dumps({"audio_buffer": A[:8] + "é" + A[9:]},
                                 ensure_ascii=False).encode(), "python",
                      "audio_buffer string must be base64"),
    "length_not_4k": (_raw(audio_buffer=A[:-1]), "python",
                      "audio_buffer string must be base64"),
    "length_not_4k_plus": (_raw(audio_buffer=A + "A"), "python",
                           "audio_buffer string must be base64"),
    "pad_in_middle": (_raw(audio_buffer="AQ==" + A), "python",
                      "audio_buffer string must be base64"),
    "three_pads": (_raw(audio_buffer="AQIDA==="), "python",
                   "audio_buffer string must be base64"),
    "three_pads_even": (_raw(audio_buffer="AQIDBAUGB==="), "python",
                        "audio_buffer string must be base64"),
    "odd_bytes": (_raw(audio_buffer=_b64(_pcm(6001))), "python",
                  "Audio buffer length must be even for 16-bit PCM"),
    "empty": (_raw(audio_buffer=""), "python",
              "Audio buffer cannot be empty"),
    "duplicate_key": (b'{"audio_buffer": "' + A.encode()
                      + b'", "audio_buffer": "' + B.encode() + b'"}',
                      "python", None),
    "duplicate_key_last_empty": (b'{"audio_buffer": "' + A.encode()
                                 + b'", "audio_buffer": ""}', "python",
                                 "Audio buffer cannot be empty"),
    "nested_only": (_raw(x={"audio_buffer": A}), "python",
                    "audio_buffer is required"),
    "nested_and_top": (_raw(x={"audio_buffer": B}, audio_buffer=A),
                       "native", None),
    "key_as_value": (_raw(k="audio_buffer", audio_buffer=A), "native", None),
    "in_list": (_raw(x=["audio_buffer", {"audio_buffer": B}],
                     audio_buffer=A), "native", None),
    "escaped_quotes_before": (_raw(opaque='a"audio_buffer": "',
                                   audio_buffer=A), "native", None),
    "backslash_run_before": (_raw(opaque="x\\\\", audio_buffer=A), "native",
                             None),
    "escape_in_key": (b'{"audio\\u005fbuffer": "' + A.encode() + b'"}',
                      "python", None),
    "escape_in_other_key": (b'{"op\\u0061que": 1, "audio_buffer": "'
                            + A.encode() + b'"}', "python", None),
    "u8_array": (_raw(audio_buffer=list(_pcm(600))), "python", None),
    "u8_array_out_of_range": (_raw(audio_buffer=[1, 300]), "python",
                              "audio_buffer must contain bytes 0-255"),
    "number_value": (_raw(audio_buffer=5), "python",
                     "audio_buffer must be array or base64"),
    "top_level_array": (json.dumps([{"audio_buffer": A}]).encode(), "python",
                        "request body must be an object"),
    "top_level_string": (json.dumps(A).encode(), "python",
                         "request body must be an object"),
    "unterminated": (b'{"audio_buffer": "' + A.encode() + b'"', "python",
                     "invalid JSON body"),
    "unterminated_string": (b'{"audio_buffer": "' + A.encode(), "python",
                            "invalid JSON body"),
    "trailing_comma": (b'{"audio_buffer": "' + A.encode() + b'",}',
                       "native", "invalid JSON body"),
    "trailing_data": (b'{"audio_buffer": "' + A.encode() + b'"} x', "native",
                      "invalid JSON body"),
    "not_utf8_elsewhere": (b'{"opaque": "\xff", "audio_buffer": "'
                           + A.encode() + b'"}', "native",
                           "invalid JSON body"),
    "whitespace": (b' \r\n\t{ "audio_buffer" :\n "' + A.encode()
                   + b'" , "opaque" : [1, {"a": "}"}] }\n ', "native", None),
    "bom": (b"\xef\xbb\xbf" + _raw(audio_buffer=A), "python", None),
    "utf16": (_raw(audio_buffer=A).decode().encode("utf-16-le"), "python",
              None),
    "nul_second_byte": (b'{\x00"audio_buffer": "' + A.encode() + b'"}',
                        "python", "invalid JSON body"),
    "empty_body": (b"", "python", "invalid JSON body"),
    "opaque_over_10kb": (_raw(audio_buffer=A, opaque={"x": "y" * 10_001}),
                         "native", "Opaque data too large (max: 10KB)"),
    "opaque_over_10kb_u8": (_raw(audio_buffer=list(_pcm(600)),
                                 opaque="y" * 10_001), "python",
                            "Opaque data too large (max: 10KB)"),
    "opaque_over_10kb_lattice": (_raw(audio_buffer=A, lattice=True, n_best=2,
                                      opaque="y" * 10_001), "native",
                                 "Opaque data too large (max: 10KB)"),
    "lattice": (_raw(audio_buffer=A, lattice=True), "native", None),
    "lattice_n_best": (_raw(lattice=True, n_best=3, audio_buffer=A,
                            opaque=[1, 2]), "native", None),
    "n_best_only": (_raw(audio_buffer=A, n_best="x"), "native", None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_path_matches_or_declines(lib, name):
    raw, want_path, want_error = CASES[name]
    path, slow = _compare(lib, raw)
    assert path == want_path
    if want_error is None:
        assert slow[0] == "ok"
    else:
        assert slow[0] == "error"
        assert slow[1] == (400, {"error": "request_validation",
                                 "message": want_error})


@pytest.mark.parametrize("over", [False, True])
def test_byte_limit(lib, monkeypatch, over):
    """MAX_AUDIO_BYTES, read by both paths at call time: at the limit the
    native path decodes, one sample past it declines and Python refuses."""
    monkeypatch.setattr(C, "MAX_AUDIO_BYTES", 6000)
    raw = _raw(audio_buffer=_b64(_pcm(6002 if over else 6000)))
    path, slow = _compare(lib, raw, max_secs=1e6)
    if over:
        assert (path, slow[1][1]["message"]) == (
            "python", "Audio buffer too large: 6002 bytes (max: 6000 bytes)")
    else:
        assert (path, slow[0]) == ("native", "ok")


@pytest.mark.parametrize("n_samples,max_secs,want", [
    (16000, 1.0, "native"), (16002, 1.0, "python"),
    (8000, 0.5, "native"), (8001, 0.5, "python"), (0, 0.5, "python"),
    (16000, float("inf"), "native")])
def test_length_limit(lib, n_samples, max_secs, want):
    raw = _raw(audio_buffer=_b64(_pcm(2 * n_samples)))
    path, slow = _compare(lib, raw, max_secs=max_secs)
    assert path == want
    if want == "python":
        assert slow[0] == "error"


MUTATIONS = b'"\\{}[],:= \nA/u0!'


@pytest.mark.parametrize("seed", range(8))
def test_mutated_bodies_never_differ(lib, seed):
    """Bodies with random bytes inserted, replaced or deleted (JSON's
    structural bytes, escapes, padding): the native path gives the Python
    path's samples and fields, or declines."""
    rng = np.random.default_rng(seed)
    bases = [_raw(audio_buffer=_b64(_pcm(24, seed)), opaque={"a": [1, "b"]}),
             _raw(n_best=2, audio_buffer=_b64(_pcm(22, seed)), lattice=False),
             b'{"x": "\\\\", "audio_buffer": "' + _b64(_pcm(20)).encode()
             + b'"}']
    native = 0
    for _ in range(150):
        raw = bytearray(bases[rng.integers(len(bases))])
        for _ in range(rng.integers(1, 4)):
            at = int(rng.integers(len(raw)))
            op = rng.integers(3)
            byte = MUTATIONS[rng.integers(len(MUTATIONS))]
            if op == 0:
                raw.insert(at, byte)
            elif op == 1:
                raw[at] = byte
            elif len(raw) > 1:
                del raw[at]
        path, _ = _compare(lib, bytes(raw))
        native += path == "native"
    assert native > 0


def test_concurrent_bodies_on_the_pool(lib):
    """64 bodies at once on two workers with a short switch interval: each
    request gets its own samples and every body is counted once."""
    state = _state(lib)
    bodies = [_pcm(2 * (1000 + 37 * i), seed=i) for i in range(64)]

    async def go():
        return await asyncio.gather(*(
            decode_batch_body(state, _raw(audio_buffer=_b64(pcm)))
            for pcm in bodies))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = asyncio.run(asyncio.wait_for(go(), 60))
    finally:
        sys.setswitchinterval(old)
        state.body_pool.shutdown()
    for pcm, (_, samples, _) in zip(bodies, got):
        want = np.frombuffer(pcm, "<i2").astype(np.float32) * np.float32(
            1 / 32768)
        assert np.array_equal(samples, want)
    stats = state.batcher.stats.to_json()
    assert (stats["body_native_total"], stats["body_fallback_total"]) == (
        64, 0)


# -- the endpoint, tiny preset ------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    """build_state probes the platform: its cloud probe answers without the
    metadata request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


@pytest.fixture(scope="module")
def pipeline():
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2, 4],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="cpu")
    state = build_state(cfg, preset="tiny", warmup=False)
    yield state.pipeline
    state.close()


@pytest.fixture
def state(pipeline):
    st = AppState(pipeline, pipeline.vocab)
    yield st
    st.close()


async def _post_all(state, bodies) -> list:
    async with TestClient(TestServer(create_app(state))) as client:
        out = []
        for raw in bodies:
            resp = await client.post("/v2/decode/batch/default", data=raw)
            out.append((resp.status, await resp.json()))
        metrics = await (await client.get("/metrics")).json()
        return out, metrics["batcher"]


def test_base64_and_u8_bodies_give_the_same_answer(state):
    assert type(state.body_lib) is ctypes.CDLL  # not PyDLL: no GIL held
    pcm = pcm16_digits(["seven", "one", "zero", "four"])
    t = time.monotonic()
    answers, counters = asyncio.run(_post_all(state, [
        _raw(audio_buffer=_b64(pcm), opaque={"id": 7}),
        _raw(audio_buffer=list(pcm), opaque={"id": 7})]))
    # each body's native call is a span inside its awaited decode, on a
    # pool thread
    spans = [s for s in tracing.snapshot().spans if s[4] >= t]
    for dec in (s for s in spans if s[0] == "http.decode"):
        native = [s for s in spans if s[2] == dec[1]]
        assert [s[0] for s in native] == ["http.decode.native"]
        assert dec[4] <= native[0][4] <= native[0][5] <= dec[5]
    (s64, a64), (su8, au8) = answers
    assert s64 == su8 == 200
    assert a64 == au8
    assert a64["transcription"] == "seven one zero four"
    assert a64["metadata"]["audio_length_samples"] == len(pcm) // 2
    assert (counters["body_native_total"],
            counters["body_fallback_total"]) == (1, 1)


def test_refused_bodies_answer_as_without_the_decoder(state, pipeline):
    refused = [raw for raw, _, err in CASES.values() if err is not None]
    with_decoder, counters = asyncio.run(_post_all(state, refused))
    plain = AppState(pipeline, pipeline.vocab)
    plain.body_lib = None
    try:
        without, plain_counters = asyncio.run(_post_all(plain, refused))
    finally:
        plain.close()
    assert with_decoder == without
    assert all(status == 400 for status, _ in without)
    assert plain_counters["body_native_total"] == 0
    assert counters["body_native_total"] == sum(
        path == "native" for _, path, err in CASES.values()
        if err is not None)


def test_without_a_compiler_bodies_decode_in_python(pipeline, monkeypatch):
    """No g++ (a slim runtime image): the state is built all the same and
    every body takes the Python path."""
    def no_compiler():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(body, "library", no_compiler)
    st = AppState(pipeline, pipeline.vocab)
    try:
        assert st.body_lib is None
        pcm = pcm16_digits(["two", "five", "nine"])
        answers, counters = asyncio.run(_post_all(
            st, [_raw(audio_buffer=_b64(pcm))]))
    finally:
        st.close()
    assert answers[0][0] == 200
    assert answers[0][1]["transcription"] == "two five nine"
    assert (counters["body_native_total"],
            counters["body_fallback_total"]) == (0, 1)
