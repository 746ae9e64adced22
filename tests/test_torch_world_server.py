"""PyTorch port: the server over a world of ranks (``parallel/serve.py``,
``server/app.build_state`` and ``main`` under a world), on the CPU over
gloo: the port's means to the reference's serving over a mesh
(``server/app.py:509-513``).

One world of 2 ranks (``tests/_torch_world_ranks.py``, separate OS
processes with torchrun's environment, a deadline) runs a sequence of
servers on the mesh ``{"data": 1, "model": 2}``: rank 0 serves HTTP on a
free local port and drives it, rank 1 follows. The greedy and beam batch
answers on the committed tiny-digits weights, the native WebSocket stream
on a causal ``tiny`` (the reference's ``PRNGKey(0)`` weights, the blank
biased up, as ``parallel/dryrun.py`` makes it), the answer after a
``/v2/repository/.../load`` and one CTC answer are held against the port
served without a world on the same inputs, token for token, and the
greedy text against the JAX pipeline's. Every follower's log of mirrored
entries equals rank 0's and its ``follow`` returns 0 at shutdown; a
follower made to raise turns rank 0's request into a 503 with status
``ERROR`` within the group's deadline; a mesh that does not cover the
world is refused on every rank with both numbers. The real entry point
runs under torchrun's environment too, and the platform's default mesh
follows the world, not the local device count.

Tolerances: none; tokens and text identical (f32 on both sides; the
tensor-parallel encoder adds its partial sums in another order, which the
greedy argmax absorbs here, as ``tests/test_torch_parallel.py`` shows).
"""

import base64
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import load_npz, save_npz
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import (TINY,
                                                           TINY_STREAMING)
from amira_rust_asr_server_tpu_torch.models.reference_init import \
    init_reference_weights
from amira_rust_asr_server_tpu_torch.parallel import launch
from amira_rust_asr_server_tpu_torch.server import app as server_app
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_FAMILY_NPZ,
                                                     TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     pcm16_digits)
from amira_rust_asr_server_tpu_torch.utils import platform

import _torch_world_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "model-repo", "tiny-digits")
WORLD_S = 180.0  # the world's deadline: every rank is killed past it
GROUP_S = 60.0   # the world's group timeout
MESH = {"data": 1, "model": 2}
NATIVE = dict(streaming_mode="native", native_chunk_frames=16,
              native_norm="none", max_lanes=2,
              audio_sec_buckets=[0.5, 2.0])


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_env(rank: int, size: int, master_port: int, **extra) -> dict:
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(size),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master_port),
                PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def wait_all(procs, deadline_s: float) -> list:
    """Every process's exit code; past the deadline all are killed and the
    test fails."""
    end = time.monotonic() + deadline_s
    try:
        return [p.wait(max(0.1, end - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish within {deadline_s:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5.0)


def noise_pcm() -> bytes:
    """The dryrun's stream audio (``default_rng(17)``, 0.5 s at 0.3) as
    16-bit PCM."""
    x = np.random.default_rng(17).standard_normal(8000) * 0.3
    return (x * 32767).clip(-32768, 32767).astype("<i2").tobytes()


def base_config(tmp, **overrides) -> dict:
    return {**dict(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                   checkpoint_path=str(TINY_DIGITS_NPZ),
                   vocabulary_path=str(TINY_DIGITS_VOCAB),
                   inference_backend="cpu", compute_dtype="float32",
                   model_repo_path=str(tmp / "repo"), mesh_shape=MESH),
            **overrides}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The files the world reads: the audio, a reload checkpoint (the
    reference's ``PRNGKey(1)`` weights of ``tiny``) and the causal tiny."""
    tmp = tmp_path_factory.mktemp("world")
    (tmp / "repo").mkdir()
    digits = pcm16_digits(["two", "five", "nine"])
    np.save(tmp / "digits.npy", np.frombuffer(digits, np.uint8))
    np.save(tmp / "noise.npy", np.frombuffer(noise_pcm(), np.uint8))
    save_npz(tmp / "repo" / "alt.npz", init_reference_weights(
        Transducer(TINY), 1).state_dict())
    causal = init_reference_weights(Transducer(TINY_STREAMING), 0)
    with torch.no_grad():
        causal.joint.out.b[TINY_STREAMING.blank_id] += 2.0
    save_npz(tmp / "causal.npz", causal.state_dict())
    return tmp, digits


def scenarios(tmp) -> list:
    causal = dict(checkpoint_path=str(tmp / "causal.npz"), **NATIVE)
    ctc = dict(model_family="ctc",
               checkpoint_path=str(TINY_DIGITS_FAMILY_NPZ["ctc"]))
    return [
        dict(name="mismatch", preset="tiny", steps=[],
             config=base_config(tmp, mesh_shape={"data": 4, "model": 1})),
        dict(name="greedy", preset="tiny",
             steps=["batch", "load", "batch", "health", "metrics"],
             config=base_config(tmp)),
        dict(name="beam", preset="tiny", steps=["batch"],
             config=base_config(tmp, decoding_mode="beam")),
        dict(name="native", preset="tiny-streaming", steps=["stream"],
             config=base_config(tmp, **causal)),
        dict(name="ctc", preset="tiny", steps=["batch"],
             config=base_config(tmp, **ctc)),
        # last: a failed world is not used again
        dict(name="fail", preset="tiny", steps=["batch", "health"],
             warmup=False, fail_follower=True, config=base_config(tmp)),
    ]


@pytest.fixture(scope="module")
def world(inputs):
    """Run the scenarios on a world of 2 ranks: (rank 0's results, rank
    1's results, the ranks' exit codes)."""
    tmp, _ = inputs
    spec = dict(port=free_port(), timeout_s=GROUP_S, out=str(tmp),
                digits_pcm=str(tmp / "digits.npy"),
                noise_pcm=str(tmp / "noise.npy"), reload_name="alt",
                scenarios=scenarios(tmp))
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)
    port = free_port()
    logs = [open(tmp / f"log{r}.txt", "w") for r in range(2)]
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "_torch_world_ranks.py"),
             str(tmp / "spec.json")], env=world_env(r, 2, port), cwd=REPO,
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
        codes = wait_all(procs, WORLD_S)
    finally:
        for log in logs:
            log.close()
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.json") as f:
            got = json.load(f)
        assert "error" not in got, got["error"]
        out.append(got["results"])
    return out[0], out[1], codes


def unsharded_state(cfg: dict, preset: str):
    cfg = dict(cfg)
    cfg.pop("mesh_shape")
    return server_app.build_state(Config(**cfg), preset=preset,
                                  warmup=False)


def batch_tokens(state, pcm: bytes) -> list:
    return state.pipeline.process_batch(pcm).tokens


@pytest.fixture(scope="module")
def unsharded(inputs):
    """The port's answers without a world on the same inputs."""
    tmp, digits = inputs
    want = {}
    for sc in scenarios(tmp)[1:5]:
        state = unsharded_state(sc["config"], sc["preset"])
        try:
            if sc["name"] == "native":
                eng = state.lane_engine
                lane = eng.attach()
                eng.feed(lane, np.frombuffer(noise_pcm(), "<i2").astype(
                    np.float32) / 32768.0)
                eng.feed(lane, np.zeros(0, np.float32), final=True)
                want["native"] = eng.drain(lane)
            else:
                want[sc["name"]] = batch_tokens(state, digits)
            if sc["name"] == "greedy":
                state.pipeline.swap_weights(load_npz(
                    tmp / "repo" / "alt.npz"))
                want["reloaded"] = batch_tokens(state, digits)
        finally:
            state.close()
    return want


def test_world_greedy_equals_unsharded_and_jax(world, unsharded, inputs):
    """The greedy answer of the 2-rank world: the unsharded port's tokens,
    and the JAX pipeline's text on the same weights ("two five nine")."""
    _, digits = inputs
    jm = JaxTransducer.from_preset("tiny")
    ref = JaxPipeline(jm, jm.load_checkpoint(CKPT),
                      JaxVocabulary.load(TINY_DIGITS_VOCAB),
                      JaxConfig(audio_sec_buckets=[2.0], batch_buckets=[1],
                                compute_dtype="float32",
                                inference_backend="cpu"))
    want_text = ref.process_batch(digits).text
    first = world[0]["greedy"]["batch"][0]
    assert first["status"] == 200
    assert first["body"]["status"] == "COMPLETE"
    assert first["body"]["metadata"]["tokens"] == unsharded["greedy"]
    assert first["body"]["transcription"] == want_text == "two five nine"


def test_world_beam_equals_unsharded(world, unsharded):
    got = world[0]["beam"]["batch"][0]
    assert got["status"] == 200 and got["body"]["status"] == "COMPLETE"
    assert got["body"]["metadata"]["tokens"] == unsharded["beam"]
    assert got["body"]["transcription"] == "two five nine"


def test_world_native_stream_final_equals_direct_decode(world, unsharded):
    """One WebSocket stream through the lane engines of both ranks: its
    final equals the unsharded engine driven directly."""
    got = world[0]["native"]["stream"]
    assert got["status"] == "COMPLETE"
    assert unsharded["native"] and got["transcription"] == \
        unsharded["native"]
    entries = world[0]["native"]["entries"]
    assert {"lanes.attach", "lanes.feed", "lanes.tick",
            "lanes.detach"} <= set(entries)


def test_world_reload_serves_the_new_weights(world, unsharded):
    """A load over HTTP reaches every rank (each stages the checkpoint
    from the shared path and copies its own shards): the next answer is
    the unsharded port's on the new weights."""
    greedy = world[0]["greedy"]
    assert greedy["load"]["status"] == 200, greedy["load"]
    assert greedy["load"]["body"]["name"] == "alt"
    after = greedy["batch"][1]
    assert after["status"] == 200
    assert after["body"]["metadata"]["tokens"] == unsharded["reloaded"]
    assert unsharded["reloaded"] != unsharded["greedy"]
    assert "pipeline.swap_weights" in greedy["entries"]


def test_world_ctc_request_succeeds(world, unsharded):
    got = world[0]["ctc"]["batch"][0]
    assert got["status"] == 200 and got["body"]["status"] == "COMPLETE"
    assert got["body"]["metadata"]["tokens"] == unsharded["ctc"]


def test_followers_replay_rank0_entries_and_exit_0(world):
    """Every server's follower ran rank 0's entries in rank 0's order and
    left with 0 when rank 0 closed its state; both processes exited 0."""
    lead, follower, codes = world
    assert codes == [0, 0]
    for name in ("greedy", "beam", "native", "ctc"):
        assert follower[name]["exit_code"] == 0, name
        assert follower[name]["entries"] == lead[name]["entries"], name
        assert lead[name]["entries"][0] == "pipeline.warmup"
    health = lead["greedy"]["health"]
    assert health["status"] == 200
    assert health["body"]["world"] == {"ranks": 2, "status": "ok"}
    per = lead["greedy"]["metrics"]["world"]["per_entry"]
    assert per["pipeline.decode_samples_batch"]["count"] == 2
    assert per["pipeline.swap_weights"]["mirror_ms"] >= 0


def test_failing_follower_gives_error_within_deadline(world):
    """A follower whose entry raises: rank 0's request fails with 503 and
    status ERROR naming the follower's error, well inside the group's
    timeout, and the world reports itself degraded; the follower leaves
    with 1."""
    lead, follower, _ = world
    got = lead["fail"]["batch"][0]
    assert got["status"] == 503
    assert got["body"]["status"] == "ERROR"
    assert got["body"]["error"] == "world_degraded"
    assert "injected fault" in got["body"]["message"]
    assert got["seconds"] < GROUP_S / 2
    health = lead["fail"]["health"]
    assert health["status"] == 503
    assert health["body"]["status"] == "degraded"
    assert health["body"]["world"]["status"] == "degraded"
    assert follower["fail"]["exit_code"] == 1


def test_mesh_mismatch_is_refused_with_both_numbers(world):
    for rank in world[:2]:
        msg = rank["mismatch"]["refused"]
        assert msg.startswith("ConfigValidationError")
        assert "covers 4 devices" in msg and "has 2 ranks" in msg


def test_server_entry_point_under_torchrun_env(inputs):
    """``python -m amira_rust_asr_server_tpu_torch.server`` in 2 processes
    with torchrun's environment and the default config (the mesh from the
    world): rank 0 answers /health and a batch request, and a SIGTERM to
    rank 0 ends both."""
    tmp, digits = inputs
    port, master = free_port(), free_port()
    extra = dict(AMIRA_INFERENCE_BACKEND="cpu",
                 AMIRA_CHECKPOINT_PATH=str(TINY_DIGITS_NPZ),
                 AMIRA_VOCABULARY_PATH=str(TINY_DIGITS_VOCAB),
                 AMIRA_AUDIO_SEC_BUCKETS="2.0", AMIRA_BATCH_BUCKETS="1",
                 AMIRA_COMPUTE_DTYPE="float32",
                 # the cloud probe answers from the environment alone
                 TPU_SKIP_MDS_QUERY="1")
    logs = [open(tmp / f"main{r}.txt", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "amira_rust_asr_server_tpu_torch.server",
         "--port", str(port), "--preset", "tiny"],
        env=world_env(r, 2, master, **extra), cwd=tmp, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        url = f"http://127.0.0.1:{port}"
        end = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    health = json.load(r)
                break
            except OSError:
                if time.monotonic() > end or any(
                        p.poll() is not None for p in procs):
                    pytest.fail("the server did not come up: "
                                + (tmp / "main0.txt").read_text()[-2000:])
                time.sleep(0.3)
        body = json.dumps({"audio_buffer": base64.b64encode(
            digits).decode()}).encode()
        req = urllib.request.Request(
            url + "/v2/decode/batch/default", data=body,
            headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.load(r)
        procs[0].send_signal(signal.SIGTERM)
        codes = wait_all(procs, 60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    assert health["status"] == "healthy"
    assert answer["status"] == "COMPLETE"
    assert answer["transcription"] == "two five nine"
    assert codes == [0, 0], (tmp / "main1.txt").read_text()[-2000:]


# -- one process: the mirror's bookkeeping --------------------------------

def test_one_rank_mirror_sends_outermost_entries_only():
    """Nested entries run plain inside the outermost one, which alone is
    sent; an error every rank raises is re-raised as it is; after close
    every entry fails with 503 status ERROR."""
    out, entries, stats = launch.spawn_world(ranks.one_rank_mirror, 1,
                                             timeout_s=60.0)[0]
    assert out[:3] == [3, [2.0, 2.0, 2.0], "negative"]
    assert out[3]["status"] == "ERROR" and "closed" in out[3]["message"]
    assert entries == ["pipeline.outer", "pipeline.echo", "pipeline.outer"]
    assert stats["per_entry"]["pipeline.outer"]["count"] == 2
    assert stats["status"] == "ok" and stats["ranks"] == 1


def test_idle_world_beats_inside_the_timeout():
    """Rank 0 idles twice as long as the control group's timeout between
    two entries; its heartbeat keeps the follower waiting, which then runs
    both entries (the nested one inside the first) and stops with 0."""
    lead, (code, entries) = launch.spawn_world(ranks.idle_world_rank, 2,
                                               timeout_s=60.0, args=(4.0,))
    assert code == 0
    assert entries == lead == ["pipeline.outer", "pipeline.echo"]


# -- the platform default on a machine of many cards -----------------------

def test_default_config_starts_on_eight_gpus(monkeypatch):
    """With 8 CUDA devices visible and no world, the default mesh stays
    empty (one process takes one card) where the reference's rule, read on
    the local device count, asked for 8 devices and the server refused to
    start; under a world of 8 it spans the ranks."""
    eight = dataclasses.replace(platform.detect_devices(), platform="cuda",
                                n_devices=8)
    monkeypatch.setattr(platform, "detect_devices", lambda: eight)
    cfg = Config(inference_backend="cpu", checkpoint_path=str(
        TINY_DIGITS_NPZ), vocabulary_path=str(TINY_DIGITS_VOCAB),
        audio_sec_buckets=[2.0], batch_buckets=[1])
    assert cfg.enable_platform_optimizations
    state = server_app.build_state(cfg, preset="tiny", warmup=False)
    try:
        assert int(np.prod(list(state.config.mesh_shape.values())
                           or [1])) == 1
        assert state.world is None and state.mirror is None
        assert state.pipeline.process_batch(
            pcm16_digits(["two", "five", "nine"])).text == "two five nine"
    finally:
        state.close()
    world8 = dataclasses.replace(eight, n_processes=8, process_index=3)
    monkeypatch.setattr(platform, "detect_devices", lambda: world8)
    assert platform.initialize_platform(cfg).effective_config.mesh_shape \
        == {"data": 8, "model": 1}


def test_world_of_reads_torchrun_env(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert platform.world_of() == (4, 2)
    assert platform.detect_devices().n_processes == 4
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    assert platform.world_of() == (1, 0)
