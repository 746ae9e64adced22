"""PyTorch port: live checkpoint reload (``runtime/reload.py``,
``convert.stage_checkpoint``, ``AsrPipeline.swap_weights`` and the
``/v2/repository/*`` routes), on the CPU.

The first ten tests mirror ``tests/test_reload.py`` on the port: the index
lists pointers (and converted trees), a load swaps serving weights with no
restart and no program rebuilt, failures leave the old weights serving,
and native lanes pin the weights. The port reads converted ``.npz`` state
dicts, so its repositories hold ``.npz`` files where the reference's hold
orbax trees, and an unconverted orbax tree is ``UNAVAILABLE``.

Then what the port adds: the captured programs read the weights and their
derived tables at fixed addresses, so after a swap every such tensor must
keep its ``data_ptr()`` and equal the same table of a pipeline built afresh
on the new weights, and every program (greedy buckets on the loop and step
routes, int8, beam, the CTC and AED buckets, the lane engine's tick, the
solo and streaming-beam chunk programs) must give that fresh pipeline's
tokens, identical in f32. And parity: on JAX weights of two seeds, the
port's ``hot_swap`` gives the tokens the JAX ``hot_swap`` gives (f32).

Weights: seeded inits with every 1-D parameter (biases, norms) perturbed
per seed, so the fresh (SOS) carries depend on the weights (a zero-bias
init gives a zero SOS state for any weights).
"""

import asyncio
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.runtime.reload import hot_swap as jax_hot_swap
from amira_rust_asr_server_tpu.server import AppState as JaxAppState
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import (CheckpointMismatchError,
                                                     from_jax_params,
                                                     save_npz,
                                                     stage_checkpoint)
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import get_preset
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
    slice_plan
from amira_rust_asr_server_tpu_torch.runtime.beam_stream import \
    StreamingBeamSession
from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import (
    family_model, serving_pipeline)
from amira_rust_asr_server_tpu_torch.runtime.native_stream import \
    NativeStreamSession
from amira_rust_asr_server_tpu_torch.runtime.reload import (
    ModelRepositoryError, ReloadConflictError, hot_swap, repository_index,
    resolve_checkpoint)
from amira_rust_asr_server_tpu_torch.server.app import create_app
from amira_rust_asr_server_tpu_torch.server.state import AppState
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
WORDS = {i: f"w{i}" for i in range(15)}


def _vocab():
    return Vocabulary.from_map(WORDS)


def seeded_model(seed: int, preset: str = "tiny",
                 family: str = "transducer"):
    model = family_model(family, preset, Config(), seed=seed)
    gen = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _make_repo(tmp_path, seeds=(0, 1), preset="tiny", family="transducer"):
    """A repository with one converted checkpoint and one pointer per seed:
    name ckpt<seed> -> tree<seed>.npz."""
    repo = tmp_path / "repo"
    repo.mkdir(exist_ok=True)
    for s in seeds:
        npz = repo / f"tree{s}.npz"
        save_npz(npz, seeded_model(s, preset, family).state_dict())
        (repo / f"ckpt{s}.json").write_text(json.dumps({
            "preset": preset, "checkpoint": str(npz), "steps": 10 * s,
            "held_out_exact_match": 0.5 + s / 10}))
    # a non-model json must not show up in the index
    (repo / "eval_artifact.json").write_text(json.dumps({"wer": 0.1}))
    return str(repo)


def _config(repo, **overrides):
    kw = dict(audio_sec_buckets=[0.5], batch_buckets=[1, 2],
              max_symbols_per_step=5, max_total_tokens=50,
              model_repo_path=repo, compute_dtype="float32",
              inference_backend="cpu")
    kw.update(overrides)
    return Config(**kw)


def _state(tmp_path, preset="tiny", **cfg_overrides):
    repo = _make_repo(tmp_path, preset=preset,
                      family=cfg_overrides.get("model_family", "transducer"))
    cfg = _config(repo, model_preset=preset, **cfg_overrides)
    pipe = serving_pipeline(seeded_model(0, preset, cfg.model_family),
                            _vocab(), cfg)
    return AppState(pipe, _vocab(), cfg), repo


def _fingerprint(model):
    return float(sum(float(p.detach().abs().sum()) for p in
                     model.state_dict().values()))


def wave(seed: int, n: int = 8000, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


def _write_fake_orbax_tree(path):
    path.mkdir()
    (path / "_CHECKPOINT_METADATA").write_text("{}")


# ---------------------------------------------------------------------------
def test_repository_index_lists_pointers(tmp_path):
    state, repo = _state(tmp_path)
    try:
        rows = repository_index(repo, None)
        assert [r["name"] for r in rows] == ["ckpt0", "ckpt1"]
        assert all(r["state"] == "AVAILABLE" for r in rows)
        assert rows[1]["held_out_exact_match"] == 0.6
        assert rows[1]["checkpoint"].endswith("tree1.npz")
        rows = repository_index(repo, {"name": "ckpt1"})
        assert [r["state"] for r in rows] == ["AVAILABLE", "READY"]
    finally:
        state.close()


def test_repository_index_lists_bare_trees_and_npz(tmp_path):
    """A bare orbax tree with no pointer is listed, UNAVAILABLE until its
    converted sibling <tree>.npz exists (a load would refuse it); a bare
    .npz is listed AVAILABLE; pointed-at files are not listed twice."""
    state, repo = _state(tmp_path)
    try:
        _write_fake_orbax_tree(tmp_path / "repo" / "bare-tree")
        (tmp_path / "repo" / "not-a-model").mkdir()  # no orbax markers
        rows = repository_index(repo, None)
        assert [r["name"] for r in rows] == ["ckpt0", "ckpt1", "bare-tree"]
        assert rows[-1]["state"] == "UNAVAILABLE"
        assert rows[-1]["preset"] is None
        save_npz(tmp_path / "repo" / "bare-tree.npz",
                 seeded_model(3).state_dict())
        save_npz(tmp_path / "repo" / "loose.npz",
                 seeded_model(4).state_dict())
        rows = repository_index(repo, {"name": "loose"})
        assert [(r["name"], r["state"]) for r in rows] == [
            ("ckpt0", "AVAILABLE"), ("ckpt1", "AVAILABLE"),
            ("bare-tree", "AVAILABLE"), ("loose", "READY")]
    finally:
        state.close()


def test_resolve_checkpoint_errors(tmp_path):
    state, repo = _state(tmp_path)
    base = tmp_path / "repo"
    try:
        with pytest.raises(ModelRepositoryError):
            resolve_checkpoint(repo, "nope")
        with pytest.raises(ModelRepositoryError):
            resolve_checkpoint(repo, "../escape")
        # a pointer whose checkpoint was wiped
        (base / "gone.json").write_text(json.dumps(
            {"preset": "tiny", "checkpoint": str(base / "absent")}))
        with pytest.raises(ModelRepositoryError, match="not on disk"):
            resolve_checkpoint(repo, "gone")
        # an unconverted orbax tree, by pointer and bare: the 404 names the
        # converter
        _write_fake_orbax_tree(base / "tree9")
        (base / "orbax.json").write_text(json.dumps(
            {"preset": "tiny", "checkpoint": str(base / "tree9")}))
        for name in ("orbax", "tree9"):
            with pytest.raises(ModelRepositoryError,
                               match="export_torch_params"):
                resolve_checkpoint(repo, name)
        # converted: <tree>.npz beside the tree, by pointer and bare
        save_npz(base / "tree9.npz", seeded_model(9).state_dict())
        assert resolve_checkpoint(repo, "orbax") == str(base / "tree9.npz")
        assert resolve_checkpoint(repo, "tree9") == str(base / "tree9.npz")
        assert resolve_checkpoint(repo, "tree0").endswith("tree0.npz")
        assert resolve_checkpoint(repo, "ckpt1").endswith("tree1.npz")
    finally:
        state.close()


def test_hot_swap_changes_serving_weights(tmp_path):
    state, repo = _state(tmp_path)
    pipe = state.pipeline
    try:
        before = pipe.process_batch_samples(wave(3))
        old_fp = _fingerprint(pipe.model)
        programs = dict(pipe.programs)
        info = hot_swap(state, "ckpt1")
        assert info["name"] == "ckpt1" and info["swap_ms"] > 0
        assert state.loaded_model["name"] == "ckpt1"
        assert _fingerprint(pipe.model) != old_fp
        # the same bucket programs serve the new weights: none rebuilt
        after = pipe.process_batch_samples(wave(3))
        assert pipe.programs == programs
        assert after.tokens != before.tokens
        # swapping back to seed 0 reproduces the original decode
        hot_swap(state, "ckpt0")
        again = pipe.process_batch_samples(wave(3))
        assert again.text == before.text and again.tokens == before.tokens
        assert state.metrics.model_reloads == 2
        phases = state.metrics.to_json()["last_reload_ms"]
        assert set(phases) == {"prepare", "swap", "canary"}
        assert phases["canary"] == pytest.approx(0.0, abs=1.0)
    finally:
        state.close()


def test_hot_swap_refreshes_fresh_pred_cache(tmp_path):
    state, repo = _state(tmp_path)
    pipe = state.pipeline
    try:
        out0, (h0, _) = pipe._fresh_carry()
        ptrs = [out0.data_ptr(), h0.data_ptr()]
        hot_swap(state, "ckpt1")
        out1, (h1, _) = pipe._fresh_carry()
        assert [out1.data_ptr(), h1.data_ptr()] == ptrs  # refreshed in place
        fresh = serving_pipeline(seeded_model(1), _vocab(), state.config)
        want_out, (want_h, _) = fresh._fresh_carry()
        assert torch.equal(out1, want_out) and torch.equal(h1, want_h)
        assert not torch.equal(want_out, serving_pipeline(
            seeded_model(0), _vocab(), state.config)._fresh_carry()[0])
    finally:
        state.close()


def test_hot_swap_mismatched_checkpoint_rejected(tmp_path):
    """A checkpoint of another preset, of another family by its pointer,
    or no .npz at all: 422 with the serving weights untouched."""
    state, repo = _state(tmp_path)
    base = tmp_path / "repo"
    try:
        save_npz(base / "base.npz",
                 family_model("transducer", "base", Config()).state_dict())
        (base / "ctc.json").write_text(json.dumps(
            {"preset": "tiny", "family": "ctc",
             "checkpoint": str(base / "tree1.npz")}))
        (base / "junk.npz").write_bytes(b"not a zip")
        old_fp = _fingerprint(state.pipeline.model)
        for name, match in (("base", "does not fit"), ("ctc", "ctc"),
                            ("junk", "readable")):
            with pytest.raises(CheckpointMismatchError, match=match) as e:
                hot_swap(state, name)
            assert e.value.http_status == 422
            assert _fingerprint(state.pipeline.model) == old_fp
            assert state.loaded_model is None
        assert state.metrics.model_reloads == 0
    finally:
        state.close()


def test_stage_checkpoint_casts_to_the_serving_type(tmp_path):
    """The staged tensors take each parameter's type and device (bf16
    serving: bf16), every key; the serving model is not touched."""
    repo = _make_repo(tmp_path, seeds=(0,))
    pipe = serving_pipeline(seeded_model(1), _vocab(),
                            _config(repo, compute_dtype="bfloat16"))
    fp = _fingerprint(pipe.model)
    staged = stage_checkpoint(pipe.model, os.path.join(repo, "tree0.npz"),
                              pipe.device_lock)
    params = pipe.model.state_dict()
    assert set(staged) == set(params)
    assert all(t.dtype == params[k].dtype == torch.bfloat16
               and t.device == params[k].device
               and t.data_ptr() != params[k].data_ptr()
               for k, t in staged.items())
    assert _fingerprint(pipe.model) == fp


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------
def _run(state, fn):
    async def go():
        async with TestClient(TestServer(create_app(state))) as client:
            return await fn(client)
    try:
        return asyncio.run(go())
    finally:
        state.close()


def test_http_repository_index_and_load(tmp_path):
    state, repo = _state(tmp_path)

    async def go(client):
        resp = await client.get("/v2/repository/index")
        assert resp.status == 200
        body = await resp.json()
        assert [m["name"] for m in body["models"]] == ["ckpt0", "ckpt1"]
        assert body["loaded"] is None and body["model_repository"] == repo
        resp = await client.post("/v2/repository/models/ckpt1/load")
        assert resp.status == 200
        body = await resp.json()
        assert body["status"] == "success" and body["name"] == "ckpt1"
        assert body["swap_ms"] > 0 and body["validated"] is False
        assert set(body) == {"status", "name", "checkpoint", "swap_ms",
                             "ts", "validated"}
        resp = await client.post("/v2/repository/index")
        body = await resp.json()
        states = {m["name"]: m["state"] for m in body["models"]}
        assert states == {"ckpt0": "AVAILABLE", "ckpt1": "READY"}
        assert body["loaded"]["name"] == "ckpt1"
        resp = await client.post("/v2/repository/models/absent/load")
        assert resp.status == 404
        assert (await resp.json())["error"] == "model_not_found"
        resp = await client.post(
            "/v2/repository/models/ckpt0/load?validate=1")
        assert resp.status == 200 and (await resp.json())["validated"]
        # metrics surface records the reloads
        resp = await client.get("/metrics")
        m = await resp.json()
        assert m["model_reloads"] == 2 and m["loaded_model"] == "ckpt0"
        state.shutdown.trigger()
        resp = await client.post("/v2/repository/models/ckpt1/load")
        assert resp.status == 503

    _run(state, go)


def test_reload_refused_while_lanes_live(tmp_path):
    """Native streaming: a live lane pins the weights (409); once it is
    detached the reload goes through, and the engine's lanes decode as an
    engine on a pipeline built afresh on the new weights."""
    state, repo = _state(tmp_path, preset="tiny-streaming",
                         streaming_mode="native", max_lanes=2,
                         native_chunk_frames=16, native_norm="none")
    try:
        eng = state.lane_engine
        assert eng is not None
        lane = eng.attach()
        with pytest.raises(ReloadConflictError) as e:
            hot_swap(state, "ckpt1")
        assert e.value.http_status == 409
        eng.detach(lane)
        assert hot_swap(state, "ckpt1")["name"] == "ckpt1"
        fresh = AppState(serving_pipeline(
            seeded_model(1, "tiny-streaming"), _vocab(), state.config),
            _vocab(), state.config)
        try:
            w = wave(5, 16000)
            assert _engine_tokens(state, w) == _engine_tokens(fresh, w)
        finally:
            fresh.close()
    finally:
        state.close()


def test_hot_swap_validate_and_rollback(tmp_path):
    """?validate runs a canary decode; a failing canary rolls back."""
    state, repo = _state(tmp_path)
    pipe = state.pipeline
    try:
        info = hot_swap(state, "ckpt1", validate=True)
        assert info["validated"] is True
        fp1 = _fingerprint(pipe.model)
        want = pipe.process_batch_samples(wave(7)).tokens
        ptrs = {k: v.data_ptr() for k, v in pipe.model.state_dict().items()}

        orig = pipe.process_batch_samples
        pipe.process_batch_samples = \
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
        with pytest.raises(CheckpointMismatchError, match="rolled back"):
            hot_swap(state, "ckpt0", validate=True)
        pipe.process_batch_samples = orig
        # the weights are ckpt1's again, in the same tensors, and serve
        assert _fingerprint(pipe.model) == fp1
        assert ptrs == {k: v.data_ptr()
                        for k, v in pipe.model.state_dict().items()}
        assert state.loaded_model["name"] == "ckpt1"
        assert pipe.process_batch_samples(wave(7)).tokens == want
    finally:
        state.close()


# ---------------------------------------------------------------------------
# in place: addresses kept, every program on the new weights
# ---------------------------------------------------------------------------
def tables(pipe, engine=None) -> dict:
    """Every tensor that is a weight or derives from one and that a
    captured program of ``pipe`` (or a refresh) reads, by name."""
    out = {f"param {k}": v for k, v in pipe.model.state_dict().items()}
    out.update((f"buffer {k}", v) for k, v in pipe.model.named_buffers())
    for tag, w in (("decode", pipe.decode_weights),
                   ("step", pipe.step_weights)):
        parts = [(tag, w)] + ([(f"{tag} joint", w.__dict__["_joint"])]
                              if w is not None and "_joint" in w.__dict__
                              else [])
        for name, obj in parts:
            if obj is None:
                continue
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if isinstance(v, dict):
                    out.update((f"{name} {f.name} {k}", t)
                               for k, t in v.items())
                elif v is not None:
                    out[f"{name} {f.name}"] = v
            for key, sl in obj.__dict__.get("_block_slices", {}).items():
                out.update((f"{name} slices {key} {k}", t)
                           for k, t in sl.items())
    if pipe._fresh_cache is not None:
        fo, (fh, fc) = pipe._fresh_cache
        out.update({"fresh out": fo, "fresh h": fh, "fresh c": fc})
    for width, carry in pipe._fresh_beams.items():
        out.update((f"fresh beam {width} {i}", t)
                   for i, t in enumerate(carry.tensors()))
    if engine is not None:
        out.update((f"engine fresh {i}", t)
                   for i, t in enumerate(engine._fresh))
    return out


def make_caches(pipe) -> None:
    """What serving makes lazily: the SOS carry, a fresh beam (causal
    presets), and (the
    kernels' grids, made on the card by the first launch) block slices of
    two grids."""
    if isinstance(pipe.model, Transducer):
        pipe._fresh_carry()
        if pipe.model.config.causal:
            pipe.fresh_beam(3)
    with torch.inference_mode():
        for w in (pipe.decode_weights, pipe.step_weights):
            if w is None:
                continue
            d_pred, d_joint = w.wp.shape
            for blocks in (3, 4):
                plan = slice_plan(d_pred, d_joint, w.bo.shape[0], blocks,
                                  tensor_cores=False)
                if hasattr(w, "embed"):
                    w.block_slices(*plan)
                else:
                    w.block_slices(plan[0], *plan[2:])


def _engine_tokens(state, w):
    """``w`` through one lane of the served lane engine, ticked here under
    the lane lock (the server's ticker thread runs beside)."""
    eng = state.lane_engine
    with state.lane_lock:
        lane = eng.attach()
        for i in range(0, w.shape[0], 3200):
            eng.feed(lane, w[i:i + 3200])
            eng.tick()
        eng.feed(lane, np.zeros(0, np.float32), final=True)
        eng.drain(lane)
        eng.detach(lane)
        return list(eng.tokens[lane])


def _outputs(state) -> dict:
    """Tokens of every program ``state`` serves: the greedy bucket at batch
    1 and 2 or the beam bucket (tokens and n-best scores), and on a causal
    preset the lane engine, a solo session and a streaming-beam session."""
    pipe = state.pipeline
    got = {"batch 1": pipe.process_batch_samples(wave(11)).tokens}
    if state.config.decoding_mode == "beam":
        # random weights' best hypothesis may be empty: the n-best's
        # scores and tokens
        got["n-best"] = pipe.decode_beam_batch([wave(11)],
                                               n_best=3)[0].n_best[0]
    else:
        res = pipe.decode_samples_batch([wave(12), wave(13, 6000)])[0]
        got["batch 2"] = [list(res.tokens[i, :res.counts[i]])
                          for i in range(2)]
    if pipe.model.config.causal:
        w = wave(14, 16000)
        got["lane engine"] = _engine_tokens(state, w)
        solo = NativeStreamSession(pipe, chunk_frames=16, norm="none")
        solo.feed(w)
        got["solo"] = solo.end().tokens
        beam = StreamingBeamSession(pipe, chunk_frames=16, norm="none",
                                    beam_width=3)
        beam.feed(w)
        got["beam chunk"] = beam.end().tokens
    return got


SWAP_CASES = {
    "greedy-loop": dict(),
    "greedy-step": dict(use_pallas_decode_loop=False),
    "int8": dict(quantization="int8", int8_decode_weights=True),
    "int8-step": dict(quantization="int8", use_pallas_decode_loop=False),
    "bf16": dict(compute_dtype="bfloat16"),
    "beam": dict(decoding_mode="beam", beam_width=3),
    "ctc": dict(model_family="ctc"),
    "ctc-beam": dict(model_family="ctc", decoding_mode="beam", beam_width=3),
    "aed": dict(model_family="aed", max_total_tokens=20),
    "aed-int8": dict(model_family="aed", quantization="int8",
                     max_total_tokens=20),
    "streaming": dict(preset="tiny-streaming", streaming_mode="native",
                      max_lanes=2, native_chunk_frames=16,
                      native_norm="none"),
    "streaming-step": dict(preset="tiny-streaming", streaming_mode="native",
                           max_lanes=2, native_chunk_frames=16,
                           native_norm="none", use_pallas_decode_loop=False),
}


@pytest.mark.parametrize("case", list(SWAP_CASES))
def test_swap_in_place_equals_a_fresh_pipeline(tmp_path, case):
    overrides = dict(SWAP_CASES[case])
    preset = overrides.pop("preset", "tiny")
    family = overrides.get("model_family", "transducer")
    state, repo = _state(tmp_path, preset=preset, **overrides)
    fresh = None
    try:
        pipe = state.pipeline
        before_out = _outputs(state)
        make_caches(pipe)
        before = {k: v.data_ptr()
                  for k, v in tables(pipe, state.lane_engine).items()}
        programs = {**pipe.programs, **pipe.solo_chunk_programs,
                    **pipe.beam_chunk_programs}
        assert programs

        hot_swap(state, "ckpt1")

        after = tables(pipe, state.lane_engine)
        assert {k: v.data_ptr() for k, v in after.items()} == before
        assert {**pipe.programs, **pipe.solo_chunk_programs,
                **pipe.beam_chunk_programs} == programs
        fresh = AppState(serving_pipeline(seeded_model(1, preset, family),
                                          _vocab(), state.config),
                         _vocab(), state.config)
        got = _outputs(state)
        want = _outputs(fresh)
        make_caches(fresh.pipeline)
        want_tables = tables(fresh.pipeline, fresh.lane_engine)
        assert set(want_tables) == set(after)
        bad = [k for k, v in after.items()
               if not torch.equal(v, want_tables[k])]
        assert not bad, bad
        assert got == want
        assert got != before_out
        assert any(len(t) for t in got.values())
    finally:
        state.close()
        if fresh is not None:
            fresh.close()


# ---------------------------------------------------------------------------
# parity with the JAX package's reload
# ---------------------------------------------------------------------------
def test_port_hot_swap_gives_the_jax_hot_swap_tokens(tmp_path):
    """The JAX package's weights of two seeds, orbax trees for its reload
    and converted .npz files for the port's: after each package's
    hot_swap to seed 1, the same tokens (f32)."""
    jm = JaxTransducer.from_preset("tiny")
    jrepo, prepo = tmp_path / "jax", tmp_path / "port"
    jrepo.mkdir()
    prepo.mkdir()
    params = {}
    for s in (0, 1):
        params[s] = jm.init(jax.random.PRNGKey(s))
        params[s]["joint"]["out"]["b"] = params[s]["joint"]["out"]["b"].at[
            jm.config.blank_id].add(0.5 * s)
        jm.save_checkpoint(str(jrepo / f"tree{s}"), params[s])
        (jrepo / f"ckpt{s}.json").write_text(json.dumps(
            {"preset": "tiny", "checkpoint": str(jrepo / f"tree{s}")}))
        save_npz(prepo / f"tree{s}.npz",
                 from_jax_params(jax.device_get(params[s]), jm.config))
        (prepo / f"ckpt{s}.json").write_text(json.dumps(
            {"preset": "tiny", "checkpoint": str(prepo / f"tree{s}.npz")}))
    kw = dict(audio_sec_buckets=[0.5], batch_buckets=[1],
              max_symbols_per_step=5, max_total_tokens=50,
              compute_dtype="float32")
    jcfg = JaxConfig(model_repo_path=str(jrepo), **kw)
    jvocab = JaxVocabulary.from_map(WORDS)
    jstate = JaxAppState(JaxPipeline(jm, params[0], jvocab, jcfg), jvocab,
                         jcfg)
    model = Transducer(get_preset("tiny"))
    model.load_state_dict(from_jax_params(jax.device_get(params[0]),
                                          model.config))
    cfg = _config(str(prepo), batch_buckets=[1])
    state = AppState(serving_pipeline(model, _vocab(), cfg), _vocab(), cfg)
    try:
        x = wave(21)
        before = state.pipeline.process_batch_samples(x).tokens
        assert before == jstate.pipeline.process_batch_samples(x).tokens
        jax_hot_swap(jstate, "ckpt1")
        hot_swap(state, "ckpt1")
        want = jstate.pipeline.process_batch_samples(x).tokens
        got = state.pipeline.process_batch_samples(x).tokens
        assert len(want) > 0 and want != before
        assert got == want
    finally:
        state.close()
        jstate.close()
