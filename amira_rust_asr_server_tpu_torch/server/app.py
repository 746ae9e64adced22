"""HTTP and WebSocket front-end on aiohttp (port of server/app.py).

    GET  /v2/decode/stream/{model}   WebSocket streaming: chunked (window
                                     re-decode through the batcher), or
                                     native on a causal preset (greedy: the
                                     lane engine; beam: a streaming beam
                                     session per stream); see
                                     server/stream.py
    POST /v2/decode/batch/{model}    batch transcription (greedy or beam;
                                     beam adds n_best, decode_path and, on
                                     request, a lattice)
    GET  /health                     health check (?deep=1 probes the device)
    GET  /metrics                    JSON metrics (or prometheus)
    POST /admin/reset-batch-count    zombie-request reset
    GET  /admin/config               effective configuration
    GET|POST /v2/repository/index    model-repository listing
    POST /v2/repository/models/{name}/load   hot checkpoint reload
                                     (?validate=1: a canary decode, and a
                                     rollback if it fails); see
                                     runtime/reload.py

Request validation, status codes and the camelCase response schema are the
reference's. ``model_family`` chooses the model: the transducer, or the CTC
and AED families (``runtime/family_pipeline.py``), which serve the batch
endpoint only (streaming and lattices answer 400 for them).

Entry point: ``python -m amira_rust_asr_server_tpu_torch.server --preset
large`` (``AMIRA_STREAMING_MODE=native`` with ``--preset large-streaming``
for native streaming, and ``AMIRA_DECODING_MODE=beam`` beside them for
streaming beam). Over a device mesh, one process per device:
``torchrun --nproc-per-node N -m amira_rust_asr_server_tpu_torch.server``;
rank 0 serves HTTP and the other ranks follow its device dispatches
(``parallel/serve.py``).
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import logging
import os
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from aiohttp import web

from .. import constants as C
from ..config import Config
from ..errors import (AppError, CapacityExceededError, CircuitOpenError,
                      RequestValidationError)
from ..reliability import get_logger, init_tracing, request_span, tracing
from ..vocab import Vocabulary
from ..audio import pcm16_bytes_to_f32
from ..device import resolve_device
from ..models.presets import get_preset
from ..ops.lattice import decode_beam_lattice
from ..parallel import multihost
from ..parallel.mesh import make_mesh
from ..parallel.serve import follow, join_serving_world
from ..runtime.family_pipeline import family_model, serving_pipeline
from ..runtime.pipeline import check_supported
from ..runtime.reload import hot_swap, repository_index
from ..types import AsrResponse, StreamStatus
from ..utils.affinity import ThreadType, set_thread_affinity
from ..utils.platform import initialize_platform
from . import body as body_codec
from .state import AppState
from .stream import StreamProcessor

log = get_logger("asr.server")

INIT_SEED = 0  # seeded random init when no checkpoint is configured


def parse_batch_request(body: dict,
                        max_secs: float = C.MAX_BATCH_AUDIO_LENGTH_SECS
                        ) -> tuple[bytes, Any]:
    """(audio_bytes, opaque) from a batch body. ``audio_buffer`` is a JSON
    array of u8 (the reference's wire form) or a base64 string."""
    if "audio_buffer" not in body:
        raise RequestValidationError("audio_buffer is required")
    raw = body["audio_buffer"]
    if isinstance(raw, str):
        try:
            audio = base64.b64decode(raw, validate=True)
        except ValueError:
            raise RequestValidationError(
                "audio_buffer string must be base64") from None
    elif isinstance(raw, list):
        try:
            audio = bytes(raw)
        except (ValueError, TypeError):
            raise RequestValidationError(
                "audio_buffer must contain bytes 0-255") from None
    else:
        raise RequestValidationError("audio_buffer must be array or base64")

    if len(audio) == 0:
        raise RequestValidationError("Audio buffer cannot be empty")
    if len(audio) % 2 != 0:
        raise RequestValidationError(
            "Audio buffer length must be even for 16-bit PCM")
    if len(audio) > C.MAX_AUDIO_BYTES:
        raise RequestValidationError(
            f"Audio buffer too large: {len(audio)} bytes "
            f"(max: {C.MAX_AUDIO_BYTES} bytes)")
    secs = len(audio) / (C.SAMPLE_RATE * 2.0)
    if secs > max_secs:
        raise RequestValidationError(
            f"Audio too long: {secs:.1f}s (max: {max_secs:.0f}s)")
    return audio, batch_opaque(body)


def batch_opaque(body: dict) -> Any:
    """The body's ``opaque``, checked for size."""
    opaque = body.get("opaque")
    if opaque is not None and len(json.dumps(opaque)) > C.MAX_OPAQUE_BYTES:
        raise RequestValidationError("Opaque data too large (max: 10KB)")
    return opaque


def _json_object(raw: bytes) -> dict:
    try:
        body = json.loads(raw)
    except ValueError:
        raise RequestValidationError("invalid JSON body") from None
    if not isinstance(body, dict):
        raise RequestValidationError("request body must be an object")
    return body


async def decode_batch_body(state: AppState, raw: bytes,
                            parent: Optional[tracing.Span] = None
                            ) -> tuple[dict, np.ndarray, Any]:
    """(body, samples, opaque) of a batch request's raw bytes. The native
    decoder (``server/body.py``) takes a base64 ``audio_buffer`` on the body
    pool, off the event loop and without the interpreter lock, and the rest
    of the body (the audio's string token emptied) is parsed here; any body
    it declines is parsed in Python, so both paths give the same samples,
    values and error answers. On the pool the call is the span
    ``http.decode.native`` (a child of ``parent``): the rest of the
    awaited decode is the hand-off to the pool's thread and back."""
    max_secs = state.config.max_batch_audio_length_secs
    if state.body_lib is not None:
        def native():
            with tracing.span("http.decode.native", parent) as sp:
                got = body_codec.decode(state.body_lib, raw, max_secs)
            return got, sp.t1 - sp.t0

        loop = asyncio.get_running_loop()
        got, took = await loop.run_in_executor(state.body_pool, native)
        if got is not None:
            samples, start, end = got
            state.batcher.stats.record_body(native=True)
            if state.prometheus:
                state.prometheus.audio_conversion.observe(took)
            body = _json_object(raw[:start] + b'""' + raw[end:])
            return body, samples, batch_opaque(body)
    state.batcher.stats.record_body(native=False)
    body = _json_object(raw)
    audio, opaque = parse_batch_request(body, max_secs)
    tc = time.perf_counter()
    samples = pcm16_bytes_to_f32(audio)
    if state.prometheus:
        state.prometheus.audio_conversion.observe(time.perf_counter() - tc)
    return body, samples, opaque


def error_response(err: Exception) -> web.Response:
    if isinstance(err, AppError):
        return web.json_response(err.to_json(), status=err.http_status)
    return web.json_response(
        {"error": "internal_error", "message": str(err)}, status=500)


async def handle_batch(request: web.Request) -> web.Response:
    """One batch request, recorded as the root span ``http.batch`` with the
    children ``http.read`` (the body received), ``http.decode`` (the
    body's decode, awaited on the loop, run on the body pool: JSON,
    validation and base64, PCM; :func:`decode_batch_body`), ``http.wait``
    (the decode awaited) and ``http.respond``."""
    with request_span("http.batch",
                      model=request.match_info.get("model")) as root:
        return await _batch(request, root)


async def _batch(request: web.Request, root) -> web.Response:
    state: AppState = request.app["state"]
    if state.shutdown.is_shutting_down:
        return web.json_response(
            {"error": "shutting_down", "message": "server is draining"},
            status=503)
    if not state.batch_semaphore.try_acquire():
        state.metrics.record_rejection()
        return error_response(CapacityExceededError(
            "Too many concurrent batch requests"))
    state.metrics.increment_batch()
    t0 = time.perf_counter()
    try:
        with tracing.span("http.read", root):
            raw = await request.read()
        root.set("bytes", len(raw))
        with tracing.span("http.decode", root) as decode:
            body, samples, opaque = await decode_batch_body(state, raw,
                                                            decode)
            want_lattice = bool(body.get("lattice", False))
            if want_lattice and state.config.decoding_mode != "beam":
                raise RequestValidationError(
                    "lattice output requires decoding_mode=beam")
            if want_lattice and state.config.model_family != "transducer":
                raise RequestValidationError(
                    "lattice output requires the transducer model family")
            lattice_n_best = body.get("n_best", state.config.beam_width)
            if want_lattice:
                try:
                    lattice_n_best = max(1, int(lattice_n_best))
                except (TypeError, ValueError):
                    raise RequestValidationError(
                        "n_best must be an integer") from None
            if state.prometheus:
                state.prometheus.audio_chunk_bytes.observe(
                    2 * samples.shape[0])
        with tracing.span("http.wait", root):
            warm = state.pipeline.is_warm(1, samples.shape[0])
            budget = (state.config.inference_timeout_secs * 6 if warm
                      else state.config.cold_bucket_timeout_secs)
            async with state.shutdown.guard():
                if want_lattice:
                    # lattices need the trace, which the batcher's results
                    # do not carry: the request bypasses it but runs on the
                    # dispatch thread, behind the breaker and the budget,
                    # through the pipeline's own beam dispatch
                    loop = asyncio.get_running_loop()
                    res, lattices, feat_lens, enc_lens = (
                        await state.breaker.call_async(asyncio.wait_for(
                            loop.run_in_executor(
                                state.inference_executor,
                                lambda: decode_beam_lattice(
                                    state.pipeline, [samples],
                                    n_best=lattice_n_best)),
                            budget)))
                    tr = state.pipeline.beam_transcription(
                        res, 0, samples.shape[0], feat_lens[0], enc_lens[0])
                else:
                    tr, _ = await state.breaker.call_async(
                        asyncio.wait_for(state.batcher.submit(samples),
                                         budget))

        with tracing.span("http.respond", root):
            metadata = {
                "audio_length_samples": tr.audio_length_samples,
                "features_length": tr.features_length,
                "encoded_length": tr.encoded_length,
                "tokens": tr.tokens,
            }
            if tr.token_details:
                metadata["token_details"] = [
                    {"id": d.id, "time_s": d.time_s,
                     "confidence": d.confidence} for d in tr.token_details]
                metadata["words"] = state.vocab.decode_words(
                    tr.token_details)
            if tr.n_best:
                metadata["n_best"] = tr.n_best
            if tr.decode_path:
                # kernel-vs-scan routing (a grammar past the kernel's state
                # cap runs the slower plain scan)
                metadata["decode_path"] = tr.decode_path
            if want_lattice:
                sec_per_frame = (
                    C.HOP_LENGTH
                    * state.pipeline.model.config.subsampling_factor
                    / C.SAMPLE_RATE)
                metadata["lattice"] = lattices[0].to_dict(
                    vocab=state.vocab, sec_per_frame=sec_per_frame)
            response = AsrResponse(transcription=tr.text,
                                   status=StreamStatus.COMPLETE,
                                   metadata=metadata, opaque=opaque)
            if state.prometheus:
                state.prometheus.observe_request(
                    "batch", "ok", time.perf_counter() - t0,
                    samples.shape[0] / C.SAMPLE_RATE)
            return web.json_response(response.to_json())
    except asyncio.TimeoutError:
        root.set("error", "inference_timeout")
        state.metrics.record_error()
        if state.prometheus:
            state.prometheus.observe_request("batch", "error",
                                             error="timeout")
        return web.json_response(
            {"error": "inference_timeout", "message": "inference timed out"},
            status=504)
    except Exception as e:  # noqa: BLE001 — boundary: report, keep serving
        root.set("error", type(e).__name__)
        if not isinstance(e, AppError):
            log.exception("batch handler error")
        state.metrics.record_error()
        if state.prometheus:
            if isinstance(e, CircuitOpenError):
                state.prometheus.breaker_rejections.inc()
            state.prometheus.observe_request(
                "batch", "error", error=type(e).__name__)
        return error_response(e)
    finally:
        state.metrics.decrement_batch()
        state.batch_semaphore.release()


async def handle_stream(request: web.Request) -> web.StreamResponse:
    state: AppState = request.app["state"]
    cfg = state.config
    if cfg.model_family != "transducer":
        # the WebSocket contract carries decoder state across chunks
        return web.json_response(
            {"error": "unsupported_model_family",
             "message": f"streaming requires the transducer family; "
                        f"model_family={cfg.model_family} serves "
                        f"the batch endpoint only"},
            status=400)
    if cfg.decoding_mode == "beam" and not (
            cfg.streaming_mode == "native"
            and state.pipeline.model.config.causal):
        # the chunked mode cannot carry a beam across windows
        return web.json_response(
            {"error": "unsupported_decoding_mode",
             "message": "beam streaming requires streaming_mode=native "
                        "with a causal model; batch endpoint serves beam "
                        "for non-native configurations"},
            status=400)
    ws = web.WebSocketResponse(heartbeat=None,
                               max_msg_size=2 * C.MAX_WS_CHUNK_BYTES)
    await ws.prepare(request)

    if not state.stream_semaphore.try_acquire():
        state.metrics.record_rejection()
        log.error("rejected stream: too many concurrent streams")
        await ws.close(code=1013, message=b"too many concurrent streams")
        return ws

    # built before any gauge moves: an exception here leaves none raised
    try:
        processor = StreamProcessor(ws, state)
    except BaseException:
        state.stream_semaphore.release()
        raise
    stream_id = processor.stream_id
    state.metrics.increment_stream()
    if state.prometheus:
        state.prometheus.ws_connections.inc()
        state.prometheus.ws_active.inc()
    state.active_streams[stream_id] = processor
    log.info("stream %s started (model=%s)", stream_id,
             request.match_info.get("model"))
    try:
        async with state.shutdown.guard():
            with request_span("stream", model=request.match_info.get(
                    "model")):
                await processor.process()
    finally:
        state.active_streams.pop(stream_id, None)
        state.metrics.decrement_stream()
        if state.prometheus:
            state.prometheus.ws_active.dec()
        state.stream_semaphore.release()
        if not ws.closed:
            await ws.close()
        log.info("stream %s ended", stream_id)
    return ws


async def health_check(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    payload = {"status": "healthy", "service": "amira-asr-tpu-server",
               "version": "1.0.0"}
    if request.query.get("deep"):
        if state.mirror is not None:
            payload["world"] = state.mirror.health()
            if state.mirror.degraded:
                payload["status"] = "degraded"
                return web.json_response(payload, status=503)
        # device-liveness probe: a tiny op must complete within 2 s (on
        # rank 0's device alone: no collective)
        device = state.pipeline.device

        def probe():
            with state.pipeline.device_lock:
                return float(torch.ones((8, 128), device=device).sum()
                             .item())

        loop = asyncio.get_running_loop()
        try:
            value = await asyncio.wait_for(
                loop.run_in_executor(state.inference_executor, probe), 2.0)
            payload["device"] = {"platform": device.type,
                                 "probe": value == 1024.0}
        except Exception as e:  # noqa: BLE001 — report a degraded device
            payload["status"] = "degraded"
            payload["device"] = {"error": str(e)[:200]}
            payload["circuit_breaker"] = state.breaker.stats()
            return web.json_response(payload, status=503)
    return web.json_response(payload)


async def metrics_handler(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    if state.prometheus:
        return web.Response(body=state.prometheus.exposition(),
                            content_type="text/plain")
    payload = state.metrics.to_json()
    payload["circuit_breaker"] = state.breaker.stats()
    payload["batcher"] = state.batcher.stats.to_json()
    if state.lane_engine is not None:
        eng = state.lane_engine
        payload["lane_engine"] = eng.stats.to_json(
            eng.live_lanes, eng.n_lanes, eng.warmed_up)
    if state.config.decoding_mode == "beam":
        payload["beam_decode_paths"] = dict(state.pipeline.decode_path_counts)
    aed = getattr(state.pipeline, "aed_stats", None)
    if aed is not None:  # the AED family's greedy dispatches
        payload["aed"] = aed.to_json()
    if state.mirror is not None:
        payload["world"] = state.mirror.to_json()
    return web.json_response(payload)


async def get_config(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    cfg = dataclasses.asdict(state.config)
    cfg["model_config"] = dataclasses.asdict(state.pipeline.model.config)
    return web.json_response(cfg)


async def repository_index_handler(request: web.Request) -> web.Response:
    """Model-repository listing, the in-process analogue of Triton's
    ``POST /v2/repository/index`` (served on GET too)."""
    state: AppState = request.app["state"]
    rows = repository_index(state.config.model_repo_path,
                            state.loaded_model)
    return web.json_response({
        "models": rows,
        "loaded": state.loaded_model,
        "model_repository": state.config.model_repo_path,
    })


async def repository_load(request: web.Request) -> web.Response:
    """Hot checkpoint reload, Triton's ``/v2/repository/models/{name}/load``
    in-process: new weights without a restart or a capture
    (runtime/reload.py). 404 unknown model, 409 while native lanes are
    live, 422 on a mismatched checkpoint; the old weights keep serving on
    any failure."""
    state: AppState = request.app["state"]
    if state.shutdown.is_shutting_down:
        return web.json_response(
            {"error": "shutting_down", "message": "server is draining"},
            status=503)
    name = request.match_info["name"]
    validate = request.query.get("validate", "") in ("1", "true", "yes")
    loop = asyncio.get_running_loop()
    try:
        # the session executor: reading and staging take seconds, never on
        # the event loop; the swap itself runs on the dispatch thread
        info = await loop.run_in_executor(
            state.session_executor, hot_swap, state, name, validate)
    except Exception as e:  # noqa: BLE001 — boundary: report, keep serving
        if not isinstance(e, AppError):
            log.exception("reload failed for %r", name)
        return error_response(e)
    return web.json_response({"status": "success", **info})


async def reset_batch_count(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    state.metrics.reset_batch_count()
    return web.json_response({"status": "success",
                              "message": "Batch count reset successfully"})


@web.middleware
async def cors_middleware(request: web.Request, handler):
    resp = web.Response() if request.method == "OPTIONS" \
        else await handler(request)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    return resp


def create_app(state: AppState) -> web.Application:
    app = web.Application(middlewares=[cors_middleware],
                          client_max_size=2 * C.MAX_AUDIO_BYTES)
    app["state"] = state

    async def _start_batcher(app):
        await state.batcher.start()

    async def _stop_batcher(app):
        await state.batcher.stop()

    app.on_startup.append(_start_batcher)
    app.on_cleanup.append(_stop_batcher)
    app.router.add_get("/v2/decode/stream/{model}", handle_stream)
    app.router.add_post("/v2/decode/batch/{model}", handle_batch)
    app.router.add_get("/health", health_check)
    app.router.add_get("/metrics", metrics_handler)
    app.router.add_post("/admin/reset-batch-count", reset_batch_count)
    app.router.add_get("/admin/config", get_config)
    app.router.add_get("/v2/repository/index", repository_index_handler)
    app.router.add_post("/v2/repository/index", repository_index_handler)
    app.router.add_post("/v2/repository/models/{name}/load",
                        repository_load)
    return app


def load_model(cfg: Config, preset: Optional[str] = None) -> torch.nn.Module:
    """The model of ``cfg.model_family`` (transducer, CTC or AED) on the
    preset, with the configured weights: a converted ``.npz`` state dict
    (tools/export_torch_params.py), or a seeded random init.

    With no ``checkpoint_path`` the port serves torch-seeded random weights
    (``INIT_SEED``) where the reference serves ``PRNGKey(0)`` weights, so
    the two packages' servers (the ``large`` preset included) give
    different text. Parity between them goes through the same weights:
    ``convert.from_jax_params`` or a converted ``.npz``."""
    return family_model(cfg.model_family, preset or cfg.model_preset, cfg,
                        seed=INIT_SEED)


def _join_world(cfg: Config, timeout_s: float) -> bool:
    """Join torchrun's world (its environment) unless this process is in
    one already: NCCL on this rank's card, gloo for
    ``inference_backend="cpu"``. True when this call joined it."""
    env = multihost.from_env()
    if env is None or dist.is_initialized():
        return False
    return multihost.init_distributed(
        env.coordinator, env.world_size, env.rank,
        device="cpu" if cfg.inference_backend == "cpu" else "cuda",
        local_rank=env.local_rank, timeout_s=timeout_s)


def build_state(config: Optional[Config] = None,
                preset: Optional[str] = None,
                warmup: Optional[bool] = None,
                world_timeout_s: float = multihost.WORLD_TIMEOUT_S
                ) -> AppState:
    """Wire config -> model -> pipeline -> state (ref: src/main.rs:23-112).

    Under a world of ranks (one process per device: torchrun's
    environment, or a process group made by the caller) every rank
    builds the same state on the mesh ``cfg.mesh_shape`` (by default every
    rank on ``data``), as the reference serves over its mesh; rank 0's
    state sends each device entry to the others (``parallel/serve.py``)
    and warms up, the others' (:attr:`AppState.follower`) only follow
    (:func:`~parallel.serve.follow`). ``world_timeout_s`` bounds every
    wait of the world."""
    cfg = config or Config.load()
    owned = _join_world(cfg, world_timeout_s)
    if cfg.enable_platform_optimizations:
        # probed and validated before the device is chosen, so the
        # effective config picks it (the reference serves it too)
        cfg = initialize_platform(cfg).effective_config
    device = resolve_device(cfg.inference_backend)
    in_world = dist.is_initialized()
    if in_world and not cfg.mesh_shape:
        cfg = dataclasses.replace(cfg, mesh_shape={
            "data": dist.get_world_size(), "model": 1})
    check_supported(cfg, device, get_preset(preset or cfg.model_preset).causal,
                    world_size=dist.get_world_size() if in_world else 1)
    try:
        vocab = Vocabulary.load(cfg.vocabulary_path)
    except FileNotFoundError:
        log.warning("vocabulary %s not found; using empty vocab",
                    cfg.vocabulary_path)
        vocab = Vocabulary.from_map({})
    model = load_model(cfg, preset)
    if cfg.checkpoint_path:
        log.info("loaded %s checkpoint from %s", cfg.model_family,
                 cfg.checkpoint_path)
    world = mesh = None
    if in_world:
        mesh = make_mesh(cfg.mesh_shape)
        world = join_serving_world(world_timeout_s, owned)
    pipeline = serving_pipeline(model, vocab, cfg, device, mesh)
    state = AppState(pipeline, vocab, cfg, world)
    if state.follower:
        return state  # its warm-ups come from rank 0
    if warmup if warmup is not None else cfg.warmup_on_start:
        t0 = time.time()
        n = pipeline.warmup()
        log.info("warmed %d bucket programs in %.1fs", n, time.time() - t0)
        # the remaining buckets warm off-thread; in native mode only while
        # no stream is live
        state.start_warmup_supervisor()
        if state.lane_engine is not None:
            # warm before accepting: the chunk step is native mode's hot
            # path, and its first run would land inside a live stream
            took = state.lane_engine.warm()
            log.info("warmed the lane engine (%d lanes) in %.1fs",
                     state.lane_engine.n_lanes, took)
            # and the solo chunk program a stream runs when every lane is
            # busy
            took = pipeline.warm_solo_chunk(cfg.native_chunk_frames,
                                            cfg.max_symbols_per_step,
                                            cfg.max_total_tokens)
            log.info("warmed the solo chunk program in %.1fs", took)
        if (cfg.decoding_mode == "beam" and cfg.streaming_mode == "native"
                and pipeline.model.config.causal):
            # the streaming beam's chunk program, likewise
            took = pipeline.warm_beam_chunk(cfg.native_chunk_frames,
                                            cfg.beam_width,
                                            graph=pipeline.beam_graph)
            log.info("warmed the streaming beam's chunk program in %.1fs",
                     took)
    return state


async def run_server(state: AppState, host: Optional[str] = None,
                     port: Optional[int] = None) -> None:
    cfg = state.config
    runner = web.AppRunner(create_app(state))
    await runner.setup()
    site = web.TCPSite(runner, host or cfg.server_host,
                       port or cfg.server_port)
    await site.start()
    state.shutdown.install_signal_handlers()
    if state.affinity_plan is not None and state.affinity_plan.enabled:
        # the event loop's thread is the plan's IO pool
        set_thread_affinity(state.affinity_plan.cores_for(ThreadType.IO))
    log.info("serving on %s:%s", host or cfg.server_host,
             port or cfg.server_port)
    try:
        await state.shutdown.wait_for_shutdown()
        log.info("shutdown: draining")
        drained = await state.shutdown.drain()
        log.info("drained=%s; closing", drained)
    finally:
        await runner.cleanup()
        state.close()


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(description="ASR server (PyTorch/CUDA)")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--preset", default=None,
                        help="model preset (tiny/base/large)")
    parser.add_argument("--config-dir", default=".")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the startup run of every length bucket")
    args = parser.parse_args(argv)

    cfg = Config.load(search_dir=args.config_dir)
    init_tracing(otel_endpoint=cfg.otel_endpoint)
    state = build_state(cfg, preset=args.preset,
                        warmup=False if args.no_warmup else None)
    if state.follower:
        # a rank above 0 of a world: no server, rank 0's dispatches
        try:
            code = follow(state)
        finally:
            state.close()
        if code:
            # a failed world: leave at once, which closes this rank's
            # connections, so no other rank waits on it past this moment
            logging.shutdown()
            os._exit(code)
        raise SystemExit(0)
    asyncio.run(run_server(state, args.host, args.port))


if __name__ == "__main__":
    main()
