"""HTTP and WebSocket front-end on aiohttp (port of server/app.py).

    GET  /v2/decode/stream/{model}   WebSocket streaming: chunked (window
                                     re-decode through the batcher), or
                                     native on a causal preset (the lane
                                     engine); see server/stream.py
    POST /v2/decode/batch/{model}    batch transcription (greedy or beam;
                                     beam adds n_best, decode_path and, on
                                     request, a lattice)
    GET  /health                     health check (?deep=1 probes the device)
    GET  /metrics                    JSON metrics (or prometheus)
    POST /admin/reset-batch-count    zombie-request reset
    GET  /admin/config               effective configuration

Request validation, status codes and the camelCase response schema are the
reference's. Not served yet: the model-repository routes (ROADMAP.md queue
1 item 6, [#12]) and streaming beam (item 4, [#10], refused at startup).

Entry point: ``python -m amira_rust_asr_server_tpu_torch.server --preset
large`` (``AMIRA_STREAMING_MODE=native`` with ``--preset large-streaming``
for native streaming).
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Optional

import torch
from aiohttp import web

from .. import constants as C
from ..config import Config
from ..errors import (AppError, CapacityExceededError, CircuitOpenError,
                      RequestValidationError)
from ..reliability import get_logger, init_tracing, request_span
from ..vocab import Vocabulary
from ..audio import pcm16_bytes_to_f32
from ..convert import load_npz
from ..device import resolve_device
from ..models import Transducer
from ..models.presets import get_preset
from ..ops.lattice import decode_beam_lattice
from ..runtime import AsrPipeline
from ..runtime.pipeline import check_supported
from ..types import AsrResponse, StreamStatus
from ..utils.platform import initialize_platform
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
    opaque = body.get("opaque")
    if opaque is not None and len(json.dumps(opaque)) > C.MAX_OPAQUE_BYTES:
        raise RequestValidationError("Opaque data too large (max: 10KB)")
    return audio, opaque


def error_response(err: Exception) -> web.Response:
    if isinstance(err, AppError):
        return web.json_response(err.to_json(), status=err.http_status)
    return web.json_response(
        {"error": "internal_error", "message": str(err)}, status=500)


async def handle_batch(request: web.Request) -> web.Response:
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
        try:
            body = await request.json()
        except ValueError:
            raise RequestValidationError("invalid JSON body") from None
        if not isinstance(body, dict):
            raise RequestValidationError("request body must be an object")
        audio, opaque = parse_batch_request(
            body, state.config.max_batch_audio_length_secs)
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
        with request_span("batch", model=request.match_info.get("model")):
            warm = state.pipeline.is_warm(1, len(audio) // 2)
            budget = (state.config.inference_timeout_secs * 6 if warm
                      else state.config.cold_bucket_timeout_secs)
            async with state.shutdown.guard():
                tc = time.perf_counter()
                samples = pcm16_bytes_to_f32(audio)
                if state.prometheus:
                    state.prometheus.audio_conversion.observe(
                        time.perf_counter() - tc)
                    state.prometheus.audio_chunk_bytes.observe(len(audio))
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
            metadata["words"] = state.vocab.decode_words(tr.token_details)
        if tr.n_best:
            metadata["n_best"] = tr.n_best
        if tr.decode_path:
            # kernel-vs-scan routing (a grammar past the kernel's state cap
            # runs the slower plain scan)
            metadata["decode_path"] = tr.decode_path
        if want_lattice:
            sec_per_frame = (C.HOP_LENGTH
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
                len(audio) / (2 * C.SAMPLE_RATE))
        return web.json_response(response.to_json())
    except asyncio.TimeoutError:
        state.metrics.record_error()
        if state.prometheus:
            state.prometheus.observe_request("batch", "error",
                                             error="timeout")
        return web.json_response(
            {"error": "inference_timeout", "message": "inference timed out"},
            status=504)
    except Exception as e:  # noqa: BLE001 — boundary: report, keep serving
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
        # device-liveness probe: a tiny op must complete within 2 s
        device = state.pipeline.device

        def probe():
            return float(torch.ones((8, 128), device=device).sum().item())

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
    return web.json_response(payload)


async def get_config(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    cfg = dataclasses.asdict(state.config)
    cfg["model_config"] = dataclasses.asdict(state.pipeline.model.config)
    return web.json_response(cfg)


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
    return app


def load_model(cfg: Config, preset: Optional[str] = None) -> Transducer:
    """The preset's model with the configured weights: a converted ``.npz``
    state dict (tools/export_torch_params.py), or a seeded random init.

    With no ``checkpoint_path`` the port serves torch-seeded random weights
    (``INIT_SEED``) where the reference serves ``PRNGKey(0)`` weights, so
    the two packages' servers (the ``large`` preset included) give
    different text. Parity between them goes through the same weights:
    ``convert.from_jax_params`` or a converted ``.npz``."""
    model = Transducer.from_preset(preset or cfg.model_preset)
    if not cfg.checkpoint_path:
        return model.init_weights(torch.Generator().manual_seed(INIT_SEED))
    if Path(cfg.checkpoint_path).suffix != ".npz":
        raise NotImplementedError(
            f"checkpoint {cfg.checkpoint_path!r}: the port reads converted "
            ".npz state dicts; convert an orbax tree with "
            "tools/export_torch_params.py")
    model.load_state_dict(load_npz(cfg.checkpoint_path))
    log.info("loaded checkpoint from %s", cfg.checkpoint_path)
    return model


def build_state(config: Optional[Config] = None,
                preset: Optional[str] = None,
                warmup: Optional[bool] = None) -> AppState:
    """Wire config -> model -> pipeline -> state (ref: src/main.rs:23-112)."""
    cfg = config or Config.load()
    if cfg.enable_platform_optimizations:
        # probed and validated before the device is chosen, so the
        # effective config picks it (the reference serves it too)
        cfg = initialize_platform(cfg).effective_config
    device = resolve_device(cfg.inference_backend)
    check_supported(cfg, device, get_preset(preset or cfg.model_preset).causal)
    try:
        vocab = Vocabulary.load(cfg.vocabulary_path)
    except FileNotFoundError:
        log.warning("vocabulary %s not found; using empty vocab",
                    cfg.vocabulary_path)
        vocab = Vocabulary.from_map({})
    pipeline = AsrPipeline(load_model(cfg, preset), vocab, cfg, device)
    state = AppState(pipeline, vocab, cfg)
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
    asyncio.run(run_server(state, args.host, args.port))


if __name__ == "__main__":
    main()
