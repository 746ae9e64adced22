"""The load generator: a process of its own, so that its JSON and WebSocket
work never shares the server's interpreter lock.

    python -m gpubench.loadgen --traffic gpubench/traffic/<mix>.json \
        --seed N --seconds S --model NAME

It makes every body and PCM frame from the seed first, prints
``{"ready": ...}``, then reads one line from standard input,
``{"port": P, "t0": T}`` (``T`` on the monotonic clock, which every process
of the host shares), runs the mix against ``127.0.0.1:P`` from ``T`` for
``S`` seconds, waits for what is outstanding (at most ``DRAIN_S`` past the
close), and prints ``{"late": ...}`` (how late it sent, against each due
time) and ``{"results": ...}``, one JSON object per line.

Times are the client's: a request is due when a closed-loop caller sends it
or when an open loop's schedule says; a partial is due when the frame it
answers was complete; a final when the utterance ended.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import sys
import time

import numpy as np

from . import audio, traffic

DRAIN_S = 60.0
OPEN_CONNECTIONS = 16  # kept open before an open loop's window


def tokens_of(text: str) -> list:
    """The ids of a transcript under the benchmark's vocabulary, where id
    ``i`` is the word ``w<i>``."""
    return [int(w[1:]) for w in text.split()]


def _bodies(spec: dict, seed: int) -> list:
    return [traffic.body(spec, audio.pcm16(traffic.pool_audio(spec, seed, i)))
            for i in range(spec["pool"])]


async def _sleep_until(t: float) -> None:
    dt = t - time.monotonic()
    if dt > 0:
        await asyncio.sleep(dt)


async def _post(session, url: str, data: bytes, rec: dict) -> None:
    import aiohttp
    rec["sent"] = time.monotonic()
    try:
        async with session.post(url, data=data, headers={
                "Content-Type": "application/json"},
                timeout=aiohttp.ClientTimeout(total=DRAIN_S)) as resp:
            payload = await resp.read()
            rec["done"] = time.monotonic()
            rec["status"] = resp.status
            if resp.status == 200:
                rec["tokens"] = json.loads(payload)["metadata"]["tokens"]
            else:
                rec["error"] = payload[:200].decode(errors="replace")
    except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
        rec["done"] = time.monotonic()
        rec["status"] = 0
        rec["error"] = f"{type(e).__name__}: {e}"[:200]


async def _connect(session, url: str, n: int) -> None:
    """Open ``n`` keep-alive connections before the window (``GET
    /health``), so that no request in it pays a connect."""
    import aiohttp
    health = url.split("/v2/")[0] + "/health"

    async def one():
        async with session.get(health, timeout=aiohttp.ClientTimeout(
                total=10)) as resp:
            await resp.read()
    await asyncio.gather(*(one() for _ in range(n)))


async def run_closed(spec, seed, seconds, url, t0, bodies):
    import aiohttp
    lengths = traffic.pool_lengths(spec)
    order = traffic.request_order(spec, seed, 1 << 16)
    recs, nxt = [], [0]
    end = t0 + seconds

    async def client(session):
        await _sleep_until(t0)
        while time.monotonic() < end:
            i = nxt[0]
            nxt[0] += 1
            p = int(order[i % len(order)])
            rec = {"i": i, "pool": p, "audio_s": float(lengths[p])}
            recs.append(rec)
            await _post(session, url, bodies[p], rec)
            rec["due"] = rec["sent"]

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as session:
        await _connect(session, url, spec["clients"])
        await asyncio.gather(*(client(session)
                               for _ in range(spec["clients"])))
    return recs, []


async def run_open(spec, seed, seconds, url, t0, bodies):
    import aiohttp
    lengths = traffic.pool_lengths(spec)
    due = t0 + traffic.arrivals(spec, seed, seconds)
    order = traffic.request_order(spec, seed, len(due))
    recs, tasks = [], []
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as session:
        await _connect(session, url, OPEN_CONNECTIONS)
        for i, d in enumerate(due):
            await _sleep_until(float(d))
            p = int(order[i])
            rec = {"i": i, "pool": p, "audio_s": float(lengths[p]),
                   "due": float(d)}
            recs.append(rec)
            tasks.append(asyncio.create_task(
                _post(session, url, bodies[p], rec)))
        await asyncio.gather(*tasks)
    late = [r["sent"] - r["due"] for r in recs]
    return recs, late


async def _stream(session, url, spec, frames, start, rec, late):
    """One utterance over one WebSocket: frames at their due times, END,
    then the COMPLETE."""
    import aiohttp
    frame_s = spec["frame_s"]
    await _sleep_until(start)
    try:
        async with session.ws_connect(url, max_msg_size=0) as ws:
            answered = []

            async def reader():
                async for msg in ws:
                    if msg.type != aiohttp.WSMsgType.TEXT:
                        break
                    m = json.loads(msg.data)
                    now = time.monotonic()
                    if m["status"] == "COMPLETE":
                        rec["complete"] = now
                        rec["tokens"] = tokens_of(m["transcription"])
                        return
                    if m["status"] == "ERROR":
                        rec["error"] = m.get("message", "")[:200]
                        return
                    if m["status"] == "ACTIVE" and \
                            m.get("message") != "processing":
                        answered.append(now)

            read = asyncio.create_task(reader())
            full = 0
            for k, frame in enumerate(frames):
                due = min(start + (k + 1) * frame_s, rec["end_due"])
                await _sleep_until(due)
                late.append(time.monotonic() - due)
                await ws.send_bytes(frame)
                full += len(frame) == len(frames[0])
            await ws.send_bytes(b"\xff")
            try:
                await asyncio.wait_for(read, DRAIN_S)
            except asyncio.TimeoutError:
                pass
            if "complete" not in rec and "error" not in rec:
                rec["error"] = "closed without a COMPLETE"
            # answered frame k (in order) was due when its audio was whole
            rec["partials"] = [[start + (k + 1) * frame_s, t]
                               for k, t in enumerate(answered[:full])]
    except (aiohttp.ClientError, OSError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"[:200]


async def run_streams(spec, seed, seconds, url, t0, pcm):
    import aiohttp
    plan = traffic.stream_plan(spec, seed, seconds)
    n_frame = int(round(spec["frame_s"] * audio.SAMPLE_RATE)) * 2
    recs, late, tasks = [], [], []
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as session:
        for streams in plan:
            for start, length_s, j in streams:
                data = pcm[j]
                frames = [data[i:i + n_frame]
                          for i in range(0, len(data), n_frame)]
                rec = {"j": j, "audio_s": length_s, "start_due": t0 + start,
                       "end_due": t0 + start + len(data) / 2
                       / audio.SAMPLE_RATE}
                recs.append(rec)
                tasks.append(asyncio.create_task(_stream(
                    session, url, spec, frames, t0 + start, rec, late)))
        await asyncio.gather(*tasks)
    return recs, late


def prepare(spec: dict, seed: int, seconds: float):
    if spec["kind"] == "ws_streams":
        return {j: audio.pcm16(traffic.stream_audio(seed, length_s, j))
                for streams in traffic.stream_plan(spec, seed, seconds)
                for _, length_s, j in streams}
    return _bodies(spec, seed)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--model", default="default")
    ap.add_argument("--override", default="{}",
                    help="JSON object of traffic keys to replace")
    args = ap.parse_args(argv)
    spec = traffic.load(args.traffic)
    spec.update(json.loads(args.override))
    t = time.monotonic()
    data = prepare(spec, args.seed, args.seconds)
    gc.collect()
    gc.freeze()  # the bodies and frames are never garbage
    print(json.dumps({"ready": True, "prepare_s": time.monotonic() - t}),
          flush=True)
    go = json.loads(sys.stdin.readline())
    kind = spec["kind"]
    if kind == "ws_streams":
        url = (f"ws://127.0.0.1:{go['port']}/v2/decode/stream/"
               f"{args.model}")
        runner = run_streams
    else:
        url = f"http://127.0.0.1:{go['port']}/v2/decode/batch/{args.model}"
        runner = run_closed if kind == "closed_http" else run_open
    recs, late = asyncio.run(runner(spec, args.seed, args.seconds, url,
                                    go["t0"], data))
    late_ms = np.asarray(late) * 1e3 if late else np.zeros(1)
    print(json.dumps({"late": {
        "n": len(late), "p50_ms": float(np.percentile(late_ms, 50)),
        "p95_ms": float(np.percentile(late_ms, 95)),
        "max_ms": float(late_ms.max())}}), flush=True)
    print(json.dumps({"results": recs}), flush=True)


if __name__ == "__main__":
    main()
