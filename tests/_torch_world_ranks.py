"""What each rank of the worlds of ``tests/test_torch_world_server.py``,
``tests/test_torch_multislice.py`` and ``tests/test_torch_multihost.py``
runs: the serving worlds (``python tests/_torch_world_ranks.py spec.json``
with torchrun's environment) and, through ``launch.spawn_world``, the
functions below ``run``.

It imports torch and the port only. The rank joins the world itself
(``multihost.init_distributed`` from torchrun's environment, gloo), then
runs the spec's scenarios in order, each a server built by
``build_state`` on every rank under the same config: rank 0 serves HTTP on
the spec's port and drives it as a client, the other ranks follow
(``parallel/serve.follow``). Each rank writes what it saw to
``<out>/rank<r>.json``: per scenario the responses (rank 0), the exit code
of ``follow`` (the others), the entry log, or the error that refused the
config.
"""

import asyncio
import base64
import copy
import json
import os
import sys
import threading
import time
import traceback
from types import SimpleNamespace

import aiohttp
import numpy as np
import torch
from aiohttp import web

from amira_rust_asr_server_tpu_torch import constants as C
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import TINY
from amira_rust_asr_server_tpu_torch.models.reference_init import \
    init_reference_weights
from amira_rust_asr_server_tpu_torch.parallel import (
    TrainBatch, init_training, make_mesh, make_optimizer,
    make_param_shardings, make_train_step, multihost, place_global,
    shard_params)
from amira_rust_asr_server_tpu_torch.parallel.mesh import (local_shard,
                                                           plain_state)
from amira_rust_asr_server_tpu_torch.parallel.multislice import (
    assert_ici_contained, make_multislice_mesh, slice_groups, slice_of_row)
from amira_rust_asr_server_tpu_torch.parallel.serve import (
    DispatchMirror, WorldError, follow, join_serving_world, mirrored)
from amira_rust_asr_server_tpu_torch.server import app as server_app
from amira_rust_asr_server_tpu_torch.utils import platform


def b64(pcm: bytes) -> str:
    return base64.b64encode(pcm).decode()


async def request(session, method: str, url: str, **kw):
    t0 = time.monotonic()
    async with session.request(method, url, **kw) as r:
        return {"status": r.status, "body": await r.json(),
                "seconds": time.monotonic() - t0}


async def stream(session, url: str, pcm: bytes, step: int = 6400) -> dict:
    """``pcm`` in ``step``-byte frames, then END: the COMPLETE frame."""
    async with session.ws_connect(url) as ws:
        for i in range(0, len(pcm), step):
            await ws.send_bytes(pcm[i:i + step])
        await ws.send_bytes(bytes([C.CONTROL_BYTE_END]))
        while True:
            msg = await asyncio.wait_for(ws.receive(), timeout=120)
            if msg.type != aiohttp.WSMsgType.TEXT:
                return {"status": "CLOSED"}
            body = json.loads(msg.data)
            if body["status"] in ("COMPLETE", "ERROR"):
                return body


async def drive(state, port: int, scenario: dict, spec: dict) -> dict:
    """Rank 0: serve ``state`` on ``port`` and run the scenario's
    requests."""
    runner = web.AppRunner(server_app.create_app(state))
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}"
    batch = f"{base}/v2/decode/batch/default"
    out = {}
    try:
        async with aiohttp.ClientSession() as s:
            for step in scenario["steps"]:
                if step == "batch":
                    out.setdefault("batch", []).append(await request(
                        s, "POST", batch,
                        json={"audio_buffer": b64(spec["digits_pcm"])}))
                elif step == "load":
                    out["load"] = await request(
                        s, "POST", f"{base}/v2/repository/models/"
                        f"{spec['reload_name']}/load")
                elif step == "stream":
                    out["stream"] = await stream(
                        s, f"{base}/v2/decode/stream/default",
                        spec["noise_pcm"])
                elif step == "health":
                    out["health"] = await request(
                        s, "GET", f"{base}/health?deep=1")
                elif step == "metrics":
                    out["metrics"] = (await request(
                        s, "GET", f"{base}/metrics"))["body"]
    finally:
        await runner.cleanup()
    return out


class Counter:
    """A served object with entries, one calling another."""

    mirror_name = "pipeline"

    def __init__(self, lock):
        self.device_lock = lock
        self.mirror = None

    @mirrored
    def outer(self, x: int) -> int:
        return self.inner(x) + 1

    @mirrored
    def inner(self, x: int) -> int:
        if x < 0:
            raise ValueError("negative")
        return x

    @mirrored
    def echo(self, t: torch.Tensor) -> torch.Tensor:
        return t * 2


def one_rank_mirror(rank: int, size: int):
    """In a world of one (``launch.spawn_world``): the mirror's results,
    the entries it sent, its statistics, and what an entry raises after
    the mirror is closed."""
    lock = threading.RLock()
    world = join_serving_world(30.0, owned=False)
    obj = Counter(lock)
    obj.mirror = DispatchMirror(world, SimpleNamespace(
        device_lock=lock, device=torch.device("cpu"), beam_graph=None))
    out = [obj.outer(2), obj.echo(torch.ones(3)).tolist()]
    try:
        obj.outer(-1)
    except ValueError as e:
        out.append(str(e))
    stats = obj.mirror.to_json()
    obj.mirror.close()
    try:
        obj.inner(1)
    except WorldError as e:
        out.append(e.to_json())
    return out, list(world.entries), stats


def multislice_rank(rank: int, size: int, feats, feat_lens, batch):
    """On 4 ranks: the multi-slice mesh (2 slices x TP 2), its rows and
    containment, the tensor-parallel encoder on the reference's
    ``PRNGKey(0)`` weights, and the train step's loss from ``PRNGKey(1)``
    on ``batch``."""
    mesh = make_multislice_mesh(tp=2, n_slices=2)
    groups = slice_groups(n_slices=2)
    assert_ici_contained(mesh, groups)
    model = shard_params(mesh, init_reference_weights(Transducer(TINY), 0))
    with torch.no_grad():
        enc, enc_lens = model.encode(torch.from_numpy(feats),
                                     torch.from_numpy(feat_lens))
    opt = make_optimizer(lr=1e-3)
    trained = Transducer(TINY)
    opt_state = init_training(trained, 1, opt, mesh)
    loss = make_train_step(trained, opt, mesh)(
        opt_state, TrainBatch(*(torch.from_numpy(x) for x in batch)))
    return {"shape": (mesh.size(0), mesh.size(1)),
            "grid": mesh.mesh.tolist(), "rows": slice_of_row(mesh, groups),
            "enc": enc.numpy(), "enc_lens": enc_lens.numpy(),
            "loss": float(loss)}


def place_global_rank(rank: int, size: int):
    """:func:`place_global_check` without and with FSDP."""
    mesh = make_mesh({"data": 2, "model": 2})
    return {fsdp: place_global_check(rank, mesh, fsdp)
            for fsdp in (False, True)}


def place_global_check(rank: int, mesh, fsdp: bool):
    """On a 2 x 2 mesh: each parameter's shard from ``place_global`` and
    from ``shard_params`` on the same host values, compared bit for bit;
    then ``place_global`` on host values that differ by rank, which keeps
    each rank's own values (no transfer from rank 0)."""
    base = init_reference_weights(Transducer(TINY), 0)
    a = place_global(copy.deepcopy(base), mesh,
                     make_param_shardings(mesh, base, fsdp))
    b = shard_params(mesh, copy.deepcopy(base), fsdp)
    sa, sb = plain_state(a), plain_state(b)
    differ = [k for k in sa
              if sa[k].placements != sb[k].placements
              or not torch.equal(sa[k].to_local(), sb[k].to_local())]
    sharded = sum(any(p.is_shard() for p in t.placements)
                  for t in sa.values())
    mine = copy.deepcopy(base)
    with torch.no_grad():
        for p in mine.parameters():
            p.add_(rank)
    whole = {k: v.clone() for k, v in mine.state_dict().items()}
    placed = plain_state(place_global(
        mine, mesh, make_param_shardings(mesh, mine, fsdp)))
    own = [k for k, t in placed.items()
           if not torch.equal(t.to_local(), local_shard(
               whole[k], mesh, t.placements))]
    return differ, sharded, own


def idle_world_rank(rank: int, size: int, idle_s: float):
    """A world of 2 whose control group times out after 2 s: rank 0 sends
    an entry, idles ``idle_s``, sends another and stops the world; rank 1
    follows. The heartbeat must keep rank 1's wait inside the timeout.
    Rank 0 returns its entry log, rank 1 its exit code and its log."""
    lock = threading.RLock()
    world = join_serving_world(2.0, owned=False)
    obj = Counter(lock)
    obj.device = torch.device("cpu")
    if rank == 0:
        mirror = obj.mirror = DispatchMirror(world, SimpleNamespace(
            device_lock=lock, device=obj.device, beam_graph=None))
        obj.outer(1)
        time.sleep(idle_s)
        obj.echo(torch.arange(4.0))
        mirror.close()
        return list(world.entries)
    code = follow(SimpleNamespace(world=world, pipeline=obj,
                                  lane_engine=None))
    return code, list(world.entries)


def raise_on_decode(*args, **kwargs):
    raise RuntimeError("an injected fault on this follower")


def run(spec: dict) -> dict:
    env = multihost.from_env()
    rank = env.rank
    multihost.init_distributed(env.coordinator, env.world_size, rank,
                               device="cpu", timeout_s=spec["timeout_s"])
    results = {}
    try:
        for scenario in spec["scenarios"]:
            name = scenario["name"]
            cfg = Config(**scenario["config"])
            try:
                state = server_app.build_state(
                    cfg, preset=scenario["preset"],
                    warmup=scenario.get("warmup", True),
                    world_timeout_s=spec["timeout_s"])
            except Exception as e:  # noqa: BLE001 — the refusal is the result
                results[name] = {"refused": f"{type(e).__name__}: {e}"}
                continue
            res = {}
            try:
                if rank == 0:
                    res.update(asyncio.run(drive(state, spec["port"],
                                                 scenario, spec)))
                else:
                    if scenario.get("fail_follower"):
                        state.pipeline.decode_samples_batch = raise_on_decode
                    res["exit_code"] = follow(state)
                res["entries"] = list(state.world.entries)
            finally:
                state.close()
            results[name] = res
    finally:
        multihost.leave_world()
    return results


def main() -> None:
    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    for key in ("digits_pcm", "noise_pcm"):
        spec[key] = np.load(spec[key]).tobytes()
    # the cloud probe answers without its metadata request
    platform.detect_cloud = lambda: platform.CloudInfo(provider="unknown")
    rank = int(os.environ["RANK"])
    try:
        out = {"results": run(spec)}
    except Exception:  # noqa: BLE001 — reported to the test
        out = {"error": traceback.format_exc()}
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    # as the server's main does after a failed world: leave at once, so
    # no group's pending wait holds the process
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
