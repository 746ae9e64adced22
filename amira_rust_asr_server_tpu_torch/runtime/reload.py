"""Live checkpoint reload: the model repository served in-process (port of
runtime/reload.py).

The reference's deploy target manages models through Triton's repository
API; this server swaps serving weights without a restart and without
dropping connections, behind ``GET|POST /v2/repository/index`` and
``POST /v2/repository/models/{name}/load`` (``server/app.py``).

**How a name resolves.** The port reads converted ``.npz`` state dicts
only (``tools/export_torch_params.py``), while the repository's pointers
name orbax trees. ``name`` resolves, in order, to

1. ``<repo>/<name>.npz``;
2. the pointer ``<repo>/<name>.json``: its ``checkpoint`` names an ``.npz``,
   or an orbax tree whose converted sibling ``<tree>.npz`` exists (paths
   relative to the working directory, then to the repository's parent, as
   the reference resolves them);
3. anything else is a 404, which names the converter when an orbax tree
   is on disk: ``python tools/export_torch_params.py --checkpoint <tree>
   --out <tree>.npz``.

:func:`repository_index` keeps the reference's rows and its invariant: it
never lists as ``AVAILABLE`` what a load would refuse, so an unconverted
orbax tree reads ``UNAVAILABLE``. A pointer whose ``family`` is not the
served family is a 422.

**How a swap reaches the captured programs.** The reference swaps weights
without recompiling because its parameters are jit arguments. The port's
bucket programs, lane engine, chunk programs and step loops are CUDA
graphs that read the parameters, and every table derived from them, at
fixed device addresses. So a swap never rebinds a tensor: the new weights
are staged on the device off the dispatch thread
(``convert.stage_checkpoint``: strict keys and shapes, the serving dtype),
then, on the dispatch thread under the device lock, copied into the
parameters, and every derived table is recomputed in place
(``AsrPipeline.swap_weights``, ``StreamingLaneEngine.refresh_``). No
program is dropped or captured again.

A reload while native lanes are live is refused (409), as in the
reference: "drain streams, then reload". Solo native sessions and
streaming beam sessions keep carries computed on the old weights across a
reload, as the reference's do (it gates only lanes).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

import numpy as np

from ..convert import CheckpointMismatchError, stage_checkpoint
from ..errors import AppError
from ..reliability import get_logger

log = get_logger("asr.reload")

CONVERTER = "tools/export_torch_params.py"


class ModelRepositoryError(AppError):
    """Unknown model name / no checkpoint the port can read."""
    http_status = 404
    code = "model_not_found"


class ReloadConflictError(AppError):
    """Reload refused because serving state pins the current weights
    (live native-streaming lanes, or another reload in flight)."""
    http_status = 409
    code = "reload_conflict"


# ---------------------------------------------------------------------------
# repository index
# ---------------------------------------------------------------------------
def _read_pointer(path: str) -> Optional[dict]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def _pointer_files(repo_dir: str):
    try:
        names = sorted(os.listdir(repo_dir))
    except OSError:
        return
    for fn in names:
        if not fn.endswith(".json"):
            continue
        doc = _read_pointer(os.path.join(repo_dir, fn))
        # a model pointer names its checkpoint; anything else (vocab
        # manifests, eval artifacts) is not a loadable model
        if doc is not None and "checkpoint" in doc:
            yield fn[:-len(".json")], doc


def _candidates(repo_dir: str, ckpt: str):
    """A pointer's ``checkpoint`` relative to the working directory, then
    to the repository's parent."""
    return (ckpt, os.path.join(os.path.dirname(repo_dir) or ".", ckpt))


def _checkpoint_npz(repo_dir: str, ckpt: str) -> Optional[str]:
    """The ``.npz`` a pointer's ``checkpoint`` resolves to: itself when it
    names one, else the converted sibling ``<tree>.npz`` of an orbax
    tree; None when there is none on disk."""
    for path in _candidates(repo_dir, ckpt):
        npz = path if path.endswith(".npz") else path.rstrip("/") + ".npz"
        if os.path.isfile(npz):
            return npz
    return None


def _is_orbax_tree(path: str) -> bool:
    # an orbax tree carries its own metadata marker files
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "manifest.ocdbt")))


def _convert_hint(tree: str) -> str:
    return (f"{tree!r} is an orbax tree, which the port does not read; "
            f"convert it: python {CONVERTER} --checkpoint {tree} --out "
            f"{tree.rstrip('/')}.npz (with its --family and --preset)")


def _valid_name(name: str) -> None:
    if os.sep in name or name.startswith("."):
        raise ModelRepositoryError(f"invalid model name {name!r}")


def resolve_checkpoint(repo_dir: str, name: str) -> str:
    """Map a repository model name to the ``.npz`` it loads (the module's
    docstring gives the order); raises :class:`ModelRepositoryError`."""
    _valid_name(name)
    direct = os.path.join(repo_dir, name + ".npz")
    if os.path.isfile(direct):
        return direct
    ptr = os.path.join(repo_dir, name + ".json")
    if os.path.isfile(ptr):
        ckpt = (_read_pointer(ptr) or {}).get("checkpoint")
        if not ckpt:
            raise ModelRepositoryError(
                f"pointer {ptr} has no 'checkpoint' field")
        npz = _checkpoint_npz(repo_dir, ckpt)
        if npz is not None:
            return npz
        trees = [p for p in _candidates(repo_dir, ckpt) if os.path.isdir(p)]
        if trees:
            raise ModelRepositoryError(f"model {name!r}: "
                                       + _convert_hint(trees[0]))
        raise ModelRepositoryError(
            f"model {name!r}: checkpoint {ckpt!r} not on disk (gitignored "
            f"trees do not survive VM re-creates; retrain or restore, then "
            f"convert with {CONVERTER})")
    tree = os.path.join(repo_dir, name)
    if os.path.isdir(tree):
        raise ModelRepositoryError(f"model {name!r}: " + _convert_hint(tree))
    raise ModelRepositoryError(f"model {name!r} not in repository "
                               f"{repo_dir!r}")


def _pointer_family(repo_dir: str, name: str) -> Optional[str]:
    """The ``family`` of ``name``'s pointer, if it has one."""
    doc = _read_pointer(os.path.join(repo_dir, name + ".json"))
    return (doc or {}).get("family")


def repository_index(repo_dir: str, loaded: Optional[dict] = None) -> list:
    """The reference's repository listing (name/preset/checkpoint/state
    rows and the pointers' quality fields): every pointer, then every
    orbax tree and ``.npz`` in the repository that no pointer names. A row
    is ``AVAILABLE`` only when :func:`resolve_checkpoint` finds an ``.npz``
    for it."""
    loaded_name = (loaded or {}).get("name")

    def state(name: str, available: bool) -> str:
        return ("READY" if name == loaded_name
                else "AVAILABLE" if available else "UNAVAILABLE")

    rows, pointed = [], set()
    for name, doc in _pointer_files(repo_dir) or ():
        ckpt = doc.get("checkpoint", "")
        npz = _checkpoint_npz(repo_dir, ckpt) if ckpt else None
        pointed.update(os.path.normpath(p) for p in (ckpt, npz) if p)
        row = {"name": name, "preset": doc.get("preset"),
               "checkpoint": ckpt, "state": state(name, npz is not None)}
        for k in ("held_out_exact_match", "held_out_token_error_rate",
                  "steps", "family"):
            if k in doc:
                row[k] = doc[k]
        rows.append(row)
    try:
        entries = sorted(os.listdir(repo_dir))
    except OSError:
        entries = []
    pointers = {r["name"] for r in rows}
    trees = {fn for fn in entries
             if _is_orbax_tree(os.path.join(repo_dir, fn))}
    for fn in entries:
        path = os.path.join(repo_dir, fn)
        if os.path.normpath(path) in pointed or fn in pointers:
            continue
        if fn in trees:
            name, available = fn, os.path.isfile(path + ".npz")
        elif fn.endswith(".npz") and fn[:-4] not in pointers | trees:
            name, available = fn[:-4], True
        else:
            continue
        rows.append({"name": name, "preset": None, "checkpoint": path,
                     "state": state(name, available)})
    return rows


# ---------------------------------------------------------------------------
# the swap
# ---------------------------------------------------------------------------
def _swap(state, install: Callable[[], None],
          refuse_live: bool = True) -> float:
    """Runs ON the dispatch thread: ``install()`` (the pipeline's
    ``swap_weights`` or ``rollback_weights``: new tensors into its
    parameters and every derived table in place), then the lane engine's
    refresh, behind the lane lock (no stream attaches meanwhile); a live
    lane refuses it (409) unless ``refuse_live`` is off (the rollback).
    Returns the seconds the dispatch thread spent."""
    t0 = time.perf_counter()
    eng = state.lane_engine
    with (state.lane_lock if eng is not None else contextlib.nullcontext()):
        if refuse_live and eng is not None and eng.live_lanes > 0:
            raise ReloadConflictError(
                "stream attached during reload; drain and retry")
        install()
        if eng is not None:
            eng.refresh_()
    return time.perf_counter() - t0


def _smoke_decode(pipeline) -> None:
    """One tiny decode through the serving path on whatever weights are
    installed: raises if they cannot serve."""
    n = int(0.25 * 16000)
    tone = (0.1 * np.sin(2 * np.pi * 440.0 *
                         np.arange(n) / 16000.0)).astype(np.float32)
    pipeline.process_batch_samples(tone)


def hot_swap(state, name: str, validate: bool = False) -> dict:
    """Load ``name`` from the repository and swap it into serving (called
    from a session-executor thread, never the event loop):

    1. resolve, read, check and stage on the device (old weights keep
       serving; a mismatch is a 422 with nothing touched);
    2. refuse while native lanes are live (409);
    3. copy in place on the dispatch thread (atomic with respect to every
       dispatch);
    4. with ``validate``, a 0.25 s tone canary; on any failure the old
       tensors, kept until then, are copied back and the error is a 422.

    In a serving world (``parallel/serve.py``) the swap, the canary and
    the rollback are device entries every rank runs: each rank stages the
    checkpoint from the same path itself, copies its own shards, and
    keeps its own old shards for the rollback.

    In-flight batch requests finish on whichever weights their dispatch
    picked up, as a Triton reload gives. The phases' ms (prepare, swap,
    canary) go to the metrics (``last_reload_ms``)."""
    if not state.reload_lock.acquire(blocking=False):
        raise ReloadConflictError("another reload is in flight")
    try:
        t0 = time.perf_counter()
        repo = state.config.model_repo_path
        ckpt = resolve_checkpoint(repo, name)
        family = _pointer_family(repo, name)
        if family is not None and family != state.config.model_family:
            raise CheckpointMismatchError(
                f"model {name!r} is a {family} checkpoint; this server "
                f"serves the {state.config.model_family} family")
        eng = state.lane_engine
        if eng is not None and eng.live_lanes > 0:
            raise ReloadConflictError(
                f"{eng.live_lanes} native streaming lane(s) live; drain "
                f"streams before reloading")
        pipe = state.pipeline
        staged = stage_checkpoint(pipe.model, ckpt, pipe.device_lock)
        t1 = time.perf_counter()
        stall = state.inference_executor.submit(
            _swap, state, lambda: pipe.swap_weights(
                staged, source=os.path.abspath(ckpt),
                keep_old=validate)).result()
        del staged
        t2 = time.perf_counter()
        if validate:
            # the canary: one decode on the new weights; on ANY failure the
            # old tensors, kept by the swap, go back in and the error
            # surfaces (Triton offers nothing equivalent)
            try:
                state.inference_executor.submit(_smoke_decode, pipe).result()
            except Exception as e:
                state.inference_executor.submit(
                    _swap, state, pipe.rollback_weights, False).result()
                raise CheckpointMismatchError(
                    f"validation decode failed on {name!r}; rolled back "
                    f"to previous weights: {e}") from e
            state.inference_executor.submit(pipe.drop_old_weights).result()
        t3 = time.perf_counter()
        info = {"name": name, "checkpoint": ckpt,
                "swap_ms": round((t3 - t0) * 1e3, 1), "ts": time.time(),
                "validated": bool(validate)}
        state.loaded_model = info
        phases = {"prepare": (t1 - t0) * 1e3, "swap": stall * 1e3,
                  "canary": (t3 - t2) * 1e3}
        state.metrics.record_model_reload(name, phases)
        if state.prometheus is not None:
            state.prometheus.model_reloads.inc()
        log.info("reload: now serving %s (%s): prepare %.1f ms, swap "
                 "%.1f ms, canary %.1f ms", name, ckpt, phases["prepare"],
                 phases["swap"], phases["canary"])
        return info
    finally:
        state.reload_lock.release()
