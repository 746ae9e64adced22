"""PyTorch port: the multi-slice mesh and the session router
(``parallel/multislice.py``), the cases of ``tests/test_multislice.py``.

A TPU slice's counterpart on GPUs is an NVLink domain (one host). The
placement cases run on rank grids with simulated slice boundaries
(``n_slices``, the reference's hook), over 8 ranks in 2 slices as the
reference's 8 virtual devices; the numerical cases run in a world of 4
ranks over gloo (2 slices x tensor parallelism 2, ``launch.spawn_world``;
the ranks run ``tests/_torch_world_ranks.multislice_rank``) and are held
against the JAX package's single-device math on the same ``PRNGKey``
weights (the reference's plain CPU path).

Tolerances: the tensor-parallel encoder atol 2e-4 / rtol 1e-3 (the
reference's), the train step's loss rtol 2e-4 (the reference's).
"""

import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.parallel import train as jax_train
from amira_rust_asr_server_tpu_torch.parallel.launch import spawn_world
from amira_rust_asr_server_tpu_torch.parallel.multislice import (
    SliceRouter, assert_ici_contained, multislice_grid, slice_groups,
    slice_of_row)

import _torch_world_ranks as ranks

RANKS = range(8)


def grid_mesh(grid):
    """What the checks read of a ``DeviceMesh``: its rank grid and axis
    names (no world needed)."""
    return SimpleNamespace(mesh=torch.as_tensor(np.asarray(grid)),
                           mesh_dim_names=("data", "model"))


# -- placement invariants ---------------------------------------------------

def test_mesh_rows_stay_inside_slices():
    groups = slice_groups(n_slices=2, ranks=RANKS)
    grid = multislice_grid(2, groups)
    assert grid.shape == (4, 2)
    assert_ici_contained(grid_mesh(grid), groups)
    # contiguous slice blocks along the data axis: rows 0-1 slice 0,
    # rows 2-3 slice 1 (the router's placement table)
    assert slice_of_row(grid_mesh(grid), groups) == [0, 0, 1, 1]


def test_mesh_full_slice_tp():
    groups = slice_groups(n_slices=2, ranks=RANKS)
    grid = multislice_grid(4, groups)
    assert grid.shape == (2, 4)
    assert_ici_contained(grid_mesh(grid), groups)
    assert slice_of_row(grid_mesh(grid), groups) == [0, 1]


def test_mesh_rejects_bad_factorizations():
    with pytest.raises(ValueError):
        multislice_grid(3, slice_groups(n_slices=2, ranks=RANKS))  # 4 % 3
    with pytest.raises(ValueError):
        slice_groups(n_slices=3, ranks=RANKS)                      # 8 % 3
    with pytest.raises(ValueError, match="expected"):
        assert_ici_contained(SimpleNamespace(
            mesh=torch.zeros(2, 2), mesh_dim_names=("model", "data")),
            [[0, 1]])


def test_ici_containment_catches_bad_placement():
    """A hand-built mesh whose TP row straddles the simulated slice
    boundary must be rejected: the invariant is load-bearing."""
    groups = [[0, 1, 2, 3], [4, 5, 6, 7]]
    # row 1 pairs a slice-0 rank with a slice-1 rank
    order = [0, 1, 3, 4, 2, 5, 6, 7]
    bad = np.asarray(order).reshape(4, 2)
    with pytest.raises(AssertionError, match="crosses slices"):
        assert_ici_contained(grid_mesh(bad), groups)


def test_slices_follow_the_hosts(monkeypatch):
    """Without ``n_slices`` the groups are torchrun's hosts: blocks of
    ``LOCAL_WORLD_SIZE`` ranks."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert slice_groups(ranks=RANKS) == [[0, 1, 2, 3], [4, 5, 6, 7]]


# -- numerics ride the existing helpers unchanged ---------------------------

@pytest.fixture(scope="module")
def multislice_world():
    """The JAX side's inputs and results, and the 4 ranks' results."""
    rng = np.random.default_rng(3)
    jm = JaxTransducer.from_preset("tiny")
    feats = rng.standard_normal((4, jm.config.n_mels, 32)).astype(
        np.float32)
    lens = np.array([32, 20, 28, 16], np.int32)
    rng = np.random.default_rng(0)
    b, n, u = 4, 3200, 4
    batch = ((rng.standard_normal((b, n)) * 0.1).astype(np.float32),
             np.array([n, n - 800, n, n - 400], np.int32),
             rng.integers(0, jm.config.blank_id, (b, u)).astype(np.int32),
             np.array([u, 2, u, 3], np.int32))
    params0 = jm.init(jax.random.PRNGKey(0))
    enc_ref, lens_ref = jm.encode(params0, jnp.asarray(feats),
                                  jnp.asarray(lens))
    params1 = jm.init(jax.random.PRNGKey(1))
    loss_ref = float(jax.jit(lambda p, bt: jax_train.loss_fn(jm, p, bt))(
        params1, jax_train.TrainBatch(*(jnp.asarray(x) for x in batch))))
    got = spawn_world(ranks.multislice_rank, 4, timeout_s=240.0,
                      args=(feats, lens, batch))
    return (np.asarray(enc_ref), np.asarray(lens_ref), loss_ref), got


def test_multislice_mesh_over_a_world(multislice_world):
    _, got = multislice_world
    for r in got:
        assert r["shape"] == (2, 2)
        assert r["grid"] == [[0, 1], [2, 3]]
        assert r["rows"] == [0, 1]


def test_tp_forward_matches_single_on_multislice_mesh(multislice_world):
    (enc_ref, lens_ref, _), got = multislice_world
    for r in got:
        np.testing.assert_array_equal(r["enc_lens"], lens_ref)
        np.testing.assert_allclose(r["enc"], enc_ref, atol=2e-4, rtol=1e-3)


def test_train_step_matches_single_on_multislice_mesh(multislice_world):
    """dp-across-slices x tp-within-slice training step: only the grad
    all-reduce crosses the simulated slice boundary; the loss equals the
    JAX single-device loss, on every rank."""
    (_, _, loss_ref), got = multislice_world
    for r in got:
        np.testing.assert_allclose(r["loss"], loss_ref, rtol=2e-4)


# -- session routing --------------------------------------------------------

def test_router_least_loaded_and_sticky():
    r = SliceRouter(n_slices=2, lanes_per_slice=2)
    assert r.assign("a") == 0
    assert r.assign("b") == 1        # least-loaded, not round-robin luck
    assert r.assign("c") == 0
    assert r.assign("a") == 0        # sticky re-assign is a no-op
    assert r.to_dict()["load"] == [2, 1]
    r.release("a")
    assert r.to_dict()["load"] == [1, 1]


def test_router_sheds_at_capacity():
    r = SliceRouter(n_slices=2, lanes_per_slice=1)
    assert r.assign("a") is not None
    assert r.assign("b") is not None
    assert r.assign("c") is None     # 503-shed upstream
    r.release("b")
    assert r.assign("c") is not None


def test_router_concurrent_assign_release():
    """More threads than cores, a short switch interval: no lost update
    of the load table."""
    import sys
    r = SliceRouter(n_slices=4, lanes_per_slice=64)

    misses = []

    def churn(tag):
        for i in range(200):
            sid = f"{tag}-{i}"
            if r.assign(sid) is None:  # 16 live at most, 256 lanes
                misses.append(sid)
            r.release(sid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    d = r.to_dict()
    assert not misses
    assert d["load"] == [0, 0, 0, 0] and d["sessions"] == 0


def test_router_rejects_bad_sizes():
    with pytest.raises(ValueError):
        SliceRouter(n_slices=0, lanes_per_slice=1)
    with pytest.raises(ValueError):
        SliceRouter(n_slices=1, lanes_per_slice=0)
