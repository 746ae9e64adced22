"""PyTorch port: the CPU-affinity plan (``utils/affinity.py``) against the
JAX package's, and its wiring into the port's AppState and server.

The cases of tests/test_affinity.py run against the port's copy (real
sched_get/setaffinity on this host, a synthetic sysfs tree for the
multi-node cases); both packages must give the same plan over one fake
sysfs/cgroup tree.
"""

import asyncio
import concurrent.futures
import os

import pytest

from amira_rust_asr_server_tpu.utils import affinity as jax_affinity
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.server import AppState, app as app_mod
from amira_rust_asr_server_tpu_torch.utils import affinity
from amira_rust_asr_server_tpu_torch.utils.affinity import (
    AffinityPlan, CpuTopology, NumaNode, ThreadType, make_initializer,
    parse_cpulist, recommended_allocation_size, set_thread_affinity)
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary


def test_parse_cpulist():
    assert parse_cpulist("0-3,8,10-11") == (0, 1, 2, 3, 8, 10, 11)
    assert parse_cpulist("5") == (5,)
    assert parse_cpulist("") == ()
    assert parse_cpulist("2-2") == (2,)


def _fake_sysfs(tmp_path, node_cpulists):
    for node_id, cpulist in node_cpulists.items():
        d = tmp_path / "devices/system/node" / f"node{node_id}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(cpulist + "\n")
    return str(tmp_path)


def test_topology_detect_from_sysfs(tmp_path, monkeypatch):
    root = _fake_sysfs(tmp_path, {0: "0-3", 1: "4-7"})
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(8)), raising=False)
    topo = CpuTopology.detect(sysfs_root=root)
    assert [n.node_id for n in topo.nodes] == [0, 1]
    assert topo.nodes[0].cores == (0, 1, 2, 3)
    assert topo.nodes[1].cores == (4, 5, 6, 7)
    assert topo.available == tuple(range(8))


def test_topology_respects_cgroup_cpuset(tmp_path, monkeypatch):
    """Cores outside sched_getaffinity (a container's cpuset) are dropped;
    empty nodes disappear."""
    root = _fake_sysfs(tmp_path, {0: "0-3", 1: "4-7"})
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: {1, 2}, raising=False)
    topo = CpuTopology.detect(sysfs_root=root)
    assert len(topo.nodes) == 1
    assert topo.nodes[0].cores == (1, 2)


def test_topology_no_sysfs_falls_back_to_single_node(tmp_path, monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: {0, 1}, raising=False)
    topo = CpuTopology.detect(sysfs_root=str(tmp_path / "nope"))
    assert topo.nodes == (NumaNode(0, (0, 1)),)


def test_plan_disabled_on_small_host():
    topo = CpuTopology(nodes=(NumaNode(0, (0,)),), available=(0,))
    plan = AffinityPlan.plan(topo)
    assert not plan.enabled
    assert "too small" in plan.reason
    assert make_initializer(plan, ThreadType.DISPATCH) is None
    assert plan.cores_for(ThreadType.SESSION) == ()


def test_plan_partitions_big_host():
    topo = CpuTopology(nodes=(NumaNode(0, (0, 1, 2, 3)),
                              NumaNode(1, (4, 5, 6, 7))),
                       available=tuple(range(8)))
    plan = AffinityPlan.plan(topo)
    assert plan.enabled
    io = plan.cores_for(ThreadType.IO)
    disp = plan.cores_for(ThreadType.DISPATCH)
    sess = plan.cores_for(ThreadType.SESSION)
    assert len(io) == 1 and len(disp) == 1
    assert not (set(io) | set(disp)) & set(sess)
    assert set(io) | set(disp) | set(sess) == set(range(8))
    # the feeder sits on the first node, off the IRQ core
    assert disp[0] in topo.nodes[0].cores and disp[0] != io[0]
    assert plan.cores_for(ThreadType.BACKGROUND) == sess


@pytest.mark.parametrize("nodes, allowed", [
    ({0: "0-3", 1: "4-7"}, set(range(8))),
    ({0: "0-3", 1: "4-7"}, {2, 3, 5, 6, 7}),
    ({0: "0-1", 1: "2-9"}, {0, 1, 2, 3, 4}),
    ({0: "0-7"}, {0, 1, 2}),
    ({}, {4, 5, 6, 7, 8, 9})])
def test_plan_equals_jax_plan(tmp_path, monkeypatch, nodes, allowed):
    """One fake sysfs tree and cgroup cpuset: the two packages detect the
    same topology and make the same plan."""
    root = _fake_sysfs(tmp_path, nodes)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(allowed),
                        raising=False)
    got = AffinityPlan.plan(CpuTopology.detect(sysfs_root=root))
    want = jax_affinity.AffinityPlan.plan(
        jax_affinity.CpuTopology.detect(sysfs_root=root))
    assert (got.enabled, got.reason) == (want.enabled, want.reason)
    assert {t.value: c for t, c in got.assignments.items()} == \
        {t.value: c for t, c in want.assignments.items()}
    assert got.to_log()["assignments"] == {
        t.value: list(c) for t, c in want.assignments.items()}


def test_set_thread_affinity_roundtrip():
    if not hasattr(os, "sched_getaffinity"):
        pytest.skip("no sched_getaffinity on this platform")
    before = os.sched_getaffinity(0)
    try:
        core = min(before)
        assert set_thread_affinity((core,))
        assert os.sched_getaffinity(0) == {core}
    finally:
        os.sched_setaffinity(0, before)


def test_set_thread_affinity_invalid_core_returns_false():
    assert set_thread_affinity((99999,)) is False
    assert set_thread_affinity(()) is False


def test_executor_initializer_pins_workers():
    if not hasattr(os, "sched_getaffinity"):
        pytest.skip("no sched_getaffinity on this platform")
    core = min(os.sched_getaffinity(0))
    plan = AffinityPlan(True, "test", {ThreadType.DISPATCH: (core,)})
    init = make_initializer(plan, ThreadType.DISPATCH)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=1, initializer=init) as ex:
        got = ex.submit(lambda: os.sched_getaffinity(0)).result()
    assert got == {core}


def test_recommended_allocation_size(tmp_path):
    thp = tmp_path / "kernel/mm/transparent_hugepage"
    thp.mkdir(parents=True)
    (thp / "enabled").write_text("always [madvise] never\n")
    root = str(tmp_path)
    huge = 2 * 1024 * 1024
    assert recommended_allocation_size(huge + 1, root) == 2 * huge
    assert recommended_allocation_size(huge, root) == huge
    assert recommended_allocation_size(100, root) == 4096
    (thp / "enabled").write_text("always madvise [never]\n")
    assert recommended_allocation_size(huge + 1, root) == huge + 4096
    assert recommended_allocation_size(8192, str(tmp_path / "x")) == 8192
    for n in (1, 4096, huge - 1, huge + 1, 3 * huge + 5):
        assert recommended_allocation_size(n, root) == \
            jax_affinity.recommended_allocation_size(n, root)


def tiny_pipeline(**overrides):
    import torch
    model = Transducer.from_preset("tiny").init_weights(
        torch.Generator().manual_seed(0))
    vocab = Vocabulary.from_map({i: f"w{i}" for i in range(15)})
    cfg = Config(**{**dict(warmup_on_start=False, audio_sec_buckets=[0.5],
                           batch_buckets=[1], compute_dtype="float32",
                           inference_backend="cpu"), **overrides})
    return AsrPipeline(model, vocab, cfg), vocab, cfg


def test_appstate_wires_affinity_plan():
    """enable_cpu_affinity=True makes a plan at AppState init (whatever this
    host gives, recorded with its reason); off, there is none."""
    pipe, vocab, cfg = tiny_pipeline(enable_cpu_affinity=True)
    state = AppState(pipe, vocab, cfg)
    try:
        assert state.affinity_plan is not None
        assert isinstance(state.affinity_plan.enabled, bool)
        assert state.affinity_plan.reason
    finally:
        state.close()
    pipe_off, vocab, cfg_off = tiny_pipeline()
    state_off = AppState(pipe_off, vocab, cfg_off)
    try:
        assert state_off.affinity_plan is None
    finally:
        state_off.close()
    # the platform switch gates it too, as in the reference
    pipe, vocab, cfg = tiny_pipeline(enable_cpu_affinity=True,
                                     enable_platform_optimizations=False)
    state = AppState(pipe, vocab, cfg)
    try:
        assert state.affinity_plan is None
    finally:
        state.close()


def test_plan_pins_dispatch_sessions_and_event_loop(monkeypatch):
    """An enabled plan: the dispatch and session threads start pinned to
    their cores, and run_server pins the event loop's thread to the IO
    cores."""
    if not hasattr(os, "sched_getaffinity"):
        pytest.skip("no sched_getaffinity on this platform")
    before = os.sched_getaffinity(0)
    core = min(before)
    plan = AffinityPlan(True, "test", {t: (core,) for t in ThreadType})
    monkeypatch.setattr(AffinityPlan, "plan", classmethod(lambda cls: plan))
    pinned = []
    monkeypatch.setattr(app_mod, "set_thread_affinity",
                        lambda cores: pinned.append(cores) or True)
    pipe, vocab, cfg = tiny_pipeline(enable_cpu_affinity=True)
    state = AppState(pipe, vocab, cfg)
    try:
        assert state.affinity_plan is plan
        for ex in (state.inference_executor, state.session_executor):
            assert ex.submit(lambda: os.sched_getaffinity(0)).result() == \
                {core}
        # no process signal handlers from a test
        monkeypatch.setattr(state.shutdown, "install_signal_handlers",
                            lambda: None)
        state.shutdown.trigger()
        asyncio.run(app_mod.run_server(state, "127.0.0.1", 0))
        assert pinned == [(core,)]
    finally:
        os.sched_setaffinity(0, before)
        state.close()


def test_port_copy_keeps_the_reference_surface():
    names = ["ThreadType", "parse_cpulist", "NumaNode", "CpuTopology",
             "AffinityPlan", "set_thread_affinity", "make_initializer",
             "recommended_allocation_size"]
    for name in names:
        assert hasattr(affinity, name) and hasattr(jax_affinity, name)
    assert [t.value for t in ThreadType] == \
        [t.value for t in jax_affinity.ThreadType]
    assert AffinityPlan.MIN_CORES == jax_affinity.AffinityPlan.MIN_CORES
