"""PyTorch port: the bounded world of ranks (``parallel/launch.py``), the
multi-device dryrun (``parallel/dryrun.py``, the reference's
``dryrun_multichip`` without its multi-slice part) and the training CLI's
``--mesh`` under torchrun, on the CPU over gloo.

Tolerances: the CLI's weights after two sharded steps within 2 x lr x 2 of
the one-process run's (a sign flip of an Adam update near a zero
gradient, as ``tests/test_torch_train.py``).
"""

import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu_torch import train as cli
from amira_rust_asr_server_tpu_torch.convert import load_npz
from amira_rust_asr_server_tpu_torch.errors import DeviceError
from amira_rust_asr_server_tpu_torch.parallel.dryrun import dryrun_multichip
from amira_rust_asr_server_tpu_torch.parallel.launch import spawn_world

import _torch_parallel_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    """Six checks on an n-rank world: DP x TP step, TP serving, the TP
    lane engine, GPipe, FSDP + sequence parallelism, expert parallelism,
    and on 4 ranks a seventh, the multi-slice mesh; every line of rank 0's
    report says it matched."""
    lines = dryrun_multichip(n, backend="gloo")
    assert len(lines) == 6 + (n >= 4)
    assert ("multislice mesh" in lines[-1]) == (n >= 4)
    assert all(line.startswith(f"dryrun_multichip({n}): ")
               and " OK" in line for line in lines)


def test_dryrun_needs_the_cards_unless_asked_for_the_cpu():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    with pytest.raises(DeviceError, match="backend='gloo'"):
        dryrun_multichip(2)


def test_spawn_world_returns_results_in_rank_order():
    assert spawn_world(ranks.hang, 1, timeout_s=60.0) == [0]


def test_spawn_world_kills_a_hung_rank():
    """Past the deadline the world is torn down: a TimeoutError naming the
    hung rank (rank 0 too, should a loaded machine keep it from starting
    in time) and no rank left alive."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] of 2"):
        spawn_world(ranks.hang, 2, timeout_s=6.0)
    assert time.monotonic() - t0 < 30.0
    assert not multiprocessing.active_children()


def test_spawn_world_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn_world(ranks.fail, 2, timeout_s=60.0)


def test_cli_trains_on_a_mesh_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m amira_rust_asr_server_tpu_torch.
    train --mesh data=2,model=1`` takes two steps and rank 0 writes the
    gathered weights; they equal a one-process run's."""
    args = ["--backend", "cpu", "--synthetic", "--steps", "2", "--batch",
            "2"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "amira_rust_asr_server_tpu_torch.train",
         *args, "--mesh", "data=2,model=1",
         "--ckpt-out", str(tmp_path / "mesh.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh {'data': 2, 'model': 1}" in proc.stdout
    assert cli.main([*args, "--ckpt-out", str(tmp_path / "one.npz")]) == 0
    got, want = load_npz(tmp_path / "mesh.npz"), load_npz(tmp_path / "one.npz")
    assert set(got) == set(want)
    lr = cli.DEFAULTS["synthetic"]["lr"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=2 * lr * 2, err_msg=k)
