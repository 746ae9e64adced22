"""PyTorch port: the world of processes (``parallel/multihost.py``) and
``dryrun_multihost`` (``parallel/dryrun.py``), on the CPU over gloo.

``dryrun_multihost(2, 2)`` starts 4 OS processes with torchrun's
environment (2 simulated hosts of 2 ranks) that meet at a TCP coordinator
and take one sharded train step (mesh 2 x 2) on the reference's
``PRNGKey(0)`` weights, each placing its own shards (``place_global``);
their loss is held against the JAX package's single-device loss of the
same step (its plain CPU path; the reference's own multi-host test is
slow-marked and not run). ``place_global`` is held against
``shard_params`` bit for bit in a world of 4 ranks
(``tests/_torch_world_ranks.place_global_rank``).

Tolerances: the loss rtol 2e-4 (the reference's); placements and shards
identical.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.parallel import train as jax_train
from amira_rust_asr_server_tpu_torch.errors import DeviceError
from amira_rust_asr_server_tpu_torch.parallel import multihost
from amira_rust_asr_server_tpu_torch.parallel.dryrun import dryrun_multihost
from amira_rust_asr_server_tpu_torch.parallel.launch import spawn_world

import _torch_world_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_step_loss(b: int) -> float:
    """The JAX single-device loss of ``run_multihost_smoke``'s step: tiny
    on ``PRNGKey(0)``, the batch from ``default_rng(0)``."""
    jm = JaxTransducer.from_preset("tiny")
    rng = np.random.default_rng(0)
    n, u = 3200, 4
    batch = jax_train.TrainBatch(
        audio=jnp.asarray((rng.standard_normal((b, n)) * 0.1).astype(
            np.float32)),
        audio_lens=jnp.full((b,), n, jnp.int32),
        labels=jnp.asarray(rng.integers(0, jm.config.blank_id, (b, u)),
                           jnp.int32),
        label_lens=jnp.full((b,), u, jnp.int32))
    params = jm.init(jax.random.PRNGKey(0))
    return float(jax.jit(lambda p: jax_train.loss_fn(jm, p, batch))(params))


def test_dryrun_multihost_2x2_equals_the_jax_loss(capsys):
    """Four processes, two per simulated host: every one prints the same
    loss, which is JAX's single-device loss of the step."""
    loss = dryrun_multihost(2, 2, backend="gloo", timeout_s=240.0)
    out = capsys.readouterr().out
    assert "dryrun_multihost(2x2): loss=" in out and out.endswith("OK\n")
    np.testing.assert_allclose(loss, jax_step_loss(2), rtol=2e-4)


@pytest.fixture(scope="module")
def placed():
    """Every rank's checks of a world of 4 (mesh 2 x 2), by ``fsdp``."""
    return spawn_world(ranks.place_global_rank, 4, timeout_s=180.0)


@pytest.mark.parametrize("fsdp", [False, True])
def test_place_global_equals_shard_params(placed, fsdp):
    """Each rank fills its own shards from its own host values, with the
    placements and the bits ``shard_params`` gives; on host values that
    differ by rank each keeps its own (nothing comes from rank 0)."""
    for rank in placed:
        differ, sharded, own = rank[fsdp]
        assert differ == [] and own == []
        assert sharded > 10


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_joins_once_and_refuses_another_world():
    """A one-process world over TCP: joining it again is a no-op, joining
    another world raises naming both, and the store is the world's."""
    code = (
        "from amira_rust_asr_server_tpu_torch.parallel import multihost\n"
        f"c = '127.0.0.1:{free_port()}'\n"
        "assert multihost.init_distributed(c, 1, 0, device='cpu')\n"
        "assert not multihost.init_distributed(c, 1, 0, device='cpu')\n"
        "assert multihost.world_store() is not None\n"
        "for args in ((c, 2, 0), ('127.0.0.1:1', 1, 0)):\n"
        "    try:\n"
        "        multihost.init_distributed(*args, device='cpu')\n"
        "        raise SystemExit('joined another world')\n"
        "    except RuntimeError as e:\n"
        "        assert 'rank 0 of a world of 1' in str(e), e\n"
        "multihost.leave_world()\n"
        "assert multihost.world_store() is None\n"
        "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


def test_from_env_reads_torchrun():
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
           "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "10.0.0.2",
           "MASTER_PORT": "1234"}
    assert multihost.from_env(env) == multihost.WorldEnv(
        rank=3, world_size=4, local_rank=1, local_world_size=2,
        coordinator="10.0.0.2:1234")
    assert multihost.from_env({}) is None


def test_nccl_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(DeviceError, match="device='cpu'"):
        multihost.init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    with pytest.raises(DeviceError, match="backend='gloo'"):
        dryrun_multihost(1, 1)
