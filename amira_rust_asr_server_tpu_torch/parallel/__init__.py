"""Parallelism and training (port of parallel/): the device mesh and its
placements, the train step (sharded or not), the sequence-parallel loss,
GPipe, the data side and a bounded world of ranks (``launch.py``). The
multi-host and multi-slice modules wait for multi-process serving
(ROADMAP.md queue 1, item 17)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, data_sharding, make_mesh,
                   make_param_shardings, param_spec, replicated,
                   shard_params)
from .pipeline import (STAGE_AXIS, make_pp_mesh, pipeline_encode,
                       stack_block_params)
from .train import (TrainBatch, aed_loss_fn, ctc_loss_fn, init_training,
                    loss_fn, make_optimizer, make_seq_parallel_loss,
                    make_train_step)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "STAGE_AXIS", "make_mesh", "param_spec",
    "make_param_shardings", "data_sharding", "replicated", "shard_params",
    "make_pp_mesh", "pipeline_encode", "stack_block_params",
    "TrainBatch", "make_optimizer", "make_train_step", "init_training",
    "loss_fn", "ctc_loss_fn", "aed_loss_fn", "make_seq_parallel_loss",
]
