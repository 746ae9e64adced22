"""Parallelism and training (port of parallel/): the device mesh and its
placements, the train step (sharded or not), the sequence-parallel loss,
GPipe, the data side, a bounded world of ranks (``launch.py``), the world
of processes and the placement without collectives (``multihost.py``),
the multi-slice mesh and session router (``multislice.py``), and serving
over a world, rank 0 answering and the other ranks following its device
dispatches (``serve.py``)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, data_sharding, make_mesh,
                   make_param_shardings, param_spec, replicated,
                   shard_params)
from .multihost import (from_env, init_distributed, place_global,
                        run_multihost_smoke)
from .multislice import (SliceRouter, assert_ici_contained,
                         make_multislice_mesh, multislice_grid,
                         slice_groups, slice_of_row)
from .pipeline import (STAGE_AXIS, make_pp_mesh, pipeline_encode,
                       stack_block_params)
from .serve import DispatchMirror, WorldError, follow, mirrored
from .train import (TrainBatch, aed_loss_fn, ctc_loss_fn, init_training,
                    loss_fn, make_optimizer, make_seq_parallel_loss,
                    make_train_step)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "STAGE_AXIS", "make_mesh", "param_spec",
    "make_param_shardings", "data_sharding", "replicated", "shard_params",
    "init_distributed", "from_env", "place_global", "run_multihost_smoke",
    "slice_groups", "multislice_grid", "make_multislice_mesh",
    "assert_ici_contained", "slice_of_row", "SliceRouter",
    "DispatchMirror", "WorldError", "follow", "mirrored",
    "make_pp_mesh", "pipeline_encode", "stack_block_params",
    "TrainBatch", "make_optimizer", "make_train_step", "init_training",
    "loss_fn", "ctc_loss_fn", "aed_loss_fn", "make_seq_parallel_loss",
]
