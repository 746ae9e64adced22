"""Training: the train step, its optimizer and the data side (port of
parallel/). The mesh, pipeline and multi-slice modules are parallelism,
ROADMAP.md queue 1, item 14; the train step refuses a mesh by name."""

from .train import (TrainBatch, aed_loss_fn, ctc_loss_fn, init_training,
                    loss_fn, make_optimizer, make_seq_parallel_loss,
                    make_train_step)

__all__ = [
    "TrainBatch", "make_optimizer", "make_train_step", "init_training",
    "loss_fn", "ctc_loss_fn", "aed_loss_fn", "make_seq_parallel_loss",
]
