"""Training: sharded train-step builder, trainer loop, data pipeline.

The reference has no training path at all — ``enable_checkpointing`` is a
config flag that nothing reads (reference core/autonomous_optimizer.py:354)
and no optimizer step exists anywhere. A complete framework needs one, so
this package provides the training tier: pjit-sharded train
steps over a (data, model) mesh, gradient accumulation via ``lax.scan``,
rematerialized (checkpointed) blocks, loss-scale-free bf16 master-weight
mixed precision, and a host-side prefetching data pipeline.
"""

from .data import DataPipeline, synthetic_lm_batches
from .trainer import Trainer, TrainState, make_train_step

__all__ = [
    "DataPipeline",
    "Trainer",
    "TrainState",
    "make_train_step",
    "synthetic_lm_batches",
]
