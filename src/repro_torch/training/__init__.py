"""Training substrate of the port: optimizers, train step, checkpointing,
data (single device; the sharded step needs ``dist``, ROADMAP item 8)."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .data import DataConfig, batch_iterator, make_batch
from .optimizer import (OptimizerConfig, adafactor_init, adafactor_update,
                        adamw_init, adamw_update, global_norm, lr_at,
                        opt_init, opt_update)
from .train_step import TrainConfig, init_train_state, make_train_step
