"""Training substrate of the port: AdamW, the synthetic LM data pipeline,
checkpoints with the JAX package's key scheme, and the train loop."""
from repro_torch.training.checkpoint import (checkpoint_step,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import (OptimizerConfig, OptState,
                                            adamw_update, global_norm,
                                            init_opt_state, lr_at)
from repro_torch.training.train_loop import (batch_to_device,
                                             loss_and_grads,
                                             make_train_step, train)

__all__ = [
    "DataConfig", "OptState", "OptimizerConfig", "SyntheticLM",
    "adamw_update", "batch_to_device", "checkpoint_step", "global_norm",
    "init_opt_state", "loss_and_grads", "lr_at", "make_train_step",
    "restore_checkpoint", "save_checkpoint", "train",
]
