from repro_torch.train import checkpoint
from repro_torch.train.step import (init_train_state, loss_and_grads,
                                    make_train_step)

__all__ = ["checkpoint", "init_train_state", "loss_and_grads",
           "make_train_step"]
