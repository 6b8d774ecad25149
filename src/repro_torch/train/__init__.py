from repro_torch.train.step import (make_eval_step, make_loss_fn,
                                    make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["make_train_step", "make_eval_step", "make_loss_fn", "Trainer",
           "TrainerConfig"]
