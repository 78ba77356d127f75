"""Training substrate: optimizers, schedules, losses (CE / CTC / MSE), the
LM train step (any registry arch, with gradient accumulation and an
optional gradient transform), the paper's GRU train step with QAT, and the
training loop."""
from repro_torch.train.trainer import (LoopHooks, TrainState,
                                       init_train_state, make_gru_train_step,
                                       make_lm_train_step,
                                       make_lm_train_step_fn, train_loop)

__all__ = ["LoopHooks", "TrainState", "init_train_state",
           "make_gru_train_step", "make_lm_train_step",
           "make_lm_train_step_fn", "train_loop"]
