"""Training substrate: optimizers, schedules, losses (CE / CTC / MSE), the
paper's GRU train step with QAT, and the training loop."""
