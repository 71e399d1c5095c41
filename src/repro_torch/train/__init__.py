"""Training substrate: optimizers, checkpoints and the fault-tolerant
training loop."""
