"""Training substrate: optimizers (checkpointing and the trainer come
with a later slice)."""
