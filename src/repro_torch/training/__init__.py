"""Training of the port: data, optimizers, the train loop and checkpoints."""
