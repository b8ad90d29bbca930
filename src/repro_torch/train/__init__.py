"""The training plane of the port: train and serve steps, checkpoints
and the training loop."""
