"""The training step and the training loop."""
