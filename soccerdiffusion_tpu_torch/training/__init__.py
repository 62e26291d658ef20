"""Training: the step and optimizer, metrics, checkpoints and the CLI loop."""
