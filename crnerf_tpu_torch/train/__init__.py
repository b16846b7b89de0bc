"""The training step: losses, metrics, optimizer and schedule, train state,
``make_train_step``."""
