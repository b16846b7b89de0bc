"""The weight bridge, checkpoints, metric logging, the PNG writer and the
reference-checkpoint converter."""
