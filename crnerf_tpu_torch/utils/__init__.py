"""The weight bridge, checkpoints, metric logging, the PNG, Lanczos and GIF
codecs and the reference-checkpoint converter."""
