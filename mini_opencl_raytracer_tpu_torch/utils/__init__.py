"""Utilities: image files, checkpoints, timing and metrics, error
decoding, the build directories."""
