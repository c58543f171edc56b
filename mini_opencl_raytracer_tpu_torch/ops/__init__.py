"""Tensor operations of the render path."""
