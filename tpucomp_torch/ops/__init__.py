"""Tensor ops of the port: :mod:`.match` (torch ops) and :mod:`.cuda` (kernels)."""
