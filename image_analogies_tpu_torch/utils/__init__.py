"""Host utilities of the PyTorch port: procedural examples and metrics."""

from .metrics import psnr

__all__ = ["psnr"]
