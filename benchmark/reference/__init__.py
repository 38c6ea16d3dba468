"""The plain reference of the benchmark's configurations, in PyTorch.

It imports neither ``jax``, nor ``style_transfer_tpu``, nor anything of
``style_transfer_tpu_torch``: it takes the run's raw inputs (the weights and
the PIL images from :mod:`benchmark.inputs`) and works out everything else
again: the targets, the loss, the gradient, Adam, the pyramid.
"""

from .model import first_steps, pyramid

__all__ = ["first_steps", "pyramid"]
