"""The content term: the mean squared difference of the tap's activations
from the content image's, float64."""

import torch


def term(feat, target):
    return torch.mean((feat.double() - target.double()) ** 2)
