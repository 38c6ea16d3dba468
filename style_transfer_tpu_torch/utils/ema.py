"""Bias-corrected exponential moving average of the iterate.

Port of ``style_transfer_tpu/utils/ema.py`` (reference ``EMA`` module):
``value / (1 - accum)`` with ``accum *= decay`` per update, seeded with one
update of a zero state. ``accum`` is a float32 0-d tensor beside ``value``,
and the decay is taken in float32, so both packages round alike.
:func:`ema_update_` is the in-place form the step runners use: it writes
the same values into the state's own tensors.
"""

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["EMAState", "ema_init", "ema_update", "ema_update_", "ema_get"]


class EMAState(NamedTuple):
    value: torch.Tensor
    accum: torch.Tensor  # float32 scalar, product of the decays so far


def ema_init(value, decay: float) -> EMAState:
    """One update applied to a zero state (the reference's __init__)."""
    state = EMAState(
        value=torch.zeros_like(value),
        accum=torch.ones((), dtype=torch.float32, device=value.device),
    )
    return ema_update(state, value, decay)


def ema_update(state: EMAState, value, decay: float) -> EMAState:
    d = np.float32(decay)
    return EMAState(
        value=state.value * float(d) + float(np.float32(1.0) - d) * value,
        accum=state.accum * float(d),
    )


def ema_update_(state: EMAState, value, decay: float) -> EMAState:
    """:func:`ema_update` written into ``state``'s tensors (the same
    rounding); returns ``state``. The decay is a constant, so a CUDA graph
    may capture it."""
    new = ema_update(state, value, decay)
    state.value.copy_(new.value)
    state.accum.copy_(new.accum)
    return state


def ema_get(state: EMAState):
    return state.value / (1.0 - state.accum)
