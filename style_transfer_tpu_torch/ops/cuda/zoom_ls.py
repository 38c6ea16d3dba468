"""The zoom line search's state machine on the device: one step per trial.

optax 0.2.6's ``zoom_linesearch`` (the interval search and zoom of Nocedal
and Wright's Algorithms 3.5 and 3.6, with Hager and Zhang's approximate
decrease criterion; ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')``) runs on the TPU inside the JAX runner's
compiled chunk as a ``lax.while_loop``. Here its scalars live in one
float32 vector on the iterate's device (``LS_FIELDS``) and a bool ``go``:

* :func:`ls_init` makes the state from the value and slope at the iterate,
  with the first trial's step size (1) and ``go`` True;
* :func:`ls_step_` takes the trial just run at ``state[STEPSIZE]`` (its
  value and slope along the direction) into the state, in place: the
  trial's decisions, then either the next trial's step size or, once the
  search is done or has failed, the final step (the safe step where the
  rule asks for it), and ``go = not (done or failed)``.

A CPU tensor takes :func:`ls_step_plain_`, ``torch`` ops on 0-d float32
tensors with every branch a ``torch.where``; a CUDA tensor launches the
kernel ``stt_zls_step`` (``csrc/zoom_ls.cu``, one thread, one launch per
trial) or raises. The kernel is not the port of a TPU kernel: it replaces
the plain version's scalar launches (one per ATen op: every ``where``,
product and comparison) in each trial of the zoom runner's CUDA graphs. It equals the plain version bit for bit (NaN
payloads aside): both round every operation once in float32, in optax's
order, and take numpy's ``minimum``/``maximum`` (a NaN operand gives NaN;
of two equal values the second), which the port's float32 transcription
of optax used. ``ls_step_.launches`` counts the kernel's launches.
"""

import contextlib

import numpy as np
import torch

from . import build
from .ns_sqrtm import _capability

__all__ = ["LS_FIELDS", "STEPSIZE", "COUNT", "FAILED", "ls_init", "ls_step_",
           "ls_step_plain_"]

# The state vector's fields, in the order of csrc/zoom_ls.cu's enum Field.
LS_FIELDS = (
    "value_init", "slope_init",
    "low", "value_low", "slope_low",
    "high", "value_high", "slope_high",
    "cubic_ref", "value_cubic_ref",
    "safe_stepsize", "safe_value",
    "prev_stepsize", "prev_value", "prev_slope",
    "stepsize", "decrease_error",
    "interval_found", "done", "failed", "count",
)
_IX = {name: i for i, name in enumerate(LS_FIELDS)}
STEPSIZE, COUNT, FAILED = _IX["stepsize"], _IX["count"], _IX["failed"]


def _f32(v):
    return float(np.float32(v))


# scale_by_zoom_linesearch's defaults, rounded to float32 as optax's weakly
# typed constants are (the kernel's constants are these values).
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = _f32(1e-4)
_CURV_RTOL = _f32(0.9)
_APPROX_DEC_RTOL = _f32(1e-6)
_APPROX_SLOPE = _f32(2 * 1e-4 - 1.0)  # (2 * slope_rtol - 1), folded as optax's
_STEPSIZE_PRECISION = _f32(1e-5)
_CUBIC_CHK, _QUAD_CHK = _f32(0.2), _f32(0.1)


def ls_init(value, slope):
    """(state, go) for a search from the iterate's ``value`` and ``slope``
    (0-d float32 tensors): every end of the interval at step 0, the first
    trial at step 1."""
    v = value.detach().reshape(())
    s = slope.detach().reshape(())
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    fields = dict(
        value_init=v, slope_init=s, low=zero, value_low=v, slope_low=s,
        high=zero, value_high=v, slope_high=s, cubic_ref=zero, value_cubic_ref=v,
        safe_stepsize=zero, safe_value=v, prev_stepsize=zero, prev_value=v,
        prev_slope=s, stepsize=one, decrease_error=torch.full_like(v, float("inf")),
        interval_found=zero, done=zero, failed=zero, count=zero)
    state = torch.stack([fields[name] for name in LS_FIELDS])
    return state, torch.ones((), dtype=torch.bool, device=v.device)


def _max(a, b):
    """numpy's ``maximum``: NaN if either is, else the larger, ``b`` on a tie."""
    return torch.where(torch.isnan(a) | (a > b), a, b)


def _min(a, b):
    return torch.where(torch.isnan(a) | (a < b), a, b)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's sufficient decrease, or Hager and Zhang's approximate one
    near the minimum, whichever is smaller; 0 when met, inf for NaN."""
    err = (value - value_init) - (_SLOPE_RTOL * stepsize) * slope_init
    approx = slope - _APPROX_SLOPE * slope_init
    delta = (value - value_init) - _APPROX_DEC_RTOL * torch.abs(value_init)
    err = _max(_min(_max(approx, delta), err), torch.zeros_like(err))
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)


def _curvature_error(slope, slope_init):
    err = _max(torch.abs(slope) - _CURV_RTOL * torch.abs(slope_init),
               torch.zeros_like(slope))
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)


def _cubic(a, fa, fpa, b, fb, c, fc):
    """(A, B, B^2 - 3 A fpa) of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a; a negative radical means no critical point."""
    db = b - a
    dc = c - a
    denom = ((db * dc) * (db * dc)) * (db - dc)
    v0 = (fb - fa) - fpa * db
    v1 = (fc - fa) - fpa * dc
    A = ((dc * dc) * v0 + (-(db * db)) * v1) / denom
    B = ((-((dc * dc) * dc)) * v0 + ((db * db) * db) * v1) / denom
    return A, B, B * B - (3.0 * A) * fpa


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of that cubic (NaN when there is none)."""
    A, B, radical = _cubic(a, fa, fpa, b, fb, c, fc)
    return a + ((-B) + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = ((fb - fa) - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def ls_step_plain_(state, go, value, slope, max_steps: int):
    """The plain version of :func:`ls_step_` (see the module docstring)."""
    f = dict(zip(LS_FIELDS, state.unbind(0)))
    value = value.detach().reshape(())
    slope = slope.detach().reshape(())
    stepsize, count = f["stepsize"], f["count"]
    low, value_low, slope_low = f["low"], f["value_low"], f["slope_low"]
    high, value_high, slope_high = f["high"], f["value_high"], f["slope_high"]
    dec = _decrease_error(stepsize, value, slope, f["value_init"], f["slope_init"])
    done = _max(dec, _curvature_error(slope, f["slope_init"])) <= 0.0
    last = count + 1.0 >= max_steps
    searching = f["interval_found"] == 0.0  # the trial was Algorithm 3.5's

    # Algorithm 3.5, the interval search: the trial against the one before.
    set_high = (dec > 0.0) | ((value >= f["prev_value"]) & (count > 0.0))
    set_low = (slope >= 0.0) & ~set_high
    prev = (f["prev_stepsize"], f["prev_value"], f["prev_slope"])
    trial = (stepsize, value, slope)
    s_low = [torch.where(set_low, t, p) for t, p in zip(trial, prev)]
    s_high = [torch.where(set_low, p, t) for t, p in zip(trial, prev)]
    s_safe = dec <= 0.0
    s_found = set_high | set_low | done
    s_failed = last & ~done

    # Algorithm 3.6, the zoom: the trial inside [low, high]; the new
    # reference of the cubic is the end that moves.
    z_safe = (dec <= 0.0) & (value < f["safe_value"])
    to_middle = (dec > 0.0) | (value >= value_low)
    to_low = (slope * (high - low) >= 0.0) & ~to_middle
    moves = to_middle | to_low
    z_cubic = (torch.where(moves, high, low), torch.where(moves, value_high, value_low))
    olds_low, olds_high = (low, value_low, slope_low), (high, value_high, slope_high)
    z_high = [torch.where(to_middle, t, torch.where(to_low, l, h))
              for t, l, h in zip(trial, olds_low, olds_high)]
    z_low = [torch.where(to_middle, l, t) for t, l in zip(trial, olds_low)]
    too_small = torch.abs(high - low) <= _STEPSIZE_PRECISION
    z_safe_stepsize = torch.where(z_safe, stepsize, f["safe_stepsize"])  # this trial's
    z_failed = (last | (too_small & (z_safe_stepsize > 0.0))) & ~done

    def pick(a, b):
        return torch.where(searching, a, b)

    low, value_low, slope_low = (pick(a, b) for a, b in zip(s_low, z_low))
    high, value_high, slope_high = (pick(a, b) for a, b in zip(s_high, z_high))
    cubic_ref = pick(s_low[0], z_cubic[0])
    value_cubic_ref = pick(s_low[1], z_cubic[1])
    take_safe = pick(s_safe, z_safe)
    safe_stepsize = torch.where(take_safe, stepsize, f["safe_stepsize"])
    safe_value = torch.where(take_safe, value, f["safe_value"])
    found = searching.logical_not() | s_found
    failed = pick(s_failed, z_failed)
    stop = done | failed

    # The next trial: twice the step while searching, else the cubic's or
    # the quadratic's minimum well inside [low, high], else the midpoint.
    delta = torch.abs(high - low)
    left, right = _min(high, low), _max(high, low)
    cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                      value_cubic_ref)
    quad = _quadmin(low, value_low, slope_low, high, value_high)
    cubic_in = (left + _CUBIC_CHK * delta < cubic) & (cubic < right - _CUBIC_CHK * delta)
    quad_in = (left + _QUAD_CHK * delta < quad) & (quad < right - _QUAD_CHK * delta)
    middle = torch.where(cubic_in, cubic, torch.where(quad_in, quad, (low + high) / 2.0))
    following = torch.where(found, middle, _INCREASE_FACTOR * stepsize)
    # At the end: the trial's step, or the safe one (the best point with a
    # sufficient decrease) after a failure.
    final = torch.where(failed & ((safe_stepsize > 0.0) | torch.isinf(dec)),
                        safe_stepsize, stepsize)
    advance = ~stop & ~found  # the next trial is the interval search's
    new = dict(
        value_init=f["value_init"], slope_init=f["slope_init"],
        low=low, value_low=value_low, slope_low=slope_low,
        high=high, value_high=value_high, slope_high=slope_high,
        cubic_ref=cubic_ref, value_cubic_ref=value_cubic_ref,
        safe_stepsize=safe_stepsize, safe_value=safe_value,
        prev_stepsize=torch.where(advance, stepsize, f["prev_stepsize"]),
        prev_value=torch.where(advance, value, f["prev_value"]),
        prev_slope=torch.where(advance, slope, f["prev_slope"]),
        stepsize=torch.where(stop, final, following), decrease_error=dec,
        interval_found=found.to(state.dtype), done=done.to(state.dtype),
        failed=failed.to(state.dtype), count=count + 1.0)
    state.copy_(torch.stack([new[name] for name in LS_FIELDS]))
    go.copy_(~stop)


def _check(state, go, value, slope):
    if state.dtype != torch.float32 or state.shape != (len(LS_FIELDS),):
        raise ValueError(f"ls_step_: state must be ({len(LS_FIELDS)},) float32, "
                         f"got {tuple(state.shape)} {state.dtype}")
    if go.dtype != torch.bool or go.numel() != 1:
        raise ValueError(f"ls_step_: go must be one bool, got {go.dtype} {tuple(go.shape)}")
    for name, t in (("value", value), ("slope", slope)):
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"ls_step_: {name} must be one float32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if any(t.device != state.device for t in (go, value, slope)):
        raise ValueError("ls_step_: state, go, value and slope must share a device")


def ls_step_(state, go, value, slope, max_steps: int):
    """Takes the trial at ``state[STEPSIZE]`` (``value`` and ``slope``, one
    float32 each) into ``state`` and ``go`` in place; ``max_steps`` is the
    search's limit of trials. CPU tensors take the plain version; CUDA
    tensors must be contiguous and on an sm_90 device, and launch the
    kernel on the current stream. No fallback."""
    _check(state, go, value, slope)
    if state.device.type == "cpu":
        ls_step_plain_(state, go, value, slope, max_steps)
        return
    if state.device.type != "cuda":
        raise ValueError(f"ls_step_: unsupported device {state.device}")
    if not all(t.is_contiguous() for t in (state, go, value, slope)):
        raise ValueError("ls_step_: inputs must be contiguous")
    cap = _capability(state.device.index)
    if cap != (9, 0):
        raise RuntimeError(
            f"ls_step_: the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(state.device)} is sm_{cap[0]}{cap[1]}")
    lib = build.load()
    switch = state.device.index != torch.cuda.current_device()
    with torch.cuda.device(state.device) if switch else contextlib.nullcontext():
        err = lib.stt_zoom_ls_step_f32(
            state.data_ptr(), go.data_ptr(), value.data_ptr(), slope.data_ptr(),
            int(max_steps), torch.cuda.current_stream(state.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ls_step_: kernel launch failed, cudaError_t {err}")
    ls_step_.launches += 1


ls_step_.launches = 0
