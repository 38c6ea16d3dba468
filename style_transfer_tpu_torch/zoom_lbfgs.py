"""L-BFGS with a zoom line search: the port's copy of ``optax.lbfgs``.

A tensor transcription of optax 0.2.6 (Apache-2.0), the optimizer behind the
JAX package's ``--optimizer lbfgs-zoom``: ``optax.lbfgs(memory_size=10)``,
that is ``scale_by_lbfgs(scale_init_precond=True)`` (``_src/transform.py``),
then ``scale(-1)``, then ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')`` (``_src/linesearch.py``: the interval search
and zoom of Nocedal and Wright's Algorithms 3.5 and 3.6, with Hager and
Zhang's approximate decrease criterion).

The vectors (the iterate, the direction, the trial gradients and the
10-deep memory of differences) stay on the iterate's device, and the
L-BFGS direction is computed there without a host read. The line search is
a data-dependent loop: each of its steps reads its trial value and slope to
the host once, and its state machine runs on the host in float32
(``numpy.float32``), as optax keeps its scalars, so that every accept or
reject decision is the reference's. ``value_and_grad_fn`` builds and frees
one autograd graph per trial. With a ``mesh`` (``parallel/mesh.py``) the
vectors are this rank's slabs and every inner product is summed over the
ranks, so every rank reads the same values and takes the same steps.
"""

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from .parallel.mesh import all_reduce_

__all__ = [
    "MAX_LINESEARCH_STEPS",
    "MEMORY_SIZE",
    "LinesearchResult",
    "ZoomLBFGSState",
    "lbfgs_direction",
    "zoom_lbfgs_init",
    "zoom_lbfgs_update",
    "zoom_linesearch",
]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20

# scale_by_zoom_linesearch's defaults. The Python constants of optax's code
# are weakly typed there, so float32 here.
_f32 = np.float32
_TOL = _f32(0.0)
_INCREASE_FACTOR = _f32(2.0)
_SLOPE_RTOL = _f32(1e-4)
_CURV_RTOL = _f32(0.9)
_APPROX_DEC_RTOL = _f32(1e-6)
_APPROX_SLOPE = _f32(2 * 1e-4 - 1.0)  # (2 * slope_rtol - 1), folded as optax's
_STEPSIZE_PRECISION = _f32(1e-5)
_ZERO, _ONE, _TWO, _THREE = (_f32(v) for v in (0.0, 1.0, 2.0, 3.0))
_CUBIC_CHK, _QUAD_CHK = _f32(0.2), _f32(0.1)
_INF = _f32(np.inf)


class ZoomLBFGSState(NamedTuple):
    """``scale_by_lbfgs``'s state (on the iterate's device) and the last
    line search's step count (host)."""

    count: int  # iterations taken (host)
    params: torch.Tensor  # the previous iterate
    updates: torch.Tensor  # the previous gradient
    diff_params: torch.Tensor  # (m, *shape) past iterate differences
    diff_updates: torch.Tensor  # (m, *shape) past gradient differences
    weights: torch.Tensor  # (m,) 1 / <du, dw>, 0 where that product is 0
    linesearch_steps: int  # evaluations of the last line search


class LinesearchResult(NamedTuple):
    stepsize: np.float32
    num_steps: int  # evaluations of the objective
    failed: bool  # ended by the step limit or a too small interval


def zoom_lbfgs_init(params: torch.Tensor, memory_size: int = MEMORY_SIZE) -> ZoomLBFGSState:
    mem = torch.zeros((memory_size, *params.shape), dtype=params.dtype,
                      device=params.device)
    return ZoomLBFGSState(
        count=0, params=torch.zeros_like(params), updates=torch.zeros_like(params),
        diff_params=mem, diff_updates=mem.clone(),
        weights=torch.zeros((memory_size,), dtype=torch.float32, device=params.device),
        linesearch_steps=0,
    )


def _vdot(a, b, mesh=None):
    return all_reduce_(torch.dot(a.reshape(-1), b.reshape(-1)), mesh)


def lbfgs_direction(state: ZoomLBFGSState, grad: torch.Tensor, params: torch.Tensor,
                    mesh=None):
    """``scale_by_lbfgs`` then ``scale(-1)``: the descent direction -P·g and
    the new state. The memory is written in place (nothing else holds it);
    every decision on device values is a ``torch.where``."""
    m = state.weights.shape[0]
    memory_idx = state.count % m
    prev_idx = (state.count - 1) % m
    # 1. The memory, given the fresh iterate and gradient (zeros at count 0).
    if state.count > 0:
        diff_params = params - state.params
        diff_updates = grad - state.updates
        dot_du_dw = _vdot(diff_updates, diff_params, mesh)
        weight = torch.where(dot_du_dw == 0.0, torch.zeros_like(dot_du_dw), 1.0 / dot_du_dw)
    else:
        diff_params = torch.zeros_like(params)
        diff_updates = torch.zeros_like(params)
        weight = torch.zeros((), dtype=torch.float32, device=params.device)
    state.diff_params[prev_idx] = diff_params
    state.diff_updates[prev_idx] = diff_updates
    state.weights[prev_idx] = weight
    # 2. The scale of the identity: <du, dw> / |du|^2, and at the first
    # step the capped reciprocal of the gradient's norm.
    if state.count > 0:
        denominator = _vdot(diff_updates, diff_updates, mesh)
        identity_scale = torch.where(denominator > 0.0, dot_du_dw / denominator,
                                     torch.ones_like(denominator))
    else:
        identity_scale = torch.clamp(1.0 / torch.sqrt(_vdot(grad, grad, mesh)), max=1.0)
    # 3. The two-loop product P·g, newest memory entry first.
    dw, du, rhos = state.diff_params, state.diff_updates, state.weights
    indices = [(memory_idx + j) % m for j in range(m)]
    vec = grad
    alphas = [None] * m
    for j in reversed(range(m)):
        i = indices[j]
        alphas[j] = rhos[i] * _vdot(dw[i], vec, mesh)
        vec = vec + (-alphas[j]) * du[i]
    vec = identity_scale * vec
    for j in range(m):
        i = indices[j]
        beta = rhos[i] * _vdot(du[i], vec, mesh)
        vec = vec + (alphas[j] - beta) * dw[i]
    new_state = state._replace(count=state.count + 1, params=params, updates=grad)
    return -1.0 * vec, new_state


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * dc * dc)) * v0 + (db * db * db) * v1) / denom
    radical = B * B - _THREE * A * C
    return a + (-B + np.sqrt(radical)) / (_THREE * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (_TWO * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's sufficient decrease, or Hager and Zhang's approximate one
    near the minimum, whichever is smaller; 0 when met, inf for NaN."""
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - _APPROX_SLOPE * slope_init
    delta = value - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
    err = np.minimum(np.maximum(approx, delta), err)
    err = np.maximum(err, _ZERO)
    return _INF if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init), _ZERO)
    return _INF if np.isnan(err) else err


def zoom_linesearch(value_and_grad_fn: Callable, params: torch.Tensor,
                    updates: torch.Tensor, value, grad: torch.Tensor,
                    max_linesearch_steps: int = MAX_LINESEARCH_STEPS,
                    mesh=None) -> LinesearchResult:
    """optax's ``zoom_linesearch`` from the initial guess 1 along ``updates``.

    ``value_and_grad_fn(x) -> (scalar tensor, gradient)``; ``value`` (a
    scalar tensor) and ``grad`` are the objective and its gradient at
    ``params``. Reads the initial value and slope, then each trial's value
    and slope, to the host: one read per evaluation.
    """
    with np.errstate(all="ignore"):
        value_init, slope_init = _read(value, _vdot(updates, grad, mesh))
        low = high = cubic_ref = safe_stepsize = stepsize = _ZERO
        value_low = value_high = value_cubic_ref = safe_value = cur_value = value_init
        slope_low = slope_high = cur_slope = slope_init
        decrease_error = _INF
        interval_found = done = failed = False
        count = 0
        while not (done or failed):
            if not interval_found:  # Algorithm 3.5: search an interval
                prev_stepsize, prev_value, prev_slope = stepsize, cur_value, cur_slope
                stepsize = _ONE if count == 0 else _INCREASE_FACTOR * prev_stepsize
                cur_value, cur_slope = _trial(value_and_grad_fn, params, stepsize,
                                              updates, mesh)
                decrease_error = _decrease_error(stepsize, cur_value, cur_slope,
                                                 value_init, slope_init)
                error = np.maximum(decrease_error, _curvature_error(cur_slope, slope_init))
                if decrease_error <= _TOL:
                    safe_stepsize, safe_value = stepsize, cur_value
                set_high = decrease_error > _ZERO or (cur_value >= prev_value
                                                      and count > 0)
                set_low = cur_slope >= _ZERO and not set_high
                if set_low:
                    low, value_low, slope_low = stepsize, cur_value, cur_slope
                    high, value_high, slope_high = prev_stepsize, prev_value, prev_slope
                else:
                    low, value_low, slope_low = prev_stepsize, prev_value, prev_slope
                    high, value_high, slope_high = stepsize, cur_value, cur_slope
                interval_found = set_high or set_low or error <= _TOL
                done = bool(error <= _TOL)
                failed = count + 1 >= max_linesearch_steps and not done
                cubic_ref, value_cubic_ref = low, value_low
            else:  # Algorithm 3.6: zoom into [low, high]
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                too_small = delta <= _STEPSIZE_PRECISION
                middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                         cubic_ref, value_cubic_ref)
                middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
                if left + _CUBIC_CHK * delta < middle_cubic < right - _CUBIC_CHK * delta:
                    stepsize = middle_cubic
                elif left + _QUAD_CHK * delta < middle_quad < right - _QUAD_CHK * delta:
                    stepsize = middle_quad
                else:
                    stepsize = (low + high) / _TWO
                cur_value, cur_slope = _trial(value_and_grad_fn, params, stepsize,
                                              updates, mesh)
                decrease_error = _decrease_error(stepsize, cur_value, cur_slope,
                                                 value_init, slope_init)
                error = np.maximum(decrease_error, _curvature_error(cur_slope, slope_init))
                if decrease_error <= _TOL and cur_value < safe_value:
                    safe_stepsize, safe_value = stepsize, cur_value
                done = bool(error <= _TOL)
                set_high_to_middle = decrease_error > _ZERO or cur_value >= value_low
                set_high_to_low = (cur_slope * (high - low) >= _ZERO
                                   and not set_high_to_middle)
                # The new reference of the cubic is the end that moves.
                if set_high_to_middle or set_high_to_low:
                    cubic_ref, value_cubic_ref = high, value_high
                else:
                    cubic_ref, value_cubic_ref = low, value_low
                if set_high_to_middle:
                    high, value_high, slope_high = stepsize, cur_value, cur_slope
                elif set_high_to_low:
                    high, value_high, slope_high = low, value_low, slope_low
                if not set_high_to_middle:
                    low, value_low, slope_low = stepsize, cur_value, cur_slope
                failed = ((count + 1 >= max_linesearch_steps
                           or (too_small and safe_stepsize > _ZERO)) and not done)
            count += 1
        if failed and (safe_stepsize > _ZERO or np.isinf(decrease_error)):
            # The safe step: the best point with a sufficient decrease.
            stepsize = safe_stepsize
    return LinesearchResult(stepsize=stepsize, num_steps=count, failed=bool(failed))


def _read(*scalars) -> Tuple[np.float32, ...]:
    """Device scalars to host float32, in one read."""
    return tuple(torch.stack([s.detach().float() for s in scalars]).cpu().numpy())


def _trial(value_and_grad_fn, params, stepsize, updates, mesh=None):
    """(value, slope along ``updates``) at params + stepsize·updates."""
    value, grad = value_and_grad_fn(params + float(stepsize) * updates)
    return _read(value, _vdot(grad, updates, mesh))


def zoom_lbfgs_update(state: ZoomLBFGSState, params: torch.Tensor, value, grad,
                      value_and_grad_fn: Callable,
                      max_linesearch_steps: int = MAX_LINESEARCH_STEPS, mesh=None):
    """One ``optax.lbfgs`` iteration: returns (params + lr·d, new state)
    for the L-BFGS direction d and the step lr the line search accepts.
    ``value`` and ``grad`` are the objective and its gradient at ``params``."""
    direction, state = lbfgs_direction(state, grad, params, mesh)
    ls = zoom_linesearch(value_and_grad_fn, params, direction, value, grad,
                         max_linesearch_steps, mesh)
    new_params = params + float(ls.stepsize) * direction
    return new_params, state._replace(linesearch_steps=ls.num_steps)
