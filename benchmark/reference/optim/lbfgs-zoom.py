"""optax 0.2.6's ``lbfgs(memory_size=10)`` with its zoom line search, in
float64, and the EMA of the iterate.

``optax.lbfgs`` is ``scale_by_lbfgs(scale_init_precond=True)`` (the
two-loop product over a memory of iterate and gradient differences), then
``scale(-1)``, then ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')``: the interval search and zoom of Nocedal and
Wright's Algorithms 3.5 and 3.6, with Hager and Zhang's approximate decrease
criterion. Written here from optax's definitions (``_src/transform.py``,
``_src/linesearch.py``) in plain torch and numpy: the memory size and the
step limit are the configuration's (``memory_size``,
``max_linesearch_steps``), and every trial calls ``value_and_grad``, the
reference's loss and gradient at a float64 image.

Departures from optax, none of which changes a decision but by rounding:

* every number is float64: the images, the memory, its weights and the
  identity scale, the inner products, and the line search's scalars, which
  optax keeps in float32 (its default dtype), with its constants (1e-4,
  0.9, 1e-6, 1e-5, 0.2, 0.1) the float64 values of the decimals and not
  float32 roundings of them;
* the optimizer protocol (``model._run``) hands ``step`` the gradient
  alone, so the value at the first iterate is evaluated again, and at every
  later one it is the value of the trial the search accepted there (the
  same float32 input);
* a trial's point is ``x + t d`` rounded once, to float32, where the
  reference's loss takes its input (optax adds in the parameters' dtype);
* the line search keeps no gradients (optax carries the trial's and the
  safe step's, which ``lbfgs`` does not read), and its ``max_stepsize`` is
  None, as ``optax.lbfgs`` sets it, so the branch it guards is left out.

The safeguards run in optax's order: each trial's decrease error (the
smaller of Armijo's and the approximate criterion's, NaN read as inf) and
curvature error, the safe step kept, the interval's ends set, then ``done``
and ``failed`` (the step limit, or in the zoom an interval below 1e-5 with
a safe step), and on failure the safe step taken where one exists or the
value is not finite. The min and max of two scalars propagate NaN, as
``jnp.minimum`` and ``jnp.maximum`` do.

No clamp: the iterate leaves [0, 1] freely, as the program's zoom runner
lets it. The EMA is the engine's (seeded with one update of a zero state);
:meth:`Optimizer.carry` starts the next scale's optimizer fresh, as the
engine does at every scale. ``stepsizes`` and ``trials`` record each line
search's accepted step and its number of evaluations.
"""

import numpy as np
import torch

__all__ = ["Optimizer"]

SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0

_f = np.float64


def _vdot(a, b):
    return _f(torch.dot(a.reshape(-1), b.reshape(-1)).item())


def _max(a, b):
    return _f(np.maximum(a, b))


def _min(a, b):
    return _f(np.minimum(a, b))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN where it has none)."""
    cc = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - cc * db, fc - fa - cc * dc
    aa = (dc ** 2 * r1 - db ** 2 * r2) / denom
    bb = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
    radical = bb * bb - 3.0 * aa * cc
    return a + (-bb + np.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    bb = (fb - fa - fpa * db) / db ** 2
    return a - fpa / (2.0 * bb)


class _Search:
    """One zoom line search from the iterate's value and slope along ``d``
    (``ZoomLinesearchState``'s scalars)."""

    def __init__(self, value, slope, max_steps):
        self.max_steps = max_steps
        self.value_init, self.slope_init = value, slope
        self.count, self.stepsize, self.value, self.slope = 0, _f(0.0), value, slope
        self.decrease_error = self.curvature_error = _f(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = _f(0.0), value, slope
        self.high, self.value_high, self.slope_high = _f(0.0), value, slope
        self.cubic_ref, self.value_cubic_ref = _f(0.0), value
        self.safe_stepsize, self.safe_value = _f(0.0), value

    def _decrease_error(self, stepsize, value, slope):
        armijo = value - self.value_init - SLOPE_RTOL * stepsize * self.slope_init
        approx = slope - (2 * SLOPE_RTOL - 1.0) * self.slope_init
        delta = value - self.value_init - APPROX_DEC_RTOL * abs(self.value_init)
        err = _max(_min(_max(approx, delta), armijo), 0.0)
        return _f(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope):
        err = _max(abs(slope) - CURV_RTOL * abs(self.slope_init), 0.0)
        return _f(np.inf) if np.isnan(err) else err

    def _errors(self, stepsize, value, slope):
        dec = self._decrease_error(stepsize, value, slope)
        curv = self._curvature_error(slope)
        return dec, curv, _max(dec, curv)

    def _search_interval(self, at):
        prev = (self.stepsize, self.value, self.slope)
        new = INCREASE_FACTOR * prev[0] if self.count > 0 else _f(1.0)
        value, slope = at(new)
        dec, curv, err = self._errors(new, value, slope)
        if dec <= TOL:
            self.safe_stepsize, self.safe_value = new, value
        set_high = bool(dec > 0.0) or (value >= prev[1] and self.count > 0)
        set_low = bool(slope >= 0.0) and not set_high
        if set_low:
            (self.low, self.value_low, self.slope_low), (self.high, self.value_high,
                                                         self.slope_high) = (new, value, slope), prev
        else:
            (self.low, self.value_low, self.slope_low), (self.high, self.value_high,
                                                         self.slope_high) = prev, (new, value, slope)
        self.interval_found = set_high or set_low or bool(err <= TOL)
        self.done = bool(err <= TOL)
        self.failed = self.count + 1 >= self.max_steps and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self._took(new, value, slope, dec, curv)

    def _zoom(self, at):
        low, value_low, slope_low = self.low, self.value_low, self.slope_low
        high, value_high, slope_high = self.high, self.value_high, self.slope_high
        delta = abs(high - low)
        left, right = _min(high, low), _max(high, low)
        too_small = bool(delta <= INTERVAL_THRESHOLD)
        cubic = _cubicmin(low, value_low, slope_low, high, value_high, self.cubic_ref,
                          self.value_cubic_ref)
        quad = _quadmin(low, value_low, slope_low, high, value_high)
        if cubic > left + 0.2 * delta and cubic < right - 0.2 * delta:
            middle = cubic
        elif quad > left + 0.1 * delta and quad < right - 0.1 * delta:
            middle = quad
        else:
            middle = (low + high) / 2.0
        value, slope = at(middle)
        dec, curv, err = self._errors(middle, value, slope)
        if dec <= TOL and value < self.safe_value:
            self.safe_stepsize, self.safe_value = middle, value
        self.done = bool(err <= TOL)
        set_high_to_middle = bool(dec > 0.0) or bool(value >= value_low)
        set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
        if set_high_to_middle:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if set_high_to_low:
            self.high, self.value_high, self.slope_high = low, value_low, slope_low
        if not set_high_to_middle:
            self.low, self.value_low, self.slope_low = middle, value, slope
        if set_high_to_middle or set_high_to_low:
            self.cubic_ref, self.value_cubic_ref = high, value_high
        else:
            self.cubic_ref, self.value_cubic_ref = low, value_low
        failed = self.count + 1 >= self.max_steps or (too_small and self.safe_stepsize > 0.0)
        self.failed = failed and not self.done
        self._took(middle, value, slope, dec, curv)

    def _took(self, stepsize, value, slope, dec, curv):
        self.count += 1
        self.stepsize, self.value, self.slope = stepsize, value, slope
        self.decrease_error, self.curvature_error = dec, curv

    def run(self, at):
        """Trials through ``at(stepsize) -> (value, slope)`` until done or
        failed; returns the accepted step size."""
        with np.errstate(all="ignore"):
            while not (self.done or self.failed):
                (self._zoom if self.interval_found else self._search_interval)(at)
                if self.failed and (self.safe_stepsize > 0.0 or np.isinf(self.decrease_error)):
                    self.stepsize, self.value = self.safe_stepsize, self.safe_value
        return self.stepsize


class Optimizer:
    def __init__(self, cfg, image):
        self.cfg, self.x = cfg, image.double()
        m = cfg["memory_size"]
        self.count = 0
        self.prev_x, self.prev_g = torch.zeros_like(self.x), torch.zeros_like(self.x)
        self.dw = torch.zeros((m, *self.x.shape), dtype=torch.float64, device=self.x.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = [_f(0.0)] * m
        self._value = None
        self.stepsizes, self.trials = [], []
        d = cfg["avg_decay"]
        self.ema, self.accum = (1.0 - d) * self.x, d

    def _direction(self, g):
        """``scale_by_lbfgs`` then ``scale(-1)``: -P g, the memory updated."""
        m = len(self.rho)
        first = self.count == 0
        dw, du = self.x - self.prev_x, g - self.prev_g
        dot = _vdot(du, dw)
        weight = _f(0.0) if dot == 0.0 else 1.0 / dot
        if first:
            dw, du, weight = torch.zeros_like(dw), torch.zeros_like(du), _f(0.0)
        slot = (self.count - 1) % m
        self.dw[slot], self.du[slot], self.rho[slot] = dw, du, weight
        if first:
            with np.errstate(divide="ignore"):
                scale = _min(1.0, 1.0 / np.sqrt(_vdot(g, g)))
        else:
            den = _vdot(du, du)
            scale = _vdot(du, dw) / den if den > 0.0 else _f(1.0)
        order = [(self.count % m + j) % m for j in range(m)]  # oldest first
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * _vdot(self.dw[i], vec)
            vec = vec - float(alphas[i]) * self.du[i]
        vec = float(scale) * vec
        for i in order:
            beta = self.rho[i] * _vdot(self.du[i], vec)
            vec = vec + float(alphas[i] - beta) * self.dw[i]
        self.count += 1
        self.prev_x, self.prev_g = self.x, g
        return -vec

    def step(self, g, value_and_grad):
        """One iteration from the gradient ``g`` at ``x``: the direction,
        the line search along it through ``value_and_grad``, the step."""
        if self._value is None:
            self._value = _f(value_and_grad(self.x)[0])
        d = self._direction(g)
        x = self.x
        search = _Search(self._value, _vdot(d, g), self.cfg["max_linesearch_steps"])
        values = {0.0: self._value}

        def at(t):
            v, gt = value_and_grad(x + float(t) * d)
            values[float(t)] = _f(v)
            return _f(v), _vdot(gt, d)

        t = float(search.run(at))
        self.stepsizes.append(t)
        self.trials.append(search.count)
        self.x, self._value = x + t * d, values[t]
        dec = self.cfg["avg_decay"]
        self.ema, self.accum = dec * self.ema + (1.0 - dec) * self.x, self.accum * dec

    def first_grad(self):
        """The gradient at the first iterate, as the state holds it after
        one step (the last gradient the memory took; zeros before any)."""
        return self.prev_g

    def average(self):
        return self.ema / (1.0 - self.accum)

    def carry(self, image):
        """The optimizer of the next scale, at ``image``: a fresh state."""
        return Optimizer(self.cfg, image)
