"""L-BFGS with a zoom line search: the port's copy of ``optax.lbfgs``.

A tensor transcription of optax 0.2.6 (Apache-2.0), the optimizer behind the
JAX package's ``--optimizer lbfgs-zoom``: ``optax.lbfgs(memory_size=10)``,
that is ``scale_by_lbfgs(scale_init_precond=True)`` (``_src/transform.py``),
then ``scale(-1)``, then ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')`` (``_src/linesearch.py``: the interval search
and zoom of Nocedal and Wright's Algorithms 3.5 and 3.6, with Hager and
Zhang's approximate decrease criterion).

Everything stays on the iterate's device, as in the JAX runner's compiled
chunk: the vectors (the iterate, the direction, the trial gradients and the
10-deep memory of differences), the iteration count (an int32 tensor: the
direction's first-step choices are ``torch.where``s and its circular order
an ``index_select``), and the line search's scalars, one float32 state
vector that ``ops/cuda/zoom_ls.py`` steps once per trial (its kernel on the
card, its plain version on the CPU), as optax keeps them in float32. The
search's loop reads only whether to run the next trial, one bool per trial
(:func:`run_trials`); on the card the graph runner replays a CUDA graph of
one trial for each (``step._Runner``). ``value_and_grad_fn``
builds and frees one autograd graph per trial. With a ``mesh``
(``parallel/mesh.py``) the vectors are this rank's slabs and every inner
product is summed over the ranks, so every rank steps the same state and
takes the same trials.
"""

from typing import Callable, NamedTuple

import torch

from .ops.cuda.zoom_ls import COUNT, FAILED, STEPSIZE, ls_init, ls_step_
from .parallel.mesh import all_reduce_
from .utils.trace import host_wait

__all__ = [
    "MAX_LINESEARCH_STEPS",
    "MEMORY_SIZE",
    "LinesearchResult",
    "ZoomLBFGSState",
    "ZoomLBFGSUpdate",
    "ZoomLinesearch",
    "lbfgs_direction",
    "run_trials",
    "zoom_lbfgs_init",
    "zoom_lbfgs_update",
    "zoom_linesearch",
]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20


class ZoomLBFGSState(NamedTuple):
    """``scale_by_lbfgs``'s state and the last line search's trials, all on
    the iterate's device."""

    count: torch.Tensor  # int32: iterations taken
    params: torch.Tensor  # the previous iterate
    updates: torch.Tensor  # the previous gradient
    diff_params: torch.Tensor  # (m, *shape) past iterate differences
    diff_updates: torch.Tensor  # (m, *shape) past gradient differences
    weights: torch.Tensor  # (m,) 1 / <du, dw>, 0 where that product is 0
    linesearch_steps: torch.Tensor  # int32: evaluations of the last line search


class LinesearchResult(NamedTuple):
    stepsize: torch.Tensor  # float32
    num_steps: torch.Tensor  # int32: evaluations of the objective
    failed: torch.Tensor  # bool: ended by the step limit or a too small interval


def zoom_lbfgs_init(params: torch.Tensor, memory_size: int = MEMORY_SIZE) -> ZoomLBFGSState:
    mem = torch.zeros((memory_size, *params.shape), dtype=params.dtype,
                      device=params.device)
    count = torch.zeros((), dtype=torch.int32, device=params.device)
    return ZoomLBFGSState(
        count=count, params=torch.zeros_like(params), updates=torch.zeros_like(params),
        diff_params=mem, diff_updates=mem.clone(),
        weights=torch.zeros((memory_size,), dtype=torch.float32, device=params.device),
        linesearch_steps=count.clone(),
    )


def _vdot(a, b, mesh=None):
    """Inner product of two images (of their slabs, summed over the ranks)."""
    return all_reduce_(torch.dot(a.reshape(-1), b.reshape(-1)), mesh)


def lbfgs_direction(state: ZoomLBFGSState, grad: torch.Tensor, params: torch.Tensor,
                    mesh=None):
    """``scale_by_lbfgs`` then ``scale(-1)``: the descent direction -P·g and
    the new state. The memory is written in place (nothing else holds it);
    every decision on the count and on device values is a ``torch.where``,
    so nothing is read back to the host."""
    m = state.weights.shape[0]
    first = state.count == 0
    prev_idx = ((state.count - 1) % m).long().reshape(1)
    # 1. The memory, given the fresh iterate and gradient (zeros at count 0).
    diff_params = params - state.params
    diff_updates = grad - state.updates
    dot_du_dw = _vdot(diff_updates, diff_params, mesh)
    weight = torch.where(dot_du_dw == 0.0, torch.zeros_like(dot_du_dw), 1.0 / dot_du_dw)
    diff_params = torch.where(first, torch.zeros_like(diff_params), diff_params)
    diff_updates = torch.where(first, torch.zeros_like(diff_updates), diff_updates)
    weight = torch.where(first, torch.zeros_like(weight), weight)
    state.diff_params.index_copy_(0, prev_idx, diff_params.unsqueeze(0))
    state.diff_updates.index_copy_(0, prev_idx, diff_updates.unsqueeze(0))
    state.weights.index_copy_(0, prev_idx, weight.reshape(1))
    # 2. The scale of the identity: <du, dw> / |du|^2, and at the first
    # step the capped reciprocal of the gradient's norm.
    denominator = _vdot(diff_updates, diff_updates, mesh)
    identity_scale = torch.where(denominator > 0.0, dot_du_dw / denominator,
                                 torch.ones_like(denominator))
    capped = torch.clamp(1.0 / torch.sqrt(_vdot(grad, grad, mesh)), max=1.0)
    identity_scale = torch.where(first, capped, identity_scale)
    # 3. The two-loop product P·g, newest memory entry first, over the
    # memory in circular order from slot count % m.
    order = ((state.count + torch.arange(m, device=grad.device)) % m).long()
    dw = state.diff_params.index_select(0, order)
    du = state.diff_updates.index_select(0, order)
    rhos = state.weights.index_select(0, order)
    vec = grad
    alphas = [None] * m
    for j in reversed(range(m)):
        alphas[j] = rhos[j] * _vdot(dw[j], vec, mesh)
        vec = vec + (-alphas[j]) * du[j]
    vec = identity_scale * vec
    for j in range(m):
        beta = rhos[j] * _vdot(du[j], vec, mesh)
        vec = vec + (alphas[j] - beta) * dw[j]
    new_state = state._replace(count=state.count + 1, params=params, updates=grad)
    return -1.0 * vec, new_state


class ZoomLinesearch:
    """optax's ``zoom_linesearch`` from the initial guess 1 along
    ``updates``, one trial at a time, its state on the device.

    ``value_and_grad_fn(x) -> (scalar tensor, gradient)``; ``value`` (a
    scalar tensor) and ``grad`` are the objective and its gradient at
    ``params``. :meth:`trial` evaluates at ``params + stepsize * updates``
    and steps the state; ``go`` (a device bool) says whether the search
    wants another trial, and once it does not, ``stepsize`` is the step it
    accepts. The first trial always runs; the search sets ``go`` False by
    its ``max_linesearch_steps``-th trial."""

    def __init__(self, value_and_grad_fn: Callable, params: torch.Tensor,
                 updates: torch.Tensor, value, grad: torch.Tensor,
                 max_linesearch_steps: int = MAX_LINESEARCH_STEPS, mesh=None):
        self._fn, self._params, self._updates = value_and_grad_fn, params, updates
        self.max_steps, self._mesh = max_linesearch_steps, mesh
        self.state, self.go = ls_init(value, _vdot(updates, grad, mesh))

    @property
    def stepsize(self) -> torch.Tensor:
        return self.state[STEPSIZE]

    def trial(self):
        value, grad = self._fn(self._params + self.stepsize * self._updates)
        ls_step_(self.state, self.go, value, _vdot(grad, self._updates, self._mesh),
                 self.max_steps)

    def result(self) -> LinesearchResult:
        return LinesearchResult(stepsize=self.stepsize, num_steps=self.state[COUNT].int(),
                                failed=self.state[FAILED] != 0)


def run_trials(trial: Callable, go: torch.Tensor,
               max_linesearch_steps: int = MAX_LINESEARCH_STEPS) -> int:
    """Runs ``trial()`` once, then again while the search's ``go`` holds
    (read to the host after each trial, the search's one read, a
    ``host_wait`` named ``go`` of the recorder), at most
    ``max_linesearch_steps`` times in all; returns how many ran. ``trial``
    is :meth:`ZoomLinesearch.trial`, or the replay of a CUDA graph of it
    (``step._Runner``)."""
    trial()
    n = 1
    while n < max_linesearch_steps:
        with host_wait("go"):
            more = bool(go)
        if not more:
            break
        trial()
        n += 1
    return n


def zoom_linesearch(value_and_grad_fn: Callable, params: torch.Tensor,
                    updates: torch.Tensor, value, grad: torch.Tensor,
                    max_linesearch_steps: int = MAX_LINESEARCH_STEPS,
                    mesh=None) -> LinesearchResult:
    """The whole search (:class:`ZoomLinesearch`, :func:`run_trials`)."""
    search = ZoomLinesearch(value_and_grad_fn, params, updates, value, grad,
                            max_linesearch_steps, mesh)
    run_trials(search.trial, search.go, max_linesearch_steps)
    return search.result()


class ZoomLBFGSUpdate:
    """One ``optax.lbfgs`` iteration in the parts a CUDA graph captures
    apart: the constructor takes the L-BFGS direction d and starts the line
    search along it (``search``), whose trials the caller runs
    (:func:`run_trials`); :meth:`result` is then (params + lr·d, the new
    state) for the step lr the search accepts. ``value`` and ``grad`` are
    the objective and its gradient at ``params``."""

    def __init__(self, state: ZoomLBFGSState, params: torch.Tensor, value, grad,
                 value_and_grad_fn: Callable,
                 max_linesearch_steps: int = MAX_LINESEARCH_STEPS, mesh=None):
        self._params = params
        self._direction, self._state = lbfgs_direction(state, grad, params, mesh)
        self.search = ZoomLinesearch(value_and_grad_fn, params, self._direction, value,
                                     grad, max_linesearch_steps, mesh)

    def result(self):
        ls = self.search.result()
        return (self._params + ls.stepsize * self._direction,
                self._state._replace(linesearch_steps=ls.num_steps))


def zoom_lbfgs_update(state: ZoomLBFGSState, params: torch.Tensor, value, grad,
                      value_and_grad_fn: Callable,
                      max_linesearch_steps: int = MAX_LINESEARCH_STEPS, mesh=None):
    """One ``optax.lbfgs`` iteration (:class:`ZoomLBFGSUpdate`, its trials
    run by :func:`run_trials`): returns (params + lr·d, new state)."""
    update = ZoomLBFGSUpdate(state, params, value, grad, value_and_grad_fn,
                             max_linesearch_steps, mesh)
    run_trials(update.search.trial, update.search.go, max_linesearch_steps)
    return update.result()
