"""L-BFGS with the zoom line search in a step cell: the state the engine
starts a scale with (a fresh ``zoom_lbfgs_init``, as at every scale), the
runner it drives (``step.make_lbfgs_zoom_runner``: the head, the trials
while ``go`` holds and the tail as CUDA-graph replays on the card), and
the first gradient as the state holds it after one step (the gradient at
the first iterate, ``updates``), in float64.

The runner repeats one stretch of the scale. The first ``START``
iterations (the cell's set-up) run once; the state they leave is kept, and
after every ``SPAN`` iterations from there the runner's own buffers are
written back to it, in place, so that the graphs replay on as before and
every later iteration is one of iterations ``START + 1`` to
``START + SPAN`` of the scale. Left to run on, the searches reach the
float32 loss's noise floor, and from then on take up to 20 trials an
iteration (the plateau: optax's search, not the port's, as the JAX runner
shows); the iteration at which that starts moves with the seed, so a
window over it would time where the plateau falls rather than the step.
``SPAN`` stays well short of the earliest plateau seen."""

import torch

START, SPAN = 3, 25


class Repeating:
    """``runner(params, consts, state, n) -> (state, losses)``, as
    ``step.make_lbfgs_zoom_runner``'s (``inner``), over the repeated
    stretch."""

    def __init__(self, step, inner):
        self._step, self.inner = step, inner
        self._kept, self._done = None, 0

    def __call__(self, params, consts, state, n):
        losses = []
        while n:
            if self._done == START:
                if self._kept is None:
                    self._kept = self._step._clone(state)
            elif self._done == START + SPAN:
                self._step._write_(state, self._kept)  # the buffers the runner holds
                self._done = START
            end = START if self._done < START else START + SPAN
            k = min(n, end - self._done)
            state, out = self.inner(params, consts, state, k)
            losses.append(out)
            self._done, n = self._done + k, n - k
        return state, losses[0] if len(losses) == 1 else torch.cat(losses)


def init(step, image):
    return step.zoom_lbfgs_init(image)


def runner(step, cfg):
    return Repeating(step, step.make_lbfgs_zoom_runner(cfg))


def first_grad(cfg, opt):
    return opt.updates.double()
