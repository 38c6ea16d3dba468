"""PyTorch port: the zoom L-BFGS runner against the benchmark's float64
reference optimizer (``benchmark/reference/optim/lbfgs-zoom.py``), on the
CPU, through the step cell's own path.

The cell ``f32-lbfgszoom-step512`` with its traffic cut to a 64x48 canvas
and a 64x64 style image: the program is ``benchmark.harness.StepRun``
driving ``runners/lbfgs-zoom.py`` (``step.make_lbfgs_zoom_runner`` from
``step.zoom_lbfgs_init``, eager here), the reference the plain float64
transcription of optax 0.2.6's ``lbfgs`` on the reference's loss, both from
the same seeded He-normal weights and textures. Compared over the first
three iterations: the losses, the first gradient, the image's change, and
each line search's trial count and accepted step size. The reference itself
is held to ``optax.lbfgs`` on a toy.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from benchmark import harness, plugin
from benchmark.inputs import make_inputs
from style_transfer_tpu_torch import zoom_lbfgs as Z

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 18
STEPS = 3


def _rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).norm() / b.norm())


def _recording(step_run):
    """``StepRun.__init__`` that also reads the program's searches where
    each iteration's tail takes the accepted step (``_ZoomPhases.tail``):
    the step size and the trials."""

    def init(self, *args):
        step_run(self, *args)
        phases, self.stepsizes, self.trials = self.runner.inner._body, [], []
        tail = phases.tail

        def recorded_tail(static):
            ls = phases._update.search.result()
            self.stepsizes.append(float(ls.stepsize))
            self.trials.append(int(ls.num_steps))
            tail(static)

        phases.tail = recorded_tail

    return init


@pytest.fixture(scope="module")
def runs():
    """(program, reference): each {"losses", "grad1", "change", "stepsizes",
    "trials"}, the program's as the cell's set-up produces them."""
    cell = harness.load_cell("f32-lbfgszoom-step512")
    cell.traffic.update(content=[64, 48], style=[64, 64], scale=64, chunk=2, first_steps=STEPS)
    inputs = make_inputs(cell.cfg, cell.traffic, SEED, "cpu")
    ref_opt = plugin.load("reference/optim", cell.cfg["optimizer"])
    made = []

    class Recording(ref_opt.Optimizer):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness.StepRun, "__init__", _recording(harness.StepRun.__init__))
        mp.setattr(ref_opt, "Optimizer", Recording)
        run, prog = harness.program_first_steps(cell, inputs, "cpu")
        ref = harness.reference_first_steps(cell, inputs)
    prog.update(stepsizes=run.stepsizes, trials=run.trials)
    (opt,) = made
    ref.update(stepsizes=opt.stepsizes, trials=opt.trials)
    return prog, ref


def test_each_line_search_takes_the_reference_trials(runs):
    """The same trials in every search (7, 2 and 1 here: each is a decision
    on values that differ by 5e-5 relative or less), and the same accepted
    step to 5e-4 relative: a step of the interval search is a power of 2,
    exact on both sides (64 here); one the zoom interpolates (0.3156 here)
    is a cubic's or a parabola's minimum through the program's float32
    values and slopes (measured 4.9e-5 from the reference's)."""
    prog, ref = runs
    assert prog["trials"] == ref["trials"] and len(prog["trials"]) == STEPS
    assert prog["trials"][0] > 1  # the first search grows the step
    np.testing.assert_allclose(prog["stepsizes"], ref["stepsizes"], rtol=5e-4)


def test_losses_match_the_reference(runs):
    """rtol 5e-4: the program's statistics, targets and NS chain are FP32
    against the reference's float64 (measured 6.5e-6, 2.7e-6 and 4.7e-5),
    while each step lowers the loss by 29% and more here."""
    prog, ref = runs
    assert len(prog["losses"]) == len(ref["losses"]) == STEPS
    np.testing.assert_allclose(prog["losses"], ref["losses"], rtol=5e-4)
    assert prog["losses"][-1] < prog["losses"][0]


def test_first_gradient_matches_the_reference(runs):
    """The gradient at the first iterate, as the state holds it after one
    step (``updates``; the reference's last gradient): 1e-4 in norm of the
    difference, FP32 after the taps against float64 (measured 7.4e-6)."""
    prog, ref = runs
    assert prog["grad1"].dtype == torch.float64
    assert _rel(prog["grad1"], ref["grad1"]) < 1e-4


def test_image_change_matches_the_reference(runs):
    """The image's change over the three steps: 2e-2 in norm of the
    difference. The memory's differences of gradients cancel most of their
    digits, so the FP32 gradients' rounding grows in the second and third
    directions (measured 1.7e-3 here, 4e-3 after five steps on another
    seed)."""
    prog, ref = runs
    assert _rel(prog["change"], ref["change"]) < 2e-2
    assert float(torch.as_tensor(ref["change"]).norm()) > 0


def test_configuration_states_what_the_program_runs():
    """The memory and the step limit the reference reads are the port's."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "vgg19-w2-lbfgszoom-f32.json").read_text())
    assert cfg["optimizer"] == "lbfgs-zoom"
    assert (cfg["memory_size"], cfg["max_linesearch_steps"]) == (Z.MEMORY_SIZE,
                                                                Z.MAX_LINESEARCH_STEPS)
    assert not {"beta1", "beta2", "adam_eps"} & set(cfg)


def test_the_reference_takes_optax_trials_on_a_toy():
    """On a quadratic in 12 dimensions with curvatures 1 to 100, over 8
    iterations, two of whose searches zoom (the first and the sixth): the
    same trials in every search, and the same step sizes and iterates as
    ``optax.lbfgs`` in float32 (measured 1.8e-6 and 2.6e-7 apart)."""
    rng = np.random.RandomState(4)
    q, _ = np.linalg.qr(rng.randn(12, 12))
    a = (q * np.logspace(0, 2, 12)) @ q.T
    b = rng.randn(12)
    x0 = 0.1 * rng.randn(12)

    def f(x):
        return 0.5 * x @ (jnp.asarray(a, jnp.float32) @ x) - jnp.asarray(b, jnp.float32) @ x

    opt = optax.lbfgs(memory_size=10, linesearch=optax.scale_by_zoom_linesearch(
        max_linesearch_steps=20, initial_guess_strategy="one"))

    @jax.jit
    def step(x, state):
        value, g = jax.value_and_grad(f)(x)
        updates, state = opt.update(g, state, x, value=value, grad=g, value_fn=f)
        return optax.apply_updates(x, updates), state

    cfg = {"memory_size": 10, "max_linesearch_steps": 20, "avg_decay": 0.99}
    ref = plugin.load("reference/optim", "lbfgs-zoom").Optimizer(cfg, torch.tensor(x0))
    at = torch.tensor(a)

    def value_and_grad(x):
        return float(0.5 * x @ at @ x - torch.tensor(b) @ x), at @ x - torch.tensor(b)

    x, state = jnp.asarray(x0, jnp.float32), opt.init(jnp.asarray(x0, jnp.float32))
    for k in range(8):
        x, state = step(x, state)
        ref.step(value_and_grad(ref.x)[1], value_and_grad)
        ls = state[2]
        assert ref.trials[-1] == int(ls.info.num_linesearch_steps), k
        np.testing.assert_allclose(ref.stepsizes[-1], float(ls.learning_rate), rtol=1e-4)
        np.testing.assert_allclose(ref.x.numpy(), np.asarray(x), rtol=0, atol=1e-5)
    assert ref.trials == [2, 1, 1, 1, 1, 2, 1, 1]
