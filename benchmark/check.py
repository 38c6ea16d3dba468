"""The comparison that decides ``correct``.

What the program produced on the timed path, in set-up, is held against
the plain reference (:mod:`benchmark.reference`) on the same inputs:

* step cells (the Adam runner the window drives, its first three
  iterations from the scale's fresh state, which the window continues):
  ``loss``, the largest relative gap of the three losses; ``grad1``, the
  relative gap of the first gradient's norm, the program's taken from
  Adam's first moment after one step (mu / (1 - beta1)); ``change``, the
  relative gap of the norm of the image's change over the three steps;
* pyramid cells (``StyleTransfer.stylize`` at the warm-up's iterations a
  scale over the cell's scales): ``loss``, the largest relative gap of
  every iteration's loss; ``image``, the final image's distance from the
  reference's, relative to the reference's distance from the content.

A cell compares the numbers that have a limit in
``limits/<workload>.json``; one that another number bounds is left out
there (``grad1`` never exceeds ``grad1_diff``: the gap of two norms is at
most the norm of the difference).
"""

import math

import numpy as np

__all__ = ["step_numbers", "pyramid_numbers", "judge"]


def _rel(a, b):
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == b else math.inf)


def _loss_gap(prog, ref):
    if len(prog) != len(ref):
        return math.inf
    gaps = [_rel(float(p), float(r)) for p, r in zip(prog, ref)]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def _norm(x):
    return float(np.linalg.norm(np.asarray(x, np.float64).ravel()))


def _dir(p, r):
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    return _norm(p - r) / _norm(r) if p.shape == r.shape else math.inf


def step_numbers(prog, ref):
    return {
        "loss": _loss_gap(prog["losses"], ref["losses"]),
        "grad1": _rel(_norm(prog["grad1"]), _norm(ref["grad1"])),
        "grad1_diff": _dir(prog["grad1"], ref["grad1"]),
        "change": _rel(_norm(prog["change"]), _norm(ref["change"])),
        "change_diff": _dir(prog["change"], ref["change"]),
    }


def pyramid_numbers(prog, ref):
    img_p, img_r = np.asarray(prog["image"], np.float64), np.asarray(ref["image"], np.float64)
    if img_p.shape != img_r.shape:
        image = math.inf
    else:
        image = float(np.linalg.norm(img_p - img_r) / np.linalg.norm(img_r - ref["content"]))
    return {"loss": _loss_gap(prog["losses"], ref["losses"]), "image": image}


def judge(numbers, limits):
    """({name: {"value", "limit"}}, correct) over the numbers that have a
    limit: a number that is not finite, or lies above its limit, is not
    correct."""
    compared = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()
                if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return compared, ok
