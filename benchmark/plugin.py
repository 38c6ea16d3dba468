"""Modules found by name: ``<folder>/<name>.py`` under ``benchmark/``, loaded
from its file, so that a later optimizer, loss or metric is a new file
beside the others and no edit (a name may hold ``-`` and ``.``, which
``import`` does not take).

The folders:

* ``runners/<optimizer>.py``: the program's state and runner for a step
  cell (``init``, ``runner``, ``first_grad``);
* ``reference/optim/<optimizer>.py``: the reference's optimizer
  (``Optimizer``);
* ``reference/style/<style_loss>.py``, ``reference/content/<content_loss>.py``:
  the reference's loss terms, and the style term's work count;
* ``metrics/<metric>.py``: a per-layer metric's reader (``read``).
"""

import importlib.util
from pathlib import Path

__all__ = ["load"]

HERE = Path(__file__).resolve().parent
_LOADED = {}


def load(folder, name):
    """The module of ``<folder>/<name>.py``, loaded once."""
    key = f"benchmark.{folder.replace('/', '.')}.{name}"
    if key not in _LOADED:
        path = HERE / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no benchmark/{folder}/{name}.py for {name!r}")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[key] = module
    return _LOADED[key]
