"""Nothing the runner or the reference loads is JAX or the JAX package, by
whole top-level names (``style_transfer_tpu_torch`` begins with
``style_transfer_tpu``), and the reference loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

_RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny
from benchmark import harness, calibrate, check, counts  # noqa: F401
import benchmark.run  # noqa: F401
result = harness.run_cell(tiny({cell!r}), 2**31 + 9, 0.1, 1, "cpu")
print(json.dumps({{"tops": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "forbidden": harness.forbidden_modules(), "correct": result["correct"]}}))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.reference import first_steps, pyramid
from benchmark import inputs, check, counts  # noqa: F401
for name in ("vgg19-w2-adam-f32", "vgg19-w2-adam-bf16"):
    cfg = json.load(open({root!r} + "/benchmark/configs/" + name + ".json"))
    t = {{"content": [64, 48], "style": [48, 48], "scale": 64, "min_scale": 48, "end_scale": 64}}
    x = inputs.make_inputs(cfg, t, 5, "cpu")
    first_steps(cfg, t, x, steps=2, mode="tf32_ns")
    pyramid(cfg, t, x, 1, mode="tf32" if name.endswith("f32") else "fp8")
    counts.step_flops(cfg, 48, 64)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    for cell in ("f32-step512", "bf16-pyramid512"):
        got = _python(_RUN.format(root=str(ROOT), tests=str(Path(__file__).parent), cell=cell))
        assert got["forbidden"] == []
        assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "style_transfer_tpu"}
        assert "style_transfer_tpu_torch" in got["tops"]


def test_the_reference_loads_nothing_of_the_program():
    """Its files found by name (the optimizer, the loss terms) and its
    controls included: it runs before the modules are listed."""
    tops = set(_python(_REFERENCE.format(root=str(ROOT))))
    assert not tops & {"jax", "jaxlib", "flax", "style_transfer_tpu", "style_transfer_tpu_torch"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "style_transfer_tpu_torch_extra", sys)
    assert "style_transfer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "style_transfer_tpu.engine", sys)
    assert harness.forbidden_modules() == ["style_transfer_tpu"]
