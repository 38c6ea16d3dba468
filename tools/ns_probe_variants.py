#!/usr/bin/env python3
"""Where the NS kernels' time goes: device times of deliberately broken
copies of the kernels.

    python3 tools/ns_probe_variants.py [VARIANT ...]

Copies this checkout's ``style_transfer_tpu_torch`` package once per
variant under ``style_transfer_tpu_torch/_build/probe/`` (gitignored),
applies the variant's edit to the copy's CUDA sources, builds every copy in
parallel, and times each with ``tools/ns_kernel_times.py`` in two rounds
(forward, then reversed). The broken variants compute wrong results (their
errors are printed and meaningless); only their times are of interest:

* ``baseline``: the kernels as they are;
* ``no_copies``: no operand copies from global memory into shared memory;
* ``no_split``: no TF32 head/tail split (the raw bits go to the MMAs);
* ``one_pass``: one MMA per product instead of 3xTF32's three.

Needs one CUDA device and nvcc; prints each copy's ptxas registers and
spills first.
"""

import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "style_transfer_tpu_torch" / "_build" / "probe"

# variant -> (file in csrc/, text, replacement)
EDITS = {
    "baseline": None,
    "no_copies": ("ns_sqrtm.cu", "  const int tid = threadIdx.x;\n  if (vec) {",
                  "  const int tid = threadIdx.x;\n  if (n > 0) return;\n  if (vec) {"),
    "no_split": ("ns_common.cuh", "  hi = to_tf32(x);\n  lo = to_tf32(x - __uint_as_float(hi));",
                 "  hi = __float_as_uint(x);\n  lo = hi;"),
    "one_pass": ("ns_common.cuh",
                 "  mma_tf32(d, a.lo, b.hi);\n  mma_tf32(d, a.hi, b.lo);\n  mma_tf32(d, a.hi, b.hi);",
                 "  mma_tf32(d, a.hi, b.hi);"),
}


def make(name):
    tree = OUT / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "style_transfer_tpu_torch", tree / "style_transfer_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    edit = EDITS[name]
    if edit:
        src = tree / "style_transfer_tpu_torch" / "csrc" / edit[0]
        text = src.read_text()
        if text.count(edit[1]) != 1:
            raise SystemExit(f"{name}: the text to edit is not in {edit[0]} exactly once")
        src.write_text(text.replace(edit[1], edit[2]))
    return tree


def ptxas_summary(log):
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"stt_nsk_[a-z_]+", m.group(1))
            t = re.search(r"ILi(\d+)E", m.group(1))
            name = (k.group(0) if k else m.group(1)) + (f"<{t.group(1)}>" if t else "")
        elif name and ("spill" in line or "registers" in line):
            yield f"   {name}: {line.strip().removeprefix('ptxas info    : ')}"


def main():
    names = sys.argv[1:] or list(EDITS)
    unknown = set(names) - set(EDITS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(EDITS)}")
    trees = [make(n) for n in names]
    t0 = time.time()
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from style_transfer_tpu_torch.ops.cuda import build; build.load(); "
             "print(build.library_path().with_suffix('.log').read_text())")
    procs = [subprocess.Popen([sys.executable, "-c", build, str(t)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for t in trees]
    built = []
    for name, tree, p in zip(names, trees, procs):
        out, _ = p.communicate()
        print(f"== build {name}: rc {p.returncode} at {time.time() - t0:.1f} s", flush=True)
        if p.returncode != 0:
            print(out[-3000:])
            continue
        print("\n".join(ptxas_summary(out)))
        built.append((name, tree))
    rc = 0 if len(built) == len(names) else 1
    for rnd in (built, built[::-1]):
        for name, tree in rnd:
            r = subprocess.run([sys.executable, str(ROOT / "tools" / "ns_kernel_times.py"),
                                str(tree)], capture_output=True, text=True)
            print(f"== {name}\n{r.stdout}{r.stderr[-2000:] if r.returncode else ''}",
                  flush=True)
            rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
