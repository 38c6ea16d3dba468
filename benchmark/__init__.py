"""The benchmark of ``style_transfer_tpu_torch`` on one NVIDIA H100.

One run is one cell of ``BENCHMARK.json`` (a configuration under a traffic
mix) run once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Layout, all found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: a configuration as it is run;
* ``traffic/<traffic>.json``: a traffic mix, the parameters that
  :mod:`benchmark.harness` reads (canvas sizes, chunks, iterations);
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``reference/``: the plain PyTorch reference that decides ``correct``
  and its lower-precision control;
* :mod:`benchmark.counts`: the work counts and the table of peaks.

Nothing here imports ``jax`` or the JAX package ``style_transfer_tpu``;
the reference imports nothing of ``style_transfer_tpu_torch`` either.
"""
