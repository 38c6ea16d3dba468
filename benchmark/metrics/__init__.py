"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``
(``<name>.py`` with ``read(ctx) -> float | None``), and :mod:`._kernels`,
the reduction of a profiler trace that they share. A reader returns None
where its cell gives it nothing to read, and raises where a kernel that the
configuration must launch is missing from the trace."""
