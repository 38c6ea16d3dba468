"""The share of the traced stretch in which no operation ran on the device,
for ``device_idle.step`` and ``device_idle.pyramid``."""


def read(ctx, kind):
    trace = ctx["trace"]
    if ctx["kind"] != kind or trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
