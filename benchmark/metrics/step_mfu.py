"""The step's model FLOPs per iteration over ``ms_per_iter``, as a share of
the configuration's peak (``counts.step_flops``, ``counts.peak_flops``)."""


def read(ctx):
    if ctx["kind"] != "step":
        return None
    return 100.0 * ctx["flops_per_iter"] / (ctx["ms_per_iter"] / 1e3) / ctx["peak"]
