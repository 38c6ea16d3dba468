"""The model FLOPs of all of an image's iterations over ``image_s``, as a
share of the configuration's peak."""


def read(ctx):
    if ctx["kind"] != "pyramid":
        return None
    return 100.0 * ctx["flops_per_image"] / ctx["image_s"] / ctx["peak"]
