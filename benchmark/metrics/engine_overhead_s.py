"""Per image, the engine's timed phases outside the chunks, from the
program's own ``engine.phase_totals`` over the measured window:
``targets``, ``scale-entry``, ``scale-exit``, ``final-image`` and each
scale's graph capture (the ``  capture@S`` rows, inside its first chunk).
Every such phase but ``final-image`` ends in a device sync."""

FAMILIES = ("targets", "scale-entry", "scale-exit", "final-image")


def read(ctx):
    phases = ctx.get("phases")
    if ctx["kind"] != "pyramid" or not phases:
        return None
    total = sum(s for name, s in phases.items()
                if name.startswith("  capture@") or name.split("@")[0] in FAMILIES)
    return total / ctx["images"]
