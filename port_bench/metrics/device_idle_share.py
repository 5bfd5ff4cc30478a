"""Share (%) of the traced slice's wall in which no operation ran on
the device: 1 - the union of the profiler's kernel, copy and set
intervals over the slice's seconds."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["wall_s"] <= 0 or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
