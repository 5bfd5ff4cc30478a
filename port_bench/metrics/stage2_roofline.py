"""Stage 2 (dedispersion) at its bytes bound: the float32 subbands
read once and every float32 trial row written once, for the traced
slice's passes, at 3.35 TB/s, over the profiler's device time of the
kernels whose name holds KERNEL (%)."""

from port_bench import bounds

KERNEL = "dedisperse_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    t = sum(d for n, _ts, d in tr["kernels"] if KERNEL in n) / 1e6
    if t <= 0 or not tr["passes"]:
        return None
    g = ctx["geom"]
    nbytes = sum(bounds.stage2_bytes(ctx["plan"][i].numsub, g.nsamp,
                                     ctx["plan"][i].downsamp,
                                     ctx["plan"][i].ndms)
                 for i in tr["passes"])
    return 100.0 * nbytes / bounds.HBM_BYTES_PER_S / t
