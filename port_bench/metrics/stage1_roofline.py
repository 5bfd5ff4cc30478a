"""Stage 1 (subband formation) at its bytes bound: the uint8 block
read once and the float32 subbands written once, for the traced
slice's passes, at 3.35 TB/s, over the profiler's device time of the
kernels whose name holds KERNEL (%)."""

from port_bench import bounds

KERNEL = "form_subbands_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    t = sum(d for n, _ts, d in tr["kernels"] if KERNEL in n) / 1e6
    if t <= 0 or not tr["passes"]:
        return None
    g = ctx["geom"]
    nbytes = sum(bounds.stage1_bytes(g.nchan, g.nsamp, ctx["plan"][i].numsub,
                                     ctx["plan"][i].downsamp)
                 for i in tr["passes"])
    return 100.0 * nbytes / bounds.HBM_BYTES_PER_S / t
