"""The hi stage at the problem's least work (%): for each DM row of
the window's passes, the FFT correlation's operations (one forward
FFT a segment and one inverse a (segment, z), 5 N log2 N each, at 67
TFLOP/s float32) or the spectrum read once and the candidates written
once (3.35 TB/s), whichever bounds, over the hi-accelsearch stage's
seconds.  No plane is counted, so the bound is the same whatever
implements the stage."""

from port_bench import bounds


def read(ctx):
    s = ctx["stage_s"].get("hi-accelsearch", 0.0)
    st = ctx["stated"]
    if s <= 0 or not st["run_hi_accel"]:
        return None
    g = ctx["geom"]
    t = sum(p.ndms * bounds.hi_row_bound_s(
        bounds.pass_nbins(g.nsamp, p.downsamp), st["hi_accel_zmax"],
        st["hi_accel_numharm"], st["topk_per_stage"])
        for p in ctx["passes"])
    return 100.0 * t / s
