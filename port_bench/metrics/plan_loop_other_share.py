"""Share (%) of the window outside the six per-pass device stages'
fenced StageTimers (subbanding, dedispersing, single-pulse, FFT, lo
and hi stages): the plan loop's own host work, the drain, the
checkpoint saves, Python, and each call's finishing (sifting, and in
the default configuration refinement and folding)."""

DEVICE_STAGES = ("subbanding", "dedispersing", "single-pulse", "FFT",
                 "lo-accelsearch", "hi-accelsearch")


def read(ctx):
    w = ctx["window_s"]
    if w <= 0:
        return None
    dev = sum(ctx["stage_s"].get(s, 0.0) for s in DEVICE_STAGES)
    return 100.0 * (w - dev) / w
