"""The FFT and lo stages' StageTimers seconds (rfft, whitening, zap,
interbinning, harmonic sums, top-k, the host's candidates) per 1000
DM trials of the window."""


def read(ctx):
    s = ctx["stage_s"].get("FFT", 0.0) + ctx["stage_s"].get(
        "lo-accelsearch", 0.0)
    if ctx["trials"] <= 0 or s <= 0:
        return None
    return s / (ctx["trials"] / 1000.0)
