"""The single-pulse stage's StageTimers seconds (detrend, boxcars,
top-k, the host's event dedup) per 1000 DM trials of the window."""


def read(ctx):
    s = ctx["stage_s"].get("single-pulse", 0.0)
    if ctx["trials"] <= 0 or s <= 0:
        return None
    return s / (ctx["trials"] / 1000.0)
