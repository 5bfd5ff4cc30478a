"""The hi stage's StageTimers seconds per 1000 DM trials of the
window."""


def read(ctx):
    s = ctx["stage_s"].get("hi-accelsearch", 0.0)
    if ctx["trials"] <= 0 or s <= 0:
        return None
    return s / (ctx["trials"] / 1000.0)
