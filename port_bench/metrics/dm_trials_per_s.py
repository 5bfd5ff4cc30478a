"""DM trials of every pass completed in the window over the window's
seconds (from its start to the end of the first pass, or call, to end
after the deadline), with the sifting, refinement and folding of each
call that completed inside it: the survey plan's rate, so 4188 / this
is the card's seconds per Mock beam's search."""


def read(ctx):
    if ctx["trials"] <= 0 or ctx["window_s"] <= 0:
        return None
    return ctx["trials"] / ctx["window_s"]
