"""Share (%) of the traced slice's wall in the program's
checkpoint-save spans (each pass's artifact save, its two fsyncs and
its journal line), which the program opens as profiler ranges while a
profiler runs.  Over the 6-pass slice, not the window: a share over
the window would be another metric, under another name.  None where
the program opens no such span."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["wall_s"] <= 0:
        return None
    saves = [d for n, _ts, d in tr["ranges"] if n == "checkpoint-save"]
    if not saves:
        return None
    return 100.0 * sum(saves) / 1e6 / tr["wall_s"]
