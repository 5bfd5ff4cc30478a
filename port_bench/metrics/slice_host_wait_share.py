"""Share (%) of the traced slice's wall in which the host was blocked
on the device: the program's host-wait:<site> spans (the stage
fences' synchronize, the pass drain's and the hi stage's
device-to-host copies), which the program opens as profiler ranges
while a profiler runs.  Over the 6-pass slice, not the window: a
share over the window would be another metric, under another name.
None where the program opens no such span."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["wall_s"] <= 0:
        return None
    waits = [d for n, _ts, d in tr["ranges"] if n.startswith("host-wait:")]
    if not waits:
        return None
    return 100.0 * sum(waits) / 1e6 / tr["wall_s"]
