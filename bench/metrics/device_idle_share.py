"""device_idle_share: % of the profiled window in which no operation ran
on the card: 1 - (union of every kernel, copy and fill interval) /
window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
