"""Share of a call's time in which no operation ran on the device:
100 x (1 - device busy a call / wall a call). Busy a call is the union of
the device operations' intervals over the profiled calls, from the trace,
over their number; wall a call is the mean latency of the same run's calls
after the profiler stopped (host clock), so the profiler's own host
overhead, 2-3x a single call, does not count as idle."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.untraced_ms:
        return None
    busy_ms = 1e3 * ctx.trace.busy_s / ctx.traced_calls
    wall_ms = sum(ctx.untraced_ms) / len(ctx.untraced_ms)
    return 100.0 * (1.0 - busy_ms / wall_ms)
