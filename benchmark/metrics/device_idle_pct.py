"""The device's idle share of the profiled stretch, %: 100 less the union
of its operations' intervals over the stretch (first operation's start to
the last one's end)."""


def read(run):
    p = run.profile
    if p is None or not p.window_us:
        return None
    return 100.0 * (1.0 - p.busy_us / p.window_us)
