"""The share of the traced window in which no operation ran on the card,
in %, from the profiler's trace."""


def read(t):
    if t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
