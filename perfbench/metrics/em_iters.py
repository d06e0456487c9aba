"""The iterations that set a fit's length, averaged over the traced fits:
the most EM iterations of any client for a one-shot fit, the rounds for
DEM."""


def read(t):
    return sum(t.iterations) / len(t.iterations) if t.iterations else None
