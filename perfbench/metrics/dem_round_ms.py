"""The traced DEM fits' wall over their rounds, in ms a round (the
federated k-means init included)."""


def read(t):
    rounds = sum(t.iterations)
    return 1e3 * t.elapsed_s / rounds if rounds else None
