"""The Lloyd sweeps' share of their roofline, in %: the least time of the
work handed to ``kmeans_sweep`` over the device time of its
``sweep_kernel`` launches and their ``reduce_kernel`` passes."""


def read(t):
    dev = t.family_s.get("sweep", 0.0)
    if "sweep" not in t.work or dev <= 0.0:
        return None
    return 100.0 * t.work["sweep"][2] / dev
