"""The whole fit's counted operations (its E-steps and Lloyd sweeps) over
the traced window's wall at the card's float32 peak, in %."""

from perfbench import work


def read(t):
    flops = sum(v[0] for v in t.work.values())
    if flops <= 0.0 or t.elapsed_s <= 0.0:
        return None
    return 100.0 * flops / (t.elapsed_s * work.PEAK_F32_FLOPS)
