"""The E-step's share of its roofline, in %: the least time the E-steps'
work could take on the card (its rows that carry weight, d and K; see
``perfbench/work.py``) over the device time of the ``estep_kernel``
launches and the ``reduce_kernel`` pass that follows each."""


def read(t):
    dev = t.family_s.get("estep", 0.0)
    if "estep" not in t.work or dev <= 0.0:
        return None
    return 100.0 * t.work["estep"][2] / dev
