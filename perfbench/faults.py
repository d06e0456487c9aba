"""Faults planted in the program under the timed path, for the checks that
``correct`` comes out false when the fit is wrong (``perfbench/tests`` and
``perfbench/calibrate.py``). Each is a context manager that patches the
port's own functions and restores them:

* ``unchanged``: an EM step (a DEM round's M-step) returns its state;
* ``half``: half of each batch is left out, the means taken over the
  rest: every other row of each local and global fit's E-step, the second
  half of the clients in the merge and in a DEM round;
* ``altered``: the answer is altered where it is produced: one component
  of the returned global model moves by one standard deviation.

A cell on one card has no exchange between cards to leave out.
"""
from __future__ import annotations

from contextlib import ExitStack, contextmanager


@contextmanager
def _patched(obj, attr: str, fn):
    old = getattr(obj, attr)
    setattr(obj, attr, fn(old))
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _unchanged_em(em_step):
    def step(gmm, *args, **kwargs):
        _, ll = em_step(gmm, *args, **kwargs)
        return gmm, ll
    return step


def _unchanged_round(server_combine):
    def combine(self, state, stats):
        return server_combine(self, state, stats)._replace(gmm=state.gmm)
    return combine


def _half_rows(e_step_stats):
    def stats(gmm, x, sample_weight=None, *args, **kwargs):
        import torch
        keep = (torch.arange(x.shape[-2], device=x.device) % 2 == 0).to(
            x.dtype)
        w = keep if sample_weight is None else sample_weight * keep
        return e_step_stats(gmm, x, w, *args, **kwargs)
    return stats


def _half_round(local_step):
    def step(self, state, x, w, idx):
        if w is not None and w.ndim == 2 and w.shape[0] > 1:
            w = w.clone()
            w[w.shape[0] // 2:] = 0.0
        return local_step(self, state, x, w, idx)
    return step


def _half_clients(merge_gmms):
    def merge(gmms, sizes):
        half = max(1, len(gmms) // 2)
        return merge_gmms(list(gmms)[:half], list(sizes)[:half])
    return merge


def _moved(gmm):
    from repro_torch.core.gmm import GMM
    means = gmm.means.clone()
    means[..., 0, :] += gmm.covs[..., 0, :].sqrt()
    return GMM(gmm.weights, means, gmm.covs)


def _altered(finalize):
    def fin(self, *args, **kwargs):
        res = finalize(self, *args, **kwargs)
        return res._replace(global_gmm=_moved(res.global_gmm))
    return fin


@contextmanager
def planted(name: str):
    """Plant the fault ``name`` in the program for the block's duration."""
    import repro_torch.core.dem as dem
    import repro_torch.core.em as em
    import repro_torch.core.fedgen as fedgen
    with ExitStack() as stack:
        if name == "unchanged":
            stack.enter_context(_patched(em, "em_step", _unchanged_em))
            stack.enter_context(_patched(dem.DEMStrategy, "server_combine",
                                         _unchanged_round))
        elif name == "half":
            stack.enter_context(_patched(em, "e_step_stats", _half_rows))
            stack.enter_context(_patched(dem.DEMStrategy, "local_step",
                                         _half_round))
            stack.enter_context(_patched(fedgen, "merge_gmms",
                                         _half_clients))
        elif name == "altered":
            stack.enter_context(_patched(fedgen.FedGenStrategy, "finalize",
                                         _altered))
            stack.enter_context(_patched(dem.DEMStrategy, "finalize",
                                         _altered))
        else:
            raise ValueError(f"no fault {name!r}")
        yield


FAULTS = ("unchanged", "half", "altered")
