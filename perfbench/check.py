"""What decides ``correct``: the numbers the float64 judge of
``perfbench/reference.py`` reads from a fit's outputs, and their limits.

A fit's outputs come in one plain form, whoever made them (the program, or
the plain pipeline put in its place as the control):

* one-shot: ``local`` [(Mixture, reported average loglik)] a client,
  ``synthetic`` the server's rows S, ``global`` the refit Mixture;
* DEM: ``global`` Mixture and its reported ``log_likelihood``.

Every number is a gap, 0 when the outputs are exactly what they should be,
and each has its limit in ``perfbench/limits/<workload>.json``.
"""
from __future__ import annotations

import torch

from perfbench import reference as ref


def client_rows(split, device) -> list:
    """Each client's real (unpadded) rows as a float32 tensor on
    ``device``."""
    return [torch.as_tensor(split.data[c, :int(n)], device=device)
            for c, n in enumerate(split.sizes)]


def fedgen_numbers(form: dict, rows: list, sizes, config: dict) -> dict:
    """The one-shot fit's numbers:

    * ``local_ll_gap``: over clients, the widest gap between the average
      loglik a local fit reports and its model's on the client's rows,
      beyond what its last EM step may have gained (see ``ll_gap``);
    * ``local_em_gain``: the most one more EM step gains on a client, per
      row (a fit that stopped short, or never stepped, gains);
    * ``synth_rows``: |S| against H · ΣK_c;
    * ``synth_z``: S's mean and mean square against the merged mixture, as
      the largest |z| over features (the merge re-weights by |D_c|);
    * ``global_em_gain``: what one more EM step gains on the refit over S.
    """
    fit = config["fit"]
    gaps, gains = [], []
    for (mix, ll), x in zip(form["local"], rows):
        avg, g1, g2 = ref.judge_model(x, mix, fit["reg_covar"])
        gaps.append(ll_gap(ll, avg, g1, g2, fit["em_tol"]))
        gains.append(g1)
    s = form["synthetic"]
    merged = ref.merge([m for m, _ in form["local"]], sizes)
    want = config["h"] * sum(m.weights.shape[0] for m, _ in form["local"])
    _, g_gain, _ = ref.judge_model(s, form["global"], fit["reg_covar"])
    return {"local_ll_gap": max(gaps), "local_em_gain": max(gains),
            "synth_rows": abs(int(s.shape[0]) - want),
            "synth_z": ref.synth_z(s, merged), "global_em_gain": g_gain}


def ll_gap(reported: float, actual: float, g1: float, g2: float,
           tol: float) -> float:
    """How far a fit's reported average loglik lies from its model's own,
    beyond what its last EM step may have gained. A fit reports the loglik
    of its last E-step, taken before its last M-step, so a sound fit's gap
    is that last step's gain g. From the gains g1, g2 of the next two
    steps: where EM converges at a steady rate, g = g1² / g2 (the stopping
    rule keeps it under about ``tol``); where it speeds up again after a
    plateau, g < g1. The allowance is the larger of the two."""
    g1, g2 = max(g1, 0.0), max(g2, 0.0)
    steady = min(g1 * g1 / g2, tol) if g2 > 0.0 else 0.0
    return max(0.0, abs(reported - actual) - max(g1, steady))


def dem_numbers(form: dict, rows: list, config: dict) -> dict:
    """DEM's numbers: ``dem_ll_gap``, the gap between the average loglik it
    reports and its model's on the union of the clients' rows beyond what
    its last step may have gained (``ll_gap``), and ``dem_em_gain``, what
    one more EM step gains there."""
    fit = config["fit"]
    avg, g1, g2 = ref.judge_model(torch.cat(rows), form["global"],
                                  fit["reg_covar"])
    return {"dem_ll_gap": ll_gap(form["log_likelihood"], avg, g1, g2,
                                 fit["em_tol"]),
            "dem_em_gain": g1}


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [number, limit]}): correct when every number is
    finite and at most its limit. A number without a limit fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and value == value
                and value <= float(limit))
        ok = ok and good
        out[name] = [value, limit]
    return ok, out
