"""The plain reference: a float64 judge of a fit's outputs, and the plain
one-shot and DEM pipelines that stand in the program's place as the
control.

Nothing here imports the program. The judge takes the benchmark's own
inputs (the client rows) and the program's outputs (the models, their
log-likelihoods, the synthetic set), and works out again in float64 what
the outputs should satisfy: a model's average log-likelihood on its rows,
and what one more EM step from the model gains. The plain pipelines are
the paper's Algorithm 4.1 and distributed EM written out in float32 torch
operations, with the matmul identity of the E-step as scikit-learn writes
it, so that their precision can be lowered to TF32 for the control.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
BLOCK_ROWS = 16384
# Lloyd sweeps of the plain pipelines' k-means init
KMEANS_SWEEPS = 20


class Mixture(NamedTuple):
    """A diagonal Gaussian mixture: weights (K,), means (K, d), variances
    (K, d)."""
    weights: torch.Tensor
    means: torch.Tensor
    covs: torch.Tensor

    def to(self, dtype=None, device=None) -> "Mixture":
        return Mixture(*(t.to(device=device, dtype=dtype) for t in self))


# ----------------------------------------------------------------------
# The float64 judge
# ----------------------------------------------------------------------

def stats64(x: torch.Tensor, mix: Mixture, block: int = BLOCK_ROWS):
    """(log-likelihood sum, s0 (K,), s1 (K, d), s2 (K, d), rows) of ``mix``
    over the rows ``x (N, d)``, in float64 and in blocks of rows, with the
    direct form of the Gaussian density."""
    m = mix.to(torch.float64)
    logw = torch.log(m.weights)
    norm = -0.5 * (torch.log(m.covs).sum(-1) + x.shape[-1] * LOG_2PI)
    ll = torch.zeros((), dtype=torch.float64, device=x.device)
    s0 = torch.zeros_like(m.weights)
    s1 = torch.zeros_like(m.means)
    s2 = torch.zeros_like(m.means)
    for lo in range(0, x.shape[0], block):
        xb = x[lo:lo + block].to(torch.float64)
        diff = xb[:, None, :] - m.means[None]
        lp = logw + norm - 0.5 * (diff * diff / m.covs[None]).sum(-1)
        lse = torch.logsumexp(lp, dim=-1)
        r = torch.exp(lp - lse[:, None])
        ll += lse.sum()
        s0 += r.sum(0)
        s1 += r.T @ xb
        s2 += r.T @ (xb * xb)
    return ll, s0, s1, s2, x.shape[0]


def m_step64(s0, s1, s2, rows: int, reg_covar: float) -> Mixture:
    """The M-step the program states: weights from the responsibilities,
    means, and variances floored at 0 plus ``reg_covar``."""
    nk = torch.clamp(s0, min=1e-10)
    weights = s0 / rows
    weights = weights / weights.sum()
    means = s1 / nk[:, None]
    covs = torch.clamp(s2 / nk[:, None] - means * means, min=0.0) + reg_covar
    return Mixture(weights, means, covs)


def judge_model(x: torch.Tensor, mix: Mixture, reg_covar: float):
    """(average log-likelihood of ``mix`` on ``x``, and the gains in it of
    the next two float64 EM steps from ``mix``)."""
    lls = []
    for _ in range(3):
        ll, s0, s1, s2, n = stats64(x, mix)
        lls.append(float(ll / n))
        mix = m_step64(s0, s1, s2, n, reg_covar)
    return lls[0], lls[1] - lls[0], lls[2] - lls[1]


def mixture_moments(mix: Mixture):
    """Per feature: the mixture's E[x], E[x²] and Var(x²), in float64."""
    m = mix.to(torch.float64)
    w = m.weights[:, None]
    mu, var = m.means, m.covs
    e1 = (w * mu).sum(0)
    e2c = mu * mu + var
    e2 = (w * e2c).sum(0)
    e4 = (w * (mu ** 4 + 6 * mu * mu * var + 3 * var * var)).sum(0)
    return e1, e2, e4 - e2 * e2, e2 - e1 * e1


def synth_z(s: torch.Tensor, merged: Mixture) -> float:
    """The largest |z| over features of the synthetic rows' mean and mean
    square against the merged mixture they were drawn from."""
    e1, e2, var2, var1 = mixture_moments(merged)
    n = s.shape[0]
    s64 = s.to(torch.float64)
    z1 = (s64.mean(0) - e1) / torch.sqrt(var1 / n)
    z2 = ((s64 * s64).mean(0) - e2) / torch.sqrt(var2 / n)
    return float(torch.max(torch.cat([z1.abs(), z2.abs()])))


def merge(local: list, sizes) -> Mixture:
    """Algorithm 4.1's merge: every client's weights scaled by its share of
    the rows, all components concatenated, in float64."""
    sizes = np.asarray(sizes, dtype=np.float64)
    share = sizes / sizes.sum()
    w = torch.cat([m.weights.to(torch.float64) * float(p)
                   for m, p in zip(local, share)])
    return Mixture(w / w.sum(),
                   torch.cat([m.means.to(torch.float64) for m in local]),
                   torch.cat([m.covs.to(torch.float64) for m in local]))


# ----------------------------------------------------------------------
# The plain pipelines (the control runs them at a lower precision)
# ----------------------------------------------------------------------

def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """How the plain pipeline's matmuls run: ``float32``, or ``tf32``: both
    operands rounded to TF32 first, the products summed in float32, which
    is what the tensor cores do. cuBLAS's own TF32 switch is left off:
    for the pipeline's narrow shapes (K of 10 or 30 columns) it picks
    kernels that stay in float32."""

    def __init__(self, name: str):
        if name not in ("float32", "tf32"):
            raise ValueError(f"precision must be float32 or tf32: {name}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return to_tf32(a) @ to_tf32(b)
        return a @ b

    @contextmanager
    def active(self):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


def e_step(x, w, mix: Mixture, prec: Precision):
    """Batched E-step over x (B, N, d), w (B, N): (s0, s1, s2, loglik sum,
    weight sum), the log densities by the matmul identity."""
    inv = 1.0 / mix.covs
    a = prec.mm(x * x, inv.transpose(-1, -2))
    b = prec.mm(x, (mix.means * inv).transpose(-1, -2))
    c = (mix.means * mix.means * inv + torch.log(mix.covs)).sum(-1)
    lp = -0.5 * (a - 2.0 * b + c[..., None, :] + x.shape[-1] * LOG_2PI) \
        + torch.log(mix.weights)[..., None, :]
    lse = torch.logsumexp(lp, dim=-1)
    r = torch.exp(lp - lse[..., None]) * w[..., None]
    rt = r.transpose(-1, -2)
    return (r.sum(-2), prec.mm(rt, x), prec.mm(rt, x * x),
            (lse * w).sum(-1), w.sum(-1))


def m_step(s0, s1, s2, wsum, reg_covar: float) -> Mixture:
    nk = torch.clamp(s0, min=1e-10)
    weights = s0 / torch.clamp(wsum, min=1e-12)[..., None]
    weights = weights / weights.sum(-1, keepdim=True)
    means = s1 / nk[..., None]
    covs = torch.clamp(s2 / nk[..., None] - means * means, min=0.0) \
        + reg_covar
    return Mixture(weights, means, covs)


def em(x, w, mix: Mixture, tol: float, max_iter: int, reg_covar: float,
       prec: Precision):
    """Batched EM: every member steps while its |Δ average loglik| > tol and
    it has run fewer than ``max_iter`` steps; the loglik returned is the
    one of each member's last E-step."""
    prev = torch.full(x.shape[:1], -math.inf, dtype=x.dtype, device=x.device)
    ll = prev.clone()
    it = torch.zeros(x.shape[:1], dtype=torch.int64, device=x.device)
    active = torch.ones_like(it, dtype=torch.bool)
    while bool(active.any()):
        s0, s1, s2, lls, ws = e_step(x, w, mix, prec)
        new = m_step(s0, s1, s2, ws, reg_covar)
        keep = active[:, None]
        mix = Mixture(torch.where(keep, new.weights, mix.weights),
                      torch.where(keep[..., None], new.means, mix.means),
                      torch.where(keep[..., None], new.covs, mix.covs))
        prev = torch.where(active, ll, prev)
        ll = torch.where(active, lls / ws, ll)
        it = it + active.to(it.dtype)
        active = (it < max_iter) & ((ll - prev).abs() > tol)
    return mix, ll, it


def kmeans(x, w, k: int, gen: torch.Generator, sweeps: int,
           prec: Precision, seed_rows: int = 16384):
    """k-means++ seeding on up to ``seed_rows`` rows of each member drawn
    with their weights, then ``sweeps`` Lloyd sweeps over all rows: centers
    (B, k, d)."""
    b, n, d = x.shape
    rows = torch.arange(b, device=x.device)
    pick = torch.multinomial(w, min(seed_rows, n), replacement=True,
                             generator=gen)
    xs = x[rows[:, None], pick]
    centers = x.new_zeros((b, k, d))
    first = torch.randint(0, xs.shape[1], (b,), generator=gen,
                          device=x.device)
    centers[:, 0] = xs[rows, first]
    dmin = ((xs - centers[:, :1]) ** 2).sum(-1)
    for i in range(1, k):
        nxt = torch.multinomial(torch.clamp(dmin, min=1e-30), 1,
                                generator=gen)[:, 0]
        centers[:, i] = xs[rows, nxt]
        dmin = torch.minimum(dmin, ((xs - centers[:, i:i + 1]) ** 2).sum(-1))
    for _ in range(sweeps):
        lab = assign(x, centers, prec)
        oh = torch.nn.functional.one_hot(lab, k).to(x.dtype) * w[..., None]
        cnt = oh.sum(-2)
        sums = prec.mm(oh.transpose(-1, -2), x)
        centers = torch.where(cnt[..., None] > 0,
                              sums / torch.clamp(cnt, min=1e-12)[..., None],
                              centers)
    return centers


def assign(x, centers, prec: Precision) -> torch.Tensor:
    """Nearest center of every row by the matmul identity."""
    score = prec.mm(x, centers.transpose(-1, -2)) \
        - 0.5 * (centers * centers).sum(-1)[..., None, :]
    return score.argmax(-1)


def init_from_labels(x, w, centers, reg_covar: float,
                     prec: Precision) -> Mixture:
    """scikit-learn's init: hard k-means labels, then one M-step."""
    k = centers.shape[-2]
    oh = torch.nn.functional.one_hot(assign(x, centers, prec), k).to(
        x.dtype) * w[..., None]
    ot = oh.transpose(-1, -2)
    return m_step(oh.sum(-2), prec.mm(ot, x), prec.mm(ot, x * x),
                  w.sum(-1), reg_covar)


def fit_gmm(x, w, k: int, fit: dict, gen, prec: Precision):
    """A batch of GMM fits: k-means init, then EM."""
    centers = kmeans(x, w, k, gen, KMEANS_SWEEPS, prec)
    mix0 = init_from_labels(x, w, centers, fit["reg_covar"], prec)
    return em(x, w, mix0, fit["em_tol"], fit["em_max_iter"],
              fit["reg_covar"], prec)


def fedgen_plain(data, mask, sizes, config: dict, seed: int,
                 prec: Precision) -> dict:
    """Algorithm 4.1 in plain float32 torch: the clients' local fits as one
    batch, the merge, |S| = H·ΣK_c synthetic rows, the global refit. The
    result in the judge's form."""
    fit = config["fit"]
    gen = torch.Generator(device=data.device)
    gen.manual_seed(int(seed) % 2**63)
    with prec.active():
        local, ll, it = fit_gmm(data, mask, config["k_clients"], fit, gen,
                                prec)
        merged = merge([Mixture(*(t[c] for t in local))
                        for c in range(data.shape[0])], sizes).to(
                            torch.float32)
        n_synth = config["h"] * config["k_clients"] * data.shape[0]
        comp = torch.multinomial(merged.weights, n_synth, replacement=True,
                                 generator=gen)
        s = merged.means[comp] + torch.sqrt(merged.covs[comp]) * torch.randn(
            (n_synth, data.shape[-1]), generator=gen, device=data.device)
        g, _, _ = fit_gmm(s[None], torch.ones_like(s[None, :, 0]),
                          config["k_global"], fit, gen, prec)
    return {"local": [(Mixture(*(t[c] for t in local)), float(ll[c]))
                      for c in range(data.shape[0])],
            "synthetic": s, "global": Mixture(*(t[0] for t in g)),
            "n_iter": int(it.max())}


def dem_plain(data, mask, config: dict, seed: int, prec: Precision) -> dict:
    """Distributed EM in plain float32 torch from federated k-means centers
    (each client's k-means, then a size-weighted k-means of all clients'
    centers on the server), every component starting with the data's
    variance. Rounds are EM iterations over the union of the clients'
    rows. The result in the judge's form."""
    fit, k = config["fit"], config["k_global"]
    gen = torch.Generator(device=data.device)
    gen.manual_seed(int(seed) % 2**63)
    with prec.active():
        local = kmeans(data, mask, k, gen, KMEANS_SWEEPS, prec)
        lab = assign(data, local, prec)
        cnt = (torch.nn.functional.one_hot(lab, k).to(data.dtype)
               * mask[..., None]).sum(-2)
        pts = local.reshape(1, -1, data.shape[-1])
        centers = kmeans(pts, cnt.reshape(1, -1), k, gen,
                         KMEANS_SWEEPS, prec)[0]
        x = data[mask > 0][None]
        w = torch.ones_like(x[..., 0])
        mean = x[0].mean(0)
        var = ((x[0] - mean) ** 2).mean(0) + fit["reg_covar"]
        mix0 = Mixture(torch.full((1, k), 1.0 / k, device=data.device),
                       centers[None], var.expand(1, k, -1).contiguous())
        g, ll, it = em(x, w, mix0, fit["em_tol"], fit["em_max_iter"],
                       fit["reg_covar"], prec)
    return {"global": Mixture(*(t[0] for t in g)), "log_likelihood":
            float(ll[0]), "n_rounds": int(it[0])}
