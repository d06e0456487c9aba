"""Uplink payload transforms: DP noise, stochastic quantization and pairwise
secure-aggregation masks as one seam of the round loop (port of
``repro/fed/transforms.py``).

Every federated algorithm ships a per-client payload from ``local_step``
into a backend reduce. A :class:`PayloadTransform` intercepts exactly that
edge: the round loop applies it to every client's uplink between
``local_step`` and the reduce, and applies its ``finish`` to the summed
total before ``server_combine``. DP noise, quantization and masking are
instances of the same hook, so they compose (:class:`Compose`) and every
strategy (DEM, FedEM, FedKMeans, one-shot FedGenGMM) gets them.

Random streams. The JAX package folds a threefry key; torch's Philox cannot
reproduce ``fold_in``, so every stream here is a torch generator seeded by
``derive_seed`` along an explicit path. The round loop hands every client
the same :class:`UplinkKey` (the transform's seed and the round); a
client's draws for leaf ``t`` come from ``key.client_seed(idx, t)`` and a
pair's mask stream from ``key.pair_seed(lo, hi, t)``, so a client's draws
depend neither on the batch it rides in nor on the backend, and both
endpoints of a pair derive the same stream. Draws are made on the
payload's device; nothing moves to the host to draw.

Batched payloads. The resident split runs ``local_step`` on a batch of
clients at once, so its payload carries a leading client axis. ``apply``
takes ``idx`` as one global client index (a payload with no client axis)
or as a sequence of m indices (every leaf with a leading axis m); it draws
per client and per pair either way and does the arithmetic on the batch.

Every ``apply`` also takes ``draws``: the random draws to use instead of
the generators' (tests fill them with the JAX package's own draws).

Frozen dataclasses; the seed and every swept knob are ``compare=False``
fields, while ``bits`` and ``fp_bits`` are structural, as in the JAX
package (where that keeps sweeps from adding jit cache entries).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Protocol, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.core.config import derive_seed, make_generator
from repro_torch.core.em import _tree_leaves, _tree_map, wrap_int32

# Post-noise projection constants of the Gaussian release: the weight floor
# before simplex re-normalization, and the variance window for features
# normalized to [0, 1]^d (the variance of [0, 1] data is at most 1/4).
WEIGHT_FLOOR = 1e-4
VAR_MIN = 1e-5
VAR_MAX = 0.25


class UplinkKey(NamedTuple):
    """The shared key of one round's uplink (the port's ``fold_in(key(seed),
    round)``): the transform's seed, the round, and the stages of the
    :class:`Compose` pipelines it went through."""

    seed: int
    rnd: int
    stages: tuple = ()

    def stage(self, t: int) -> "UplinkKey":
        """The key of pipeline stage ``t``."""
        return self._replace(stages=self.stages + (int(t),))

    def client_seed(self, idx: int, leaf: int) -> int:
        """Seed of client ``idx``'s draws for leaf ``leaf``."""
        return derive_seed(self.seed, "uplink", self.rnd, int(idx),
                           *self.stages, int(leaf))

    def pair_seed(self, lo: int, hi: int, leaf: int) -> int:
        """Seed of the mask stream pair ``(lo, hi)`` shares for a leaf."""
        return derive_seed(self.seed, "uplink", self.rnd, *self.stages,
                           "pair", int(lo), int(hi), int(leaf))


def uplink_key(transform, rnd: int) -> UplinkKey:
    """Round ``rnd``'s shared key for ``transform``."""
    return UplinkKey(int(getattr(transform, "seed", 0)), int(rnd))


@runtime_checkable
class PayloadTransform(Protocol):
    """The uplink-transform contract (duck-typed; frozen dataclasses are
    the idiom).

    - ``traced() -> tuple``: the numeric knobs as scalars, handed back to
      ``apply`` as ``params`` (``apply`` reads them, never the fields).
    - ``apply(key, params, payload, idx, members, draws=None) -> wire``:
      transform one client's payload (``idx`` an index), or a batch of
      clients' (``idx`` a sequence, leaves with a leading client axis).
      ``key`` is the round's shared :class:`UplinkKey`; ``members`` the
      round's participating client indices.
    - ``finish(total) -> payload``: the server-side inverse on the reduced
      total (drop mask channels; identity for value-level transforms).
    - ``wire_itemsize(itemsize) -> int``: bytes an uplink element after
      the transform.
    - ``epsilon_per_round() -> float``: the privacy budget a round spends.
    """

    def traced(self) -> Any:
        """Sweepable numeric knobs as a tuple of scalars."""
        ...

    def apply(self, key, params, payload, idx, members, draws=None):
        """Transform ONE client's uplink payload."""
        ...

    def finish(self, total):
        """Server-side inverse on the reduced total (before combine)."""
        ...

    def wire_itemsize(self, itemsize: int) -> int:
        """Bytes per uplink element after the transform (ledger feed)."""
        ...

    def epsilon_per_round(self) -> float:
        """Privacy budget one round spends (0 for non-DP transforms)."""
        ...


# ----------------------------------------------------------------------
# Payload families (structural) and the batch convention
# ----------------------------------------------------------------------

def _is_gmm(p) -> bool:
    return all(hasattr(p, f) for f in ("weights", "means", "covs"))


def _is_gmm_release(p) -> bool:
    """FedGenGMM's one-shot uplink: a ``(gmm, n_samples)`` pair."""
    return isinstance(p, tuple) and len(p) == 2 and _is_gmm(p[0])


def _is_stats(p) -> bool:
    """EM ``SufficientStats``-shaped payload (DEM / FedEM uplink)."""
    return all(hasattr(p, f) for f in ("s0", "s1", "s2"))


def _require_diagonal(diagonal: bool, ndim: int, what: str):
    if not diagonal:
        raise ValueError(
            f"GaussianDP supports diagonal covariance; got a 'full' "
            f"covariance {what} (covs.ndim={ndim})")


def _client_ids(idx) -> tuple[list, bool]:
    """(global client indices, batched): an index means one client's
    payload; a sequence means a batch with a leading client axis."""
    arr = np.asarray(idx)
    if arr.ndim == 0:
        return [int(arr)], False
    return [int(i) for i in arr.reshape(-1)], True


def _client_shape(leaf: torch.Tensor, batched: bool) -> tuple:
    return tuple(leaf.shape[1:]) if batched else tuple(leaf.shape)


def _per_client(draw: Callable, key: UplinkKey, ids, batched: bool,
                leaf_no: int, like: torch.Tensor) -> torch.Tensor:
    """One draw per client from its own stream, stacked for a batch."""
    shape = _client_shape(like, batched)
    out = [draw(key.client_seed(i, leaf_no), shape, like) for i in ids]
    return torch.stack(out) if batched else out[0]


def _normal(seed: int, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=make_generator(seed, like.device),
                       dtype=like.dtype, device=like.device)


def _uniform(seed: int, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=make_generator(seed, like.device),
                      dtype=like.dtype, device=like.device)


# ----------------------------------------------------------------------
# Projection helpers
# ----------------------------------------------------------------------

def project_simplex(w: torch.Tensor, floor: float = WEIGHT_FLOOR):
    """Re-project noised mixture weights (last axis) to the simplex: floor
    at ``floor`` and renormalize."""
    w = torch.clamp_min(w, floor)
    return w / torch.sum(w, dim=-1, keepdim=True)


def clip_variances(var: torch.Tensor, lo: float = VAR_MIN,
                   hi: float = VAR_MAX):
    """Clip noised diagonal variances into [``lo``, ``hi``]."""
    return torch.clamp(var, lo, hi)


def gaussian_sigma(sensitivity: float, epsilon: float, delta: float) -> float:
    """Analytic Gaussian mechanism calibration on the host:
    ``sigma = sqrt(2 ln(1.25/delta)) * sensitivity / epsilon``."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / epsilon


# ----------------------------------------------------------------------
# Transforms
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Identity:
    """The no-op transform: the wire payload is the local payload (a run
    under it has the bits of a run with no transform)."""

    seed: int = dataclasses.field(default=0, compare=False)

    def traced(self):
        """No sweepable knobs: an empty tuple."""
        return ()

    def apply(self, key, params, payload, idx, members, draws=None):
        """Return the payload unchanged."""
        return payload

    def finish(self, total):
        """Return the reduced total unchanged."""
        return total

    def wire_itemsize(self, itemsize: int) -> int:
        """The payload dtype is untouched."""
        return itemsize

    def epsilon_per_round(self) -> float:
        """No privacy budget is spent."""
        return 0.0


@dataclasses.dataclass(frozen=True)
class GaussianDP:
    """Per-client analytic Gaussian mechanism on the uplink, with a
    per-round epsilon accountant.

    - A ``(gmm, n_samples)`` payload (FedGenGMM's one-shot uplink) gets a
      three-way split release: noised weights re-projected to the simplex,
      noised means clipped to [0, 1], noised variances clipped to
      [``VAR_MIN``, ``VAR_MAX``] (features normalized to [0, 1]^d).
    - A ``SufficientStats`` payload (DEM / FedEM) gets the same split over
      s0, s1, s2 with replace-one sensitivities sqrt(2), sqrt(2d), sqrt(2d);
      ``loglik`` and ``wsum`` are convergence telemetry and are not noised.
    - Anything else raises ``TypeError``.

    The instance carries the total budget ``(epsilon, delta)`` and the
    rounds it is split over; each round spends ``epsilon/rounds``, and the
    round loop multiplies that by the rounds run into
    ``CommStats.epsilon_spent``. One-shot FedGenGMM uses ``rounds=1``."""

    epsilon: float = dataclasses.field(default=1.0, compare=False)
    delta: float = dataclasses.field(default=1e-5, compare=False)
    rounds: int = dataclasses.field(default=1, compare=False)
    min_count: float = dataclasses.field(default=8.0, compare=False)
    seed: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if not float(self.epsilon) > 0.0:
            raise ValueError(f"epsilon must be > 0, got {self.epsilon}")
        if not 0.0 < float(self.delta) < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if int(self.rounds) < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if not float(self.min_count) > 0.0:
            raise ValueError(
                f"min_count must be > 0, got {self.min_count}")

    def traced(self):
        """``(eps_round, delta_round, min_count)``."""
        r = float(self.rounds)
        return (float(self.epsilon) / r, float(self.delta) / r,
                float(self.min_count))

    def epsilon_per_round(self) -> float:
        """Budget spent per realized round: ``epsilon / rounds``."""
        return float(self.epsilon) / float(self.rounds)

    def wire_itemsize(self, itemsize: int) -> int:
        """Noise does not change the payload dtype."""
        return itemsize

    def finish(self, total):
        """Value-level transform: the summed total needs no decoding."""
        return total

    def apply(self, key, params, payload, idx, members, draws=None):
        """Release an (eps_round, delta_round)-DP view of the payload.
        ``draws`` (standard normals, one per released leaf) replaces the
        clients' own streams ``key.client_seed(idx, 0..2)``."""
        eps_r, delta_r, min_count = params
        ids, batched = _client_ids(idx)
        if _is_gmm_release(payload):
            gmm, n = payload
            if batched:
                raise ValueError("a (gmm, n_samples) release is one "
                                 "client's: pass one client index")
            leaves = (gmm.weights, gmm.means, gmm.covs)
        elif _is_stats(payload):
            leaves = (payload.s0, payload.s1, payload.s2)
        else:
            raise TypeError(
                f"GaussianDP knows GMM parameter payloads ((gmm, n_samples) "
                f"pairs) and EM SufficientStats; got "
                f"{type(payload).__name__}")
        if draws is None:
            draws = tuple(_per_client(_normal, key, ids, batched, t, leaf)
                          for t, leaf in enumerate(leaves))
        if _is_gmm_release(payload):
            return self._release_gmm(gmm, n, eps_r, delta_r, min_count,
                                     draws), n
        return self._release_stats(payload, eps_r, delta_r, draws)

    def _release_gmm(self, gmm, n, eps_r, delta_r, min_count, draws):
        _require_diagonal(gmm.covs.ndim == gmm.means.ndim, gmm.covs.ndim,
                          "parameter release")
        zw, zm, zv = draws
        d = gmm.means.shape[-1]
        eps_each = eps_r / 3.0
        n = float(n)
        counts = torch.clamp_min(gmm.weights * n, min_count).unsqueeze(-1)
        sig_w = gaussian_sigma(math.sqrt(2.0) / max(n, 1.0), eps_each,
                               delta_r)
        w = project_simplex(gmm.weights + sig_w * zw)
        sig_m = gaussian_sigma(math.sqrt(float(d)), eps_each, delta_r)
        mu = torch.clamp(gmm.means + (counts.new_tensor(sig_m) / counts)
                         * zm, 0.0, 1.0)
        sig_v = gaussian_sigma(math.sqrt(float(d)) / 4.0, eps_each, delta_r)
        var = clip_variances(gmm.covs + (counts.new_tensor(sig_v) / counts)
                             * zv)
        return type(gmm)(w, mu, var)

    def _release_stats(self, stats, eps_r, delta_r, draws):
        _require_diagonal(stats.s2.ndim == stats.s1.ndim, stats.s2.ndim,
                          "statistics release")
        z0, z1, z2 = draws
        d = stats.s1.shape[-1]
        eps_each = eps_r / 3.0
        sig0 = gaussian_sigma(math.sqrt(2.0), eps_each, delta_r)
        sig12 = gaussian_sigma(math.sqrt(2.0 * d), eps_each, delta_r)
        return stats._replace(
            s0=torch.clamp_min(stats.s0 + sig0 * z0, 0.0),
            s1=stats.s1 + sig12 * z1,
            s2=torch.clamp_min(stats.s2 + sig12 * z2, 0.0))


@dataclasses.dataclass(frozen=True)
class StochasticQuantize:
    """Seeded stochastic rounding of every float leaf to an int8/int16 grid
    (simulated compression: the wire carries ``bits``-bit integers and one
    scale a leaf; the simulator ships the dequantized values, so the reduce
    stays a float sum).

    A client's leaf gets the grid ``scale = max|leaf| / (2^(bits-1) - 1)``
    and ``q = floor(x/scale + u)``, ``u ~ U[0, 1)`` (unbiased), clipped to
    the int range; non-float leaves pass through. ``wire_itemsize`` is 1
    for int8 and 2 for int16 (the scales ride the header, uncounted)."""

    bits: int = 8
    seed: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.bits not in (8, 16):
            raise ValueError(
                f"bits must be 8 or 16 (int8/int16 wire), got {self.bits}")

    def traced(self):
        """No sweepable knobs: an empty tuple."""
        return ()

    def epsilon_per_round(self) -> float:
        """Quantization spends no privacy budget."""
        return 0.0

    def wire_itemsize(self, itemsize: int) -> int:
        """The wire carries ``bits``-bit integers: 1 or 2 bytes an element."""
        return self.bits // 8

    def finish(self, total):
        """Dequantization happened per client; the float sum is the decoded
        aggregate."""
        return total

    def apply(self, key, params, payload, idx, members, draws=None):
        """Snap every float leaf to its seeded grid; leaf ``t``'s uniforms
        come from ``key.client_seed(idx, t)``, or from ``draws[t]``."""
        ids, batched = _client_ids(idx)
        leaves = _tree_leaves(payload)
        out = []
        for t, leaf in enumerate(leaves):
            if not (isinstance(leaf, torch.Tensor)
                    and leaf.dtype.is_floating_point):
                out.append(leaf)
                continue
            u = (draws[t] if draws is not None else
                 _per_client(_uniform, key, ids, batched, t, leaf))
            out.append(self._quantize(leaf, u, batched))
        it = iter(out)
        return _tree_map(lambda _: next(it), payload)

    def _quantize(self, leaf, u, batched: bool = False):
        qmax = float(2 ** (self.bits - 1) - 1)
        mag = leaf.abs()
        if not batched:
            scale = torch.amax(mag) / qmax
        elif leaf.ndim > 1:
            scale = torch.amax(mag, dim=tuple(range(1, leaf.ndim)),
                               keepdim=True) / qmax
        else:
            scale = mag / qmax
        safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.floor(leaf / safe + u), -qmax - 1.0, qmax)
        return torch.where(scale > 0.0, q * safe, leaf)


@dataclasses.dataclass(frozen=True)
class PairwiseMask:
    """Pairwise zero-sum secure-aggregation masks (Bonawitz et al.-style,
    simulated).

    Every pair of participating clients ``lo < hi`` shares the stream
    ``key.pair_seed(lo, hi, t)``: ``lo`` adds its draws and ``hi``
    subtracts them, so they cancel in the server's sum. Exact cancellation
    needs modular integers, so the wire channel carries
    ``round(x * 2^fp_bits) + mask (mod 2^32)`` a leaf as int32, and the
    backend's int32 sum (modulo 2^32, associative) returns exactly the
    summed fixed-point payload. The float payload rides beside it as the
    simulator's ground truth; ``finish`` hands exactly it to
    ``server_combine``, so a masked run has the bits of an unmasked one.

    Limits of the simulation: masks pair within the round's ``members``,
    so a straggler dropped after mask agreement leaves its partners' masks
    uncancelled; values beyond the ``2^31 / 2^fp_bits`` lattice saturate;
    and masking protects only a server that needs nothing but the sum, so
    the one-shot round refuses it (``additive_only``)."""

    fp_bits: int = 16
    seed: int = dataclasses.field(default=0, compare=False)

    additive_only = True

    def __post_init__(self):
        if not 0 <= int(self.fp_bits) <= 30:
            raise ValueError(
                f"fp_bits must be in [0, 30], got {self.fp_bits}")

    def traced(self):
        """No sweepable knobs: an empty tuple."""
        return ()

    def epsilon_per_round(self) -> float:
        """Masking spends no privacy budget."""
        return 0.0

    def wire_itemsize(self, itemsize: int) -> int:
        """One int32 lattice element replaces each payload element."""
        return 4

    def _pair_draw(self, key: UplinkKey, lo: int, hi: int, t: int,
                   shape: tuple, device) -> torch.Tensor:
        gen = make_generator(key.pair_seed(lo, hi, t), device)
        return torch.randint(-2**31, 2**31, shape, generator=gen,
                             dtype=torch.int32, device=device)

    def mask(self, key, payload, idx, members,
             draws: Optional[Callable] = None):
        """The clients' additive int32 masks, shaped like the payload:
        ``sum_j sign(idx, j) * draw(pair(idx, j))`` over ``members``
        (mod 2^32). Each pair's stream is drawn once, also when both its
        clients are in the batch. ``draws(lo, hi, t, shape)`` replaces the
        pair streams."""
        ids, batched = _client_ids(idx)
        mem = [int(j) for j in np.asarray(members).reshape(-1)]
        pairs = sorted({(min(i, j), max(i, j)) for i in ids for j in mem
                        if j != i})
        pos = {i: p for p, i in enumerate(ids)}
        out = []
        for t, leaf in enumerate(_tree_leaves(payload)):
            shape = _client_shape(leaf, batched)
            dev = leaf.device
            acc = torch.zeros((len(ids),) + shape, dtype=torch.int64,
                              device=dev)
            if pairs:
                fn = draws or (lambda lo, hi, t, shape: self._pair_draw(
                    key, lo, hi, t, shape, dev))
                d = torch.stack([fn(lo, hi, t, shape).to(dev)
                                 for lo, hi in pairs]).to(torch.int64)
                for end, sign in ((0, 1), (1, -1)):
                    sel = [p for p, pr in enumerate(pairs) if pr[end] in pos]
                    if sel:
                        at = torch.tensor([pos[pairs[p][end]] for p in sel],
                                          device=dev)
                        acc.index_add_(0, at, sign * d[torch.tensor(
                            sel, device=dev)])
            m = wrap_int32(acc)
            out.append(m if batched else m[0])
        it = iter(out)
        return _tree_map(lambda _: next(it), payload)

    def _lattice(self, leaf):
        """Fixed-point int32 view of a float leaf, saturating at the int32
        range (non-float leaves are taken as integers). The rounded value
        is clamped in float64 and cast through int64, so the saturation
        does not depend on how a device casts an out-of-range float."""
        if not leaf.dtype.is_floating_point:
            return leaf.to(torch.int32)
        scaled = torch.round(leaf * float(2 ** self.fp_bits))
        return torch.clamp(scaled.double(), -2.0**31, 2.0**31 - 1).to(
            torch.int64).to(torch.int32)

    def apply(self, key, params, payload, idx, members, draws=None):
        """``{"payload": floats, "secagg": lattice(payload) + mask}``."""
        masks = self.mask(key, payload, idx, members, draws)
        chan = _tree_map(lambda leaf, m: wrap_int32(
            self._lattice(leaf).to(torch.int64) + m.to(torch.int64)),
            payload, masks)
        return {"payload": payload, "secagg": chan}

    def finish(self, total):
        """Strip the (exactly cancelled) channel from the summed total."""
        return total["payload"]


@dataclasses.dataclass(frozen=True)
class Compose:
    """Apply transforms left to right on the uplink and undo their
    encodings right to left on the reduced total, e.g.
    ``Compose((GaussianDP(...), StochasticQuantize(8), PairwiseMask()))``:
    noise, then compress, then mask. Stage ``t`` draws under
    ``key.stage(t)``; the pipeline's seed combines the members' seeds;
    ``wire_itemsize`` folds through the stages and epsilons add."""

    transforms: tuple = ()

    def __post_init__(self):
        for t in self.transforms:
            if not callable(getattr(t, "apply", None)):
                raise TypeError(
                    f"Compose members must be PayloadTransforms, got "
                    f"{type(t).__name__}")

    @property
    def seed(self) -> int:
        """A deterministic combination of the member seeds."""
        return hash(tuple(int(getattr(t, "seed", 0))
                          for t in self.transforms)) & 0x7FFFFFFF

    @property
    def additive_only(self) -> bool:
        """True when any member only makes sense under a summed aggregate
        (e.g. :class:`PairwiseMask`)."""
        return any(getattr(t, "additive_only", False)
                   for t in self.transforms)

    def traced(self):
        """The members' knobs, in pipeline order."""
        return tuple(t.traced() for t in self.transforms)

    def epsilon_per_round(self) -> float:
        """Per-round budget spends add across the stages."""
        return sum(t.epsilon_per_round() for t in self.transforms)

    def wire_itemsize(self, itemsize: int) -> int:
        """Fold the per-stage dtype changes; the last change wins."""
        for t in self.transforms:
            itemsize = t.wire_itemsize(itemsize)
        return itemsize

    def apply(self, key, params, payload, idx, members, draws=None):
        """Chain the members' ``apply``; ``draws[t]`` feeds stage ``t``."""
        for t, (tr, pr) in enumerate(zip(self.transforms, params)):
            payload = tr.apply(key.stage(t), pr, payload, idx, members,
                               None if draws is None else draws[t])
        return payload

    def finish(self, total):
        """Undo the member encodings right to left."""
        for tr in reversed(self.transforms):
            total = tr.finish(total)
        return total
