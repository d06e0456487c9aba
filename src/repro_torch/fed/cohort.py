"""Cohort sampling, straggler handling and the staleness rule of the
federation runtime (port of ``repro/fed/cohort.py``).

- A **cohort sampler** gives ``cohort(rnd) -> (m,)`` sorted global client
  indices, the clients round ``rnd`` trains. :class:`CyclicSampler` is
  FedEM's deterministic window (round r takes ``[r·m, r·m + m) mod C``);
  :class:`UniformSampler` draws m distinct clients per round.
- A **straggler policy** gives ``drop_mask(rnd, cohort) -> (m,)`` 0/1
  weights: :class:`ArrivalStragglers` draws an arrival time per cohort
  member and drops the slowest ``drop_frac`` of them.
- A **staleness rule** gives ``weight(s)``, the weight of an update the
  asynchronous driver consumes ``s`` combines after its dispatch:
  :class:`PolynomialStaleness`.

The round loop runs on the host, so both return numpy arrays, computed on
the host before the round's clients launch. Random draws come from the
port's generators (``derive_seed`` / ``make_generator``), not threefry, so
they are held to the JAX package by their properties, not their values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.config import derive_seed, make_generator


def _validate_sizes(num_clients: int, cohort_size: int) -> None:
    if int(num_clients) < 1:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    if not 1 <= int(cohort_size) <= int(num_clients):
        raise ValueError(
            f"cohort_size must be in [1, num_clients={num_clients}], "
            f"got {cohort_size}")


@dataclasses.dataclass(frozen=True)
class CyclicSampler:
    """Deterministic cyclic cohorts: round ``rnd`` takes the window
    ``[rnd·m, rnd·m + m) mod C``. Cohorts are non-empty and cover every
    client within one cycle (period ``C / gcd(C, m)``)."""

    num_clients: int
    cohort_size: int

    name = "cyclic"

    def __post_init__(self):
        _validate_sizes(self.num_clients, self.cohort_size)

    def cohort(self, rnd: int) -> np.ndarray:
        c, m = self.num_clients, self.cohort_size
        start = (int(rnd) * m) % c
        return np.sort((start + np.arange(m, dtype=np.int64)) % c)


@dataclasses.dataclass(frozen=True)
class UniformSampler:
    """Seeded uniform sampling without replacement: round ``rnd`` draws
    ``m`` distinct clients from ``derive_seed(seed, "cohort", rnd)``."""

    num_clients: int
    cohort_size: int
    seed: int = dataclasses.field(default=0, compare=False)

    name = "uniform"

    def __post_init__(self):
        _validate_sizes(self.num_clients, self.cohort_size)

    def cohort(self, rnd: int) -> np.ndarray:
        gen = make_generator(derive_seed(self.seed, "cohort", int(rnd)))
        perm = torch.randperm(self.num_clients, generator=gen)
        return np.sort(perm[:self.cohort_size].numpy().astype(np.int64))


def check_sampler_kind(kind: str) -> str:
    """The sampler names :func:`make_sampler` takes."""
    if kind not in ("cyclic", "uniform"):
        raise ValueError(
            f"cohort sampler must be 'cyclic' or 'uniform', got {kind!r}")
    return kind


def make_sampler(kind: str, num_clients: int, cohort_size: int,
                 seed: int = 0):
    """Sampler by name, the spelling the facades use: ``"cyclic"`` or
    ``"uniform"`` (seeded, without replacement)."""
    if check_sampler_kind(kind) == "cyclic":
        return CyclicSampler(int(num_clients), int(cohort_size))
    return UniformSampler(int(num_clients), int(cohort_size), seed=int(seed))


@dataclasses.dataclass(frozen=True)
class PolynomialStaleness:
    """The staleness rule of the asynchronous driver
    (``repro_torch.fed.async_runtime.run_async``): an update consumed ``s``
    server versions after its dispatch weighs ``(1 + s)^-alpha`` (Xie et
    al.'s polynomial damping), the straggler rule generalized from {0, 1}
    to (0, 1]. The weight multiplies the client's additive payload, its
    ``wsum`` included, so the M-step renormalizes by the surviving mass.

    Fresh updates (``s = 0``) and ``alpha = 0`` weigh exactly 1.0, which
    keeps the zero-staleness configuration bit-identical to the
    synchronous loop."""

    alpha: float = 0.5

    def __post_init__(self):
        if not float(self.alpha) >= 0.0:
            raise ValueError(
                f"staleness alpha must be >= 0, got {self.alpha}")

    def weight(self, staleness: int) -> float:
        """Weight of an update consumed ``staleness`` versions late."""
        s = int(staleness)
        if s < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        if s == 0 or self.alpha == 0.0:
            return 1.0
        return float((1.0 + s) ** -float(self.alpha))


@dataclasses.dataclass(frozen=True)
class ArrivalStragglers:
    """Simulated round deadline: each cohort member draws an arrival time
    from ``derive_seed(seed, "arrival", rnd, client_id)``; the slowest
    ``drop_frac`` of the cohort miss the cutoff and get weight 0 (their
    payload never enters the round's sum, and the server's M-step
    renormalizes by the surviving ``wsum``). At least one client survives.
    Keying by global client id makes a client's luck independent of the
    cohort it lands in."""

    drop_frac: float
    seed: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if not 0.0 <= float(self.drop_frac) < 1.0:
            raise ValueError(
                f"drop_frac must be in [0, 1), got {self.drop_frac}")

    def n_keep(self, cohort_size: int) -> int:
        """Survivors per round."""
        m = int(cohort_size)
        return max(1, m - int(round(float(self.drop_frac) * m)))

    def drop_mask(self, rnd: int, cohort) -> np.ndarray:
        cohort = np.asarray(cohort)
        keep = self.n_keep(len(cohort))
        arrival = np.array([
            float(torch.rand((), generator=make_generator(derive_seed(
                self.seed, "arrival", int(rnd), int(i)))))
            for i in cohort])
        # keep the `keep` earliest arrivals: cutoff = keep-th order stat
        cutoff = np.sort(arrival)[keep - 1]
        return (arrival <= cutoff).astype(np.float32)
