"""Estimator facades of the port (port of ``repro/api/estimators.py``):
:class:`GMMEstimator`, :class:`KMeansEstimator`, the federated runners
:class:`FedGenGMM`, :class:`DEM`, :class:`FedEM` and :class:`FedKMeans`, the
strategy seam :func:`fit_federated`, and the scorers ``score`` /
``log_prob`` / ``bic``.

Each facade holds one validated :class:`FitConfig`, whose ``device``
(default ``"cuda"``) says where it runs, and dispatches on the type of what
it is handed, as the JAX package's facades do:

=====================  ==================================================
facade                 accepted inputs
=====================  ==================================================
``GMMEstimator.fit``   ``(N, d)`` array · ``DataSource``
``KMeansEstimator.fit``  ``(N, d)`` array · ``DataSource``
``score`` / ``log_prob`` / ``bic``  ``(N, d)`` array · ``DataSource``
``FedGenGMM.run``      ``ClientSplit`` · list of ``DataSource``
``DEM`` / ``FedEM`` / ``FedKMeans.run``  ``ClientSplit`` · list of ``DataSource``
=====================  ==================================================

Arrays (numpy or tensors) are moved to the device; a source streams its
blocks there. Seeds replace the JAX package's keys: an explicit ``seed=``
wins, else the config's. The federated runners take an uplink
``transform=`` (``repro_torch.fed.transforms``); ``FedGenGMM`` also takes
``dp=`` (a :class:`DPConfig`, its one-shot Gaussian release), and ``DEM``
and ``FedEM`` take ``async_policy=`` (buffered asynchronous rounds).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.config import (FitConfig, is_source, is_source_list,
                                     require_array_weights)
from repro_torch.core.dem import DEMResult, _resolve_init, dem_cfg
from repro_torch.core.em import (EMResult, bic_streaming, fit_gmm_bic_cfg,
                                 fit_gmm_cfg, log_prob_chunked,
                                 score_streaming)
from repro_torch.core.fedgen import (SYNTHETIC_MODES, FedGenResult,
                                     fedgengmm_cfg)
from repro_torch.core.gmm import GMM
from repro_torch.core.kmeans import KMeansResult, kmeans_fit_cfg
from repro_torch.core.privacy import DPConfig
from repro_torch.fed.async_runtime import run_policy
from repro_torch.fed.cohort import check_sampler_kind
from repro_torch.fed.runtime import FederationStrategy
from repro_torch.fed.strategies import (FedEMResult, FedKMeansResult,
                                        _resolve_fedkmeans_init,
                                        check_participation, fed_kmeans_cfg,
                                        fedem_cfg)


def _make_config(config: Optional[FitConfig], overrides: dict) -> FitConfig:
    """An explicit ``FitConfig``, field overrides on top of it (or of the
    defaults), or both."""
    cfg = config if config is not None else FitConfig()
    if not isinstance(cfg, FitConfig):
        raise TypeError(f"config must be a FitConfig, "
                        f"got {type(cfg).__name__}")
    if overrides:
        valid = {f.name for f in dataclasses.fields(FitConfig)}
        unknown = set(overrides) - valid
        if unknown:
            raise TypeError(f"unknown FitConfig field(s) {sorted(unknown)}; "
                            f"valid fields: {sorted(valid)}")
        cfg = cfg.replace(**overrides)
    return cfg


def _as_int(value, name: str, minimum: int = 1) -> int:
    if isinstance(value, bool) or int(value) != value:
        raise ValueError(f"{name} must be an integer, got {value!r}")
    if int(value) < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return int(value)


_INPUT_NAMES = {"array": "an (N, d) array", "source": "a DataSource",
                "sources": "a list of per-client DataSources",
                "split": "a ClientSplit"}


def _accept_names(accept: tuple) -> str:
    return " or ".join(_INPUT_NAMES[a] for a in accept)


def _is_split(data) -> bool:
    """A padded split of either package, or SplitClients."""
    return all(hasattr(data, f) for f in ("data", "mask", "sizes"))


def _classify(data, who: str, accept: tuple) -> str:
    """THE input-type dispatch: array | source | sources | split, with a
    pointed error naming what ``who`` accepts."""
    if is_source(data):
        kind = "source"
    elif _is_split(data):
        kind = "split"
    elif is_source_list(data):
        kind = "sources"
    elif isinstance(data, (list, tuple)):
        if not data:
            raise TypeError(
                f"{who}: got an empty {type(data).__name__} — "
                + ("need at least one client DataSource"
                   if "sources" in accept else
                   f"{who} accepts {_accept_names(accept)}"))
        if "sources" not in accept:
            raise TypeError(
                f"{who}: got a {type(data).__name__} — {who} accepts "
                f"{_accept_names(accept)}")
        raise TypeError(
            f"{who}: got a {type(data).__name__} that is not a list of "
            f"DataSources; federated clients must all be DataSource "
            f"instances (wrap resident shards in ArraySource)")
    elif hasattr(data, "shape") and hasattr(data, "ndim"):
        kind = "array"
    else:
        raise TypeError(
            f"{who}: cannot dispatch input of type {type(data).__name__}")
    if kind not in accept:
        raise TypeError(
            f"{who} accepts {_accept_names(accept)}, "
            f"got {_INPUT_NAMES[kind]}")
    return kind


def _check_weights(kind: str, sample_weight, who: str) -> None:
    """Sample weights are array-path-only by design."""
    if kind == "source":
        require_array_weights(sample_weight, who)


def _placed(gmm: GMM, data, sample_weight, cfg: FitConfig, who: str):
    """The model on the config's device, and the data: a source as it is,
    an (N, d) array as a float32 tensor there."""
    kind = _classify(data, who, ("array", "source"))
    _check_weights(kind, sample_weight, f"{who} over a DataSource")
    device = cfg.resolve_device()
    if kind == "source":
        return gmm.to(device), data, None, True
    x = torch.as_tensor(data, device=device).to(torch.float32)
    if x.ndim != 2:
        raise ValueError(f"expected (N, d) rows, got shape {tuple(x.shape)}")
    w = (None if sample_weight is None else
         torch.as_tensor(sample_weight, device=device).to(torch.float32))
    return gmm.to(device), x, w, False


# ----------------------------------------------------------------------
# Model-level scoring
# ----------------------------------------------------------------------

def score(gmm: GMM, data, sample_weight=None,
          config: Optional[FitConfig] = None) -> torch.Tensor:
    """Average log-likelihood of ``data`` (array or DataSource) under
    ``gmm`` (the paper's fitness score, Eq. 2), chunked per the config."""
    cfg = config if config is not None else FitConfig()
    gmm, x, w, src = _placed(gmm, data, sample_weight, cfg,
                             "repro.api.score")
    return score_streaming(gmm, x, w, chunk_size=cfg.resolve_chunk(src),
                           backend=cfg.backend)


def log_prob(gmm: GMM, data,
             config: Optional[FitConfig] = None) -> torch.Tensor:
    """Per-row mixture log density of an array or a DataSource -> (N,)
    (the anomaly scorer)."""
    cfg = config if config is not None else FitConfig()
    gmm, x, _, src = _placed(gmm, data, None, cfg, "repro.api.log_prob")
    return log_prob_chunked(gmm, x, chunk_size=cfg.resolve_chunk(src),
                            backend=cfg.backend)


def bic(gmm: GMM, data, sample_weight=None,
        config: Optional[FitConfig] = None) -> torch.Tensor:
    """Bayesian Information Criterion (lower is better) on an array or a
    DataSource, chunked per the config."""
    cfg = config if config is not None else FitConfig()
    gmm, x, w, src = _placed(gmm, data, sample_weight, cfg, "repro.api.bic")
    return bic_streaming(gmm, x, w, chunk_size=cfg.resolve_chunk(src),
                         backend=cfg.backend)


# ----------------------------------------------------------------------

def _kmeans_init_only(config: FitConfig, who: str) -> None:
    if config.init not in ("auto", "kmeans"):
        raise ValueError(f"{who} initializes from k-means; init must stay "
                         f"'auto' or 'kmeans', got {config.init!r}")


def _candidates(k_candidates) -> Optional[tuple]:
    return (None if k_candidates is None else tuple(
        _as_int(kc, "k_candidates entry") for kc in k_candidates))


class GMMEstimator:
    """EM-trained Gaussian mixture (the paper's TrainGMM). Fix ``k`` for a
    single fit, or pass ``k_candidates`` for BIC model selection (``bics_``
    then holds every candidate's score).

        est = GMMEstimator(k=8).fit(x)     # on the card
        est.score(x_test)
        GMMEstimator(k=8, chunk_size=65536).fit(NpyFileSource(path))
    """

    def __init__(self, k: Optional[int] = None, *,
                 k_candidates: Optional[Sequence[int]] = None,
                 config: Optional[FitConfig] = None, **overrides):
        if (k is None) == (k_candidates is None):
            raise ValueError("pass exactly one of k (single fit) or "
                             "k_candidates (BIC model selection)")
        self.k = None if k is None else _as_int(k, "k")
        self.k_candidates = _candidates(k_candidates)
        self.config = _make_config(config, overrides)
        _kmeans_init_only(self.config, "GMMEstimator")
        self.gmm_: Optional[GMM] = None
        self.result_: Optional[EMResult] = None
        self.bics_: Optional[dict[int, float]] = None

    def fit(self, data, *, sample_weight=None,
            init_gmm: Optional[GMM] = None,
            seed: Optional[int] = None) -> "GMMEstimator":
        """Fit on an (N, d) array or a DataSource (out of core).
        ``sample_weight`` is per-row (arrays only); ``init_gmm`` warm-starts
        EM (not with ``k_candidates``); ``seed`` overrides the config's.
        Returns ``self``."""
        kind = _classify(data, "GMMEstimator.fit", ("array", "source"))
        _check_weights(kind, sample_weight,
                       "GMMEstimator.fit over a DataSource")
        seed = self.config.seed if seed is None else seed
        if self.k_candidates is None:
            self.result_ = fit_gmm_cfg(seed, data, self.k, self.config,
                                       sample_weight, init_gmm)
            self.bics_ = None
        else:
            if init_gmm is not None:
                raise ValueError("init_gmm and k_candidates are exclusive "
                                 "(each candidate K needs its own init)")
            self.result_, self.bics_ = fit_gmm_bic_cfg(
                seed, data, self.k_candidates, self.config, sample_weight)
        self.gmm_ = self.result_.gmm
        return self

    def _fitted(self) -> GMM:
        if self.gmm_ is None:
            raise RuntimeError("estimator is not fitted; call fit() first")
        return self.gmm_

    def score(self, data, sample_weight=None) -> torch.Tensor:
        """Average log-likelihood of ``data`` under the fitted model."""
        return score(self._fitted(), data, sample_weight, self.config)

    def log_prob(self, data) -> torch.Tensor:
        """Per-row log density ``(N,)`` of ``data`` under the fitted model."""
        return log_prob(self._fitted(), data, self.config)

    def bic(self, data, sample_weight=None) -> torch.Tensor:
        """Bayesian information criterion of the fitted model on ``data``."""
        return bic(self._fitted(), data, sample_weight, self.config)


class KMeansEstimator:
    """Weighted Lloyd's algorithm with k-means++ seeding; ``n_init``
    restarts keep the lowest-inertia centers."""

    def __init__(self, k: int, *, n_init: int = 1,
                 config: Optional[FitConfig] = None, **overrides):
        self.k = _as_int(k, "k")
        self.n_init = _as_int(n_init, "n_init")
        self.config = _make_config(config, overrides)
        _kmeans_init_only(self.config, "KMeansEstimator")
        self.result_: Optional[KMeansResult] = None

    def fit(self, data, *, sample_weight=None,
            seed: Optional[int] = None) -> "KMeansEstimator":
        """Fit on an (N, d) array or a DataSource (streamed seeding and
        host-loop sweeps); ``sample_weight`` is per-row (arrays only),
        ``seed`` overrides the config's. Returns ``self``."""
        kind = _classify(data, "KMeansEstimator.fit", ("array", "source"))
        _check_weights(kind, sample_weight,
                       "KMeansEstimator.fit over a DataSource")
        seed = self.config.seed if seed is None else seed
        self.result_ = kmeans_fit_cfg(seed, data, self.k, self.config,
                                      sample_weight, self.n_init)
        return self

    def _result(self) -> KMeansResult:
        if self.result_ is None:
            raise RuntimeError("estimator is not fitted; call fit() first")
        return self.result_

    @property
    def centers_(self) -> torch.Tensor:
        """Fitted (k, d) cluster centers (best restart)."""
        return self._result().centers

    @property
    def assignments_(self) -> Optional[torch.Tensor]:
        """Per-row cluster index (N,); None after a DataSource fit (the
        only O(N) output is skipped out of core)."""
        return self._result().assignments

    @property
    def inertia_(self) -> torch.Tensor:
        """Weighted sum of squared distances to the assigned centers."""
        return self._result().inertia


class FedGenGMM:
    """The paper's one-shot federated pipeline (Algorithm 4.1): local EM per
    client, ONE round of (K_c, 2d+1) parameter blocks, server-side merge ->
    synthetic replay -> global refit. Fix ``k_clients``, or pass
    ``k_candidates`` for per-client BIC selection; fix ``k_global``, or
    leave it out for server-side BIC selection over ``k_candidates``.
    ``run`` takes a padded split (clients trained as one batch) or a list
    of per-client DataSources (each local fit streamed); ``synthetic``
    ("auto": "source" for source clients, "resident" for a split) says
    whether S is held on the device or replayed block by block.

    ``dp`` (a :class:`DPConfig`) releases every client's parameter block
    under the one-shot Gaussian mechanism, the whole budget in the one
    round; ``transform`` installs any uplink transform instead (not both).
    Pairwise masks are refused: the server reads each block."""

    def __init__(self, *, k_clients: Optional[int] = None,
                 k_global: Optional[int] = None,
                 k_candidates: Optional[Sequence[int]] = None,
                 h: int = 100, synthetic: str = "auto",
                 dp: Optional[DPConfig] = None, transform=None,
                 config: Optional[FitConfig] = None, **overrides):
        if k_clients is None and k_candidates is None:
            raise ValueError("pass k_clients (fixed local K) or "
                             "k_candidates (per-client BIC selection)")
        if k_global is None and k_candidates is None:
            raise ValueError("pass k_global (fixed global K) or "
                             "k_candidates (server-side BIC selection)")
        self.k_clients = (None if k_clients is None
                          else _as_int(k_clients, "k_clients"))
        self.k_global = (None if k_global is None
                         else _as_int(k_global, "k_global"))
        self.k_candidates = _candidates(k_candidates)
        if synthetic not in ("auto",) + SYNTHETIC_MODES:
            raise ValueError(f"synthetic must be 'auto', 'resident' or "
                             f"'source', got {synthetic!r}")
        self.h = _as_int(h, "h")
        self.synthetic = synthetic
        if dp is not None and transform is not None:
            raise ValueError(
                "pass dp (a DPConfig, sugar for a one-shot GaussianDP "
                "uplink transform) OR transform (any PayloadTransform), "
                "not both")
        if dp is not None:
            if not isinstance(dp, DPConfig):
                raise TypeError(
                    f"dp must be a DPConfig, got {type(dp).__name__}")
            transform = dp.transform()
        self.transform = transform
        self.config = _make_config(config, overrides)
        _kmeans_init_only(self.config, "FedGenGMM's local fits")
        self.result_: Optional[FedGenResult] = None

    def run(self, clients, *, seed: Optional[int] = None) -> FedGenResult:
        """Run over a ``ClientSplit`` (numpy, from either package's
        ``partition``), :class:`SplitClients`, or a list of per-client
        DataSources."""
        _classify(clients, "FedGenGMM.run", ("split", "sources"))
        seed = self.config.seed if seed is None else seed
        self.result_ = fedgengmm_cfg(seed, clients, self.config,
                                     self.k_clients, self.k_global,
                                     self.k_candidates, self.h,
                                     self.synthetic, self.transform)
        return self.result_

    @property
    def global_gmm_(self) -> GMM:
        """The fitted global model (after :meth:`run`)."""
        if self.result_ is None:
            raise RuntimeError("runner has no result; call run() first")
        return self.result_.global_gmm


class DEM:
    """The iterative distributed-EM baseline (§5.4): one round of
    sufficient-statistics aggregation per EM iteration. The init scheme is
    ``FitConfig.init`` ("auto" = "fed-kmeans" on a split, "separated" on
    sources, or "separated", "pilot");
    ``FitConfig.max_iter`` bounds the rounds. ``transform`` is the uplink
    transform; ``async_policy`` (:class:`repro_torch.fed.AsyncPolicy`) runs
    the rounds buffered-asynchronously. ``run`` returns a
    :class:`repro_torch.core.dem.DEMResult`."""

    def __init__(self, k: int, *, transform=None, async_policy=None,
                 config: Optional[FitConfig] = None, **overrides):
        self.k = _as_int(k, "k")
        self.transform = transform
        self.async_policy = async_policy
        self.config = _make_config(config, overrides)
        _resolve_init(self.config.init)
        self.result_: Optional[DEMResult] = None

    def run(self, clients, *, seed: Optional[int] = None) -> DEMResult:
        """Run distributed EM to convergence (or ``max_iter`` rounds) over
        a padded ``ClientSplit`` or a list of per-client DataSources
        ("auto" init is then "separated"; "pilot" raises)."""
        _classify(clients, "DEM.run", ("split", "sources"))
        seed = self.config.seed if seed is None else seed
        self.result_ = dem_cfg(seed, clients, self.config, self.k,
                               transform=self.transform,
                               async_policy=self.async_policy)
        return self.result_

    @property
    def global_gmm_(self) -> GMM:
        """The fitted global model (after :meth:`run`)."""
        if self.result_ is None:
            raise RuntimeError("runner has no result; call run() first")
        return self.result_.global_gmm


class FedEM:
    """Iterative federated EM (Tian et al.): per round, each participating
    client runs ``local_epochs`` local EM steps from the broadcast model and
    ships sufficient statistics; the server M-steps. The defaults are DEM.
    ``participation`` in (0, 1] is the per-round cohort fraction,
    ``cohort`` how the round loop samples it ("cyclic" window, or "uniform"
    from ``cohort_seed``), and only the cohort computes; ``stragglers``
    (:class:`repro_torch.fed.ArrivalStragglers`) drops each round's slowest
    arrivals. Init, ``transform`` and ``async_policy`` as in
    :class:`DEM`."""

    def __init__(self, k: int, *, participation: float = 1.0,
                 local_epochs: int = 1, cohort: str = "cyclic",
                 cohort_seed: int = 0, stragglers=None, transform=None,
                 async_policy=None, config: Optional[FitConfig] = None,
                 **overrides):
        self.k = _as_int(k, "k")
        self.participation = check_participation(participation)
        self.local_epochs = _as_int(local_epochs, "local_epochs")
        self.cohort = check_sampler_kind(cohort)
        self.cohort_seed = _as_int(cohort_seed, "cohort_seed", minimum=0)
        self.stragglers = stragglers
        self.transform = transform
        self.async_policy = async_policy
        self.config = _make_config(config, overrides)
        _resolve_init(self.config.init)
        self.result_: Optional[FedEMResult] = None

    def run(self, clients, *, seed: Optional[int] = None) -> FedEMResult:
        """Run federated EM under the configured participation, cohort and
        straggler policy, with the cohort-sized ledger, over a split or a
        list of per-client DataSources."""
        _classify(clients, "FedEM.run", ("split", "sources"))
        seed = self.config.seed if seed is None else seed
        self.result_ = fedem_cfg(seed, clients, self.config, self.k,
                                 participation=self.participation,
                                 local_epochs=self.local_epochs,
                                 cohort=self.cohort,
                                 cohort_seed=self.cohort_seed,
                                 stragglers=self.stragglers,
                                 transform=self.transform,
                                 async_policy=self.async_policy)
        return self.result_

    @property
    def global_gmm_(self) -> GMM:
        """The fitted global model (after :meth:`run`)."""
        if self.result_ is None:
            raise RuntimeError("runner has no result; call run() first")
        return self.result_.global_gmm


class FedKMeans:
    """Iterative federated k-means (Garst et al.): per round, clients ship
    label statistics against the broadcast centers; the server recombines
    them and stops on the squared center shift (``FitConfig.tol`` through
    the k-means defaults, 1e-4 / 100 rounds). ``FitConfig.init`` is
    "auto"/"fed-kmeans" (one-shot warm start) or "separated";
    ``transform`` is the uplink transform."""

    def __init__(self, k: int, *, transform=None,
                 config: Optional[FitConfig] = None, **overrides):
        self.k = _as_int(k, "k")
        self.transform = transform
        self.config = _make_config(config, overrides)
        _resolve_fedkmeans_init(self.config.init)
        self.result_: Optional[FedKMeansResult] = None

    def run(self, clients, *,
            seed: Optional[int] = None) -> FedKMeansResult:
        """Run federated k-means to center convergence (or the round
        budget) over a split or a list of per-client DataSources."""
        _classify(clients, "FedKMeans.run", ("split", "sources"))
        seed = self.config.seed if seed is None else seed
        self.result_ = fed_kmeans_cfg(seed, clients, self.config, self.k,
                                      transform=self.transform)
        return self.result_

    @property
    def centers_(self) -> torch.Tensor:
        """The fitted global centers ``(k, d)`` (after :meth:`run`)."""
        if self.result_ is None:
            raise RuntimeError("runner has no result; call run() first")
        return self.result_.centers


# The named strategies of the round runtime, as facade constructors.
_STRATEGY_RUNNERS = {"fedgen": FedGenGMM, "dem": DEM, "fedem": FedEM,
                     "fedkmeans": FedKMeans}


def fit_federated(clients, *, strategy, seed: Optional[int] = None,
                  config: Optional[FitConfig] = None, max_rounds=None,
                  sampler=None, stragglers=None, transform=None,
                  async_policy=None, **kwargs):
    """The strategy seam of federated runs. ``strategy`` is a name
    ("fedgen" | "dem" | "fedem" | "fedkmeans"), whose facade is built from
    ``config`` and the other keyword arguments, or a
    :class:`repro_torch.fed.runtime.FederationStrategy` instance, which runs
    on the round loop directly with ``max_rounds`` (default: the config's
    EM round budget), ``sampler`` and ``stragglers``.

    ``transform`` installs an uplink transform on named and custom
    strategies alike. ``async_policy`` (an ``AsyncPolicy``) runs the rounds
    through the buffered asynchronous driver: for the iterative names
    ("dem", "fedem") or a custom iterative strategy."""
    if isinstance(strategy, str):
        if strategy not in _STRATEGY_RUNNERS:
            raise ValueError(
                f"unknown strategy {strategy!r}; named strategies are "
                f"{sorted(_STRATEGY_RUNNERS)} (or pass a "
                f"FederationStrategy instance)")
        if max_rounds is not None:
            raise TypeError(
                "max_rounds is for custom FederationStrategy instances; "
                "named strategies take FitConfig.max_iter")
        if sampler is not None:
            raise TypeError(
                "sampler is for custom FederationStrategy instances; "
                "named strategies build their own (FedEM: participation="
                "... with cohort='cyclic'|'uniform')")
        if stragglers is not None:
            kwargs["stragglers"] = stragglers
        if transform is not None:
            kwargs["transform"] = transform
        if async_policy is not None:
            if strategy not in ("dem", "fedem"):
                raise TypeError(
                    f"async_policy applies to the iterative strategies "
                    f"('dem', 'fedem'), not {strategy!r}")
            kwargs["async_policy"] = async_policy
        runner = _STRATEGY_RUNNERS[strategy](config=config, **kwargs)
        return runner.run(clients, seed=seed)
    if not isinstance(strategy, FederationStrategy):
        raise TypeError(
            f"strategy must be a name or a FederationStrategy, got "
            f"{type(strategy).__name__}")
    if kwargs:
        raise TypeError(f"unknown argument(s) for a custom strategy run: "
                        f"{sorted(kwargs)}")
    cfg = config if config is not None else FitConfig()
    if max_rounds is None:
        max_rounds = 1 if getattr(strategy, "one_shot", False) \
            else cfg.resolve_max_iter("em")
    kw = dict(seed=cfg.seed if seed is None else seed,
              device=cfg.resolve_device(), max_rounds=max_rounds,
              sampler=sampler, stragglers=stragglers, transform=transform)
    return run_policy(strategy, clients, async_policy, **kw)
