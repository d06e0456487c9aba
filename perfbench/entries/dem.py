"""The iterative entry: ``repro_torch.api.DEM.run`` on the cell's padded
split, distributed EM on the round runtime (one E-step of every client and
one server M-step a round), from the traffic's init scheme."""
from __future__ import annotations

from contextlib import contextmanager

from perfbench import check, reference as ref


class Runner:
    """Builds the facade once; ``fit`` is the call the window times."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from repro_torch.api import DEM
        from repro_torch.core.config import FitConfig
        fit = config["fit"]
        self.config = config
        self.est = DEM(config["k_global"], config=FitConfig(
            tol=fit["em_tol"], max_iter=fit["em_max_iter"],
            reg_covar=fit["reg_covar"],
            covariance_type=fit["covariance_type"], init=traffic["init"],
            device=device))

    def fit(self, split, seed: int):
        return self.est.run(split, seed=seed)

    @staticmethod
    def iterations(result) -> int:
        """The rounds, one EM iteration each."""
        return int(result.n_rounds)

    @staticmethod
    def form(result) -> dict:
        g = result.global_gmm
        return {"global": ref.Mixture(g.weights, g.means, g.covs),
                "log_likelihood": float(result.log_likelihood)}

    def numbers(self, form: dict, rows: list, split) -> dict:
        return check.dem_numbers(form, rows, self.config)

    @staticmethod
    def plain(data, mask, sizes, config, seed, prec) -> dict:
        return ref.dem_plain(data, mask, config, seed, prec)

    @staticmethod
    @contextmanager
    def spans(span):
        """A span ``dem_init`` around the federated k-means init."""
        import repro_torch.core.dem as dem
        with span.around(dem, "fed_kmeans_centers", "dem_init"):
            yield
