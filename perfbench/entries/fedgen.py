"""The one-shot entry: ``repro_torch.api.FedGenGMM.run`` on the cell's
padded split, the paper's Algorithm 4.1 (local fits of every client as one
batch, one upload of their models, merge, synthetic rows, global refit)."""
from __future__ import annotations

from contextlib import ExitStack, contextmanager

from perfbench import check, reference as ref


class Runner:
    """Builds the facade once from the configuration; ``fit`` is the call
    the window times."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from repro_torch.api import FedGenGMM
        from repro_torch.core.config import FitConfig
        fit = config["fit"]
        self.config = config
        self.est = FedGenGMM(
            k_clients=config["k_clients"], k_global=config["k_global"],
            h=config["h"], config=FitConfig(
                tol=fit["em_tol"], max_iter=fit["em_max_iter"],
                reg_covar=fit["reg_covar"],
                covariance_type=fit["covariance_type"], device=device))

    def fit(self, split, seed: int):
        return self.est.run(split, seed=seed)

    @staticmethod
    def iterations(result) -> int:
        """The EM iterations that set the local batch's length: the most
        any client ran."""
        return max(int(r.n_iter) for r in result.local_results)

    @staticmethod
    def form(result) -> dict:
        """The outputs in the judge's form."""
        return {"local": [(ref.Mixture(r.gmm.weights, r.gmm.means,
                                       r.gmm.covs), float(r.log_likelihood))
                          for r in result.local_results],
                "synthetic": result.synthetic,
                "global": ref.Mixture(result.global_gmm.weights,
                                      result.global_gmm.means,
                                      result.global_gmm.covs)}

    def numbers(self, form: dict, rows: list, split) -> dict:
        return check.fedgen_numbers(form, rows, split.sizes, self.config)

    @staticmethod
    def plain(data, mask, sizes, config, seed, prec) -> dict:
        """The plain pipeline in the program's place (the control)."""
        return ref.fedgen_plain(data, mask, sizes, config, seed, prec)

    @staticmethod
    @contextmanager
    def spans(span):
        """Spans around the round's two halves: ``local_fit`` around
        ``train_locals_cfg``, ``server_fit`` around ``aggregate_cfg``
        (merge, synthetic rows, refit)."""
        import repro_torch.core.fedgen as fedgen
        with ExitStack() as stack:
            for name, attr in (("local_fit", "train_locals_cfg"),
                               ("server_fit", "aggregate_cfg")):
                stack.enter_context(span.around(fedgen, attr, name))
            yield
