"""Train federated, publish per round, serve with hot model swap: the
paper's anomaly-detection story (§5.4) end to end on the port's serving
engine. The counterpart of ``examples/serve_anomaly.py`` with the same
clients, rounds and traffic.

A trainer thread runs distributed EM (``DEM``) over out-of-core clients
and PUBLISHES the global model after every communication round (a
delegating strategy wrapper and ``repro_torch.serve.ModelStore``). The main
thread serves a stream of scoring requests through
``repro_torch.api.Scorer``: each newly published round hot-swaps in between
batches, no request is dropped, and every batch of scores carries the
version (= round) of the model that produced it. The last batches, scored
by the converged model, separate in-distribution traffic from
out-of-distribution traffic.

    PYTHONPATH=src python examples/torch/serve_anomaly.py         # the card
    PYTHONPATH=src python examples/torch/serve_anomaly.py --device cpu
"""
import argparse
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.api import FitConfig, Scorer, fit_federated
from repro_torch.core.dem import DEMStrategy
from repro_torch.data.sources import ArraySource
from repro_torch.serve import ModelStore

D, K, CLIENTS = 6, 3, 4


class PublishEachRound:
    """Delegating strategy wrapper: identical federation math, plus one
    ``store.publish`` of the new global model after every server combine,
    the trainer side of the hot-swap protocol.

    ``fit_federated`` checks the ``FederationStrategy`` protocol with
    ``isinstance``, which since Python 3.12 looks the protocol's members up
    statically, past ``__getattr__``: they are spelled out here, and the
    rest of the strategy delegates."""

    one_shot = False

    def __init__(self, strategy, store):
        self._strategy = strategy
        self._store = store
        self._round = 0

    def __getattr__(self, name):
        return getattr(self._strategy, name)

    def init_state(self, seed, backend):
        """The wrapped strategy's initial state."""
        return self._strategy.init_state(seed, backend)

    def round_payload(self, backend, state):
        """The wrapped strategy's ledger entry of one round."""
        return self._strategy.round_payload(backend, state)

    def finalize(self, state, n_rounds, converged, comm):
        """The wrapped strategy's result."""
        return self._strategy.finalize(state, n_rounds, converged, comm)

    def server_combine(self, state, total):
        """The wrapped combine, then the new global model published."""
        state = self._strategy.server_combine(state, total)
        self._round += 1
        self._store.publish(state.gmm, {"round": self._round})
        time.sleep(0.3)   # stand-in for real client/network round latency
        return state


def main(argv=None) -> dict:
    """Run the example; return the numbers it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_anomaly.py: no CUDA card (torch.cuda."
                         "is_available() is False); pass --device cpu")
    rng = np.random.default_rng(0)
    mus = rng.normal(0, 5, (K, D)).astype(np.float32)

    # ---- 1. out-of-core clients: heterogeneous slices of one mixture ----
    clients = []
    for _ in range(CLIENTS):
        weights = rng.dirichlet(np.full(K, 0.5))
        y = rng.choice(K, 3000, p=weights)
        clients.append(ArraySource(
            (mus[y] + rng.normal(0, 0.7, (3000, D))).astype(np.float32)))

    with tempfile.TemporaryDirectory() as root:
        store = ModelStore(root, device=args.device)

        # fit_federated's strategy seam takes any FederationStrategy: the
        # wrapper rides the same runtime as the named "dem" strategy
        base = DEMStrategy(k=K, covariance_type="diag", backend="auto",
                           chunk=None, init="separated", tol=1e-4,
                           reg_covar=1e-6)
        failure = []

        def train():
            try:
                fit_federated(clients, strategy=PublishEachRound(base, store),
                              seed=0, config=FitConfig(device=args.device))
            except Exception as exc:   # re-raised by the main thread
                failure.append(exc)

        trainer = threading.Thread(target=train)
        trainer.start()
        try:
            # ---- 2. serve while training: hot swap as each round lands ---
            while store.latest_version() is None:   # wait for round 1
                if not trainer.is_alive():
                    break
                time.sleep(0.01)
            if failure or store.latest_version() is None:
                raise RuntimeError("the trainer published nothing") from (
                    failure[0] if failure else None)
            scorer = Scorer.from_checkpoint(root, "anomaly", slots=4,
                                            rows_per_slot=256,
                                            device=args.device)

            def id_rows():
                return (mus[rng.choice(K, 256)]
                        + rng.normal(0, 0.7, (256, D))).astype(np.float32)

            served = []
            while trainer.is_alive() or store.latest_version() > max(
                    (v for v, _ in served), default=0):
                scores = scorer.score(id_rows())
                served.append((scorer.model_version,
                               float(np.median(scores))))
                time.sleep(0.005)
        finally:
            trainer.join()
        if failure:
            raise failure[0]

        versions = [v for v, _ in served]
        print(f"served {len(served)} batches across model versions "
              f"{sorted(set(versions))} (hot-swapped "
              f"{len(set(versions)) - 1} times, zero requests dropped)")
        print("median anomaly score by round:",
              [f"v{v}:{s:.2f}"
               for v, s in served[:: max(1, len(served) // 6)]])

        # ---- 3. the converged detector: ID vs OOD traffic ----
        ood = rng.normal(14.0, 1.0, (256, D)).astype(np.float32)
        id_score = float(np.median(scorer.score(id_rows())))
        ood_score = float(np.median(scorer.score(ood)))
        print(f"in-distribution anomaly score:  {id_score:.2f}   (model "
              f"v{scorer.model_version})")
        print(f"out-of-distribution score:      {ood_score:.2f}   "
              f"(higher = flagged)")
        assert ood_score > id_score
        return {"batches": len(served),
                "versions": sorted(set(int(v) for v in versions)),
                "batch_versions": [int(v) for v in versions],
                "published": int(store.latest_version()),
                "final_version": int(scorer.model_version),
                "id_score": id_score, "ood_score": ood_score}


if __name__ == "__main__":
    main()
