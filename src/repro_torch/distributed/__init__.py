"""The mesh runtime of the port: the paper's communication patterns as
``torch.distributed`` collectives over a ``DeviceMesh`` (one all-gather for
FedGenGMM, one all-reduce a round for the iterative baselines), every
iterative loop served by the shared round driver
(``repro_torch.fed.runtime``)."""
from repro_torch.distributed.fed import (ShardedFedResult, dem_sharded,
                                         fed_kmeans_sharded, fedem_sharded,
                                         fedgen_sharded)

__all__ = ["ShardedFedResult", "dem_sharded", "fed_kmeans_sharded",
           "fedem_sharded", "fedgen_sharded"]
