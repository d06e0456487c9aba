"""Hand-written CUDA kernels for the EM hot path (ports of the Pallas
kernels in ``repro.kernels``).

* ``ops``: the model-level entry points (``gmm_logpdf``, ``gmm_log_prob``,
  ``estep_stats``, ``kmeans_assign``, ``kmeans_sweep``), which pack
  parameters and call the wrappers;
* ``gmm_logpdf``, ``estep_stats``, ``kmeans_assign``: one launch wrapper
  module per CUDA source, each with its ``launches`` count (``gmm_logpdf``
  also wraps the row log-density entry, ``log_prob_launches``;
  ``kmeans_assign`` the sweep kernel, ``sweep_launches``);
* ``ref``: the plain PyTorch versions;
* ``_build``: builds ``csrc/*.cu`` with nvcc at first use.
"""
from repro_torch.kernels import (estep_stats, gmm_logpdf, kmeans_assign, ops,
                                 ref)

# The names of ``repro.kernels.__all__``. ``estep_stats``, ``gmm_logpdf`` and
# ``kmeans_assign`` stay bound to the launch-wrapper modules (with their
# ``launches`` counts); the model-level functions of those names are
# ``ops.estep_stats``, ``ops.gmm_logpdf`` and ``ops.kmeans_assign``.
__all__ = ["estep_stats", "gmm_logpdf", "kmeans_assign", "ref", "ops"]
