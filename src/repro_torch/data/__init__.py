"""Synthetic dataset analogues, PCA and normalization (numpy copies of
``repro.data``'s modules, so both packages get the same data from one
seed), the token pipeline of the transformer substrate, and the
out-of-core data sources (``sources``)."""
from repro_torch.data.datasets import REGISTRY, Dataset, load
from repro_torch.data.pca import PCAModel, fit_pca, transform_pca
from repro_torch.data.preprocess import MinMaxScaler, fit_minmax
from repro_torch.data.sources import (ArraySource, ConcatSource, DataSource,
                                      NpyFileSource, SyntheticGMMSource,
                                      as_source)
from repro_torch.data.tokens import Batch, batches, synthetic_stream

__all__ = ["REGISTRY", "Dataset", "load", "PCAModel", "fit_pca",
           "transform_pca", "MinMaxScaler", "fit_minmax", "Batch",
           "batches", "synthetic_stream",
           "ArraySource", "ConcatSource", "DataSource", "NpyFileSource",
           "SyntheticGMMSource", "as_source"]
