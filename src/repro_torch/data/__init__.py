"""Synthetic dataset analogues, PCA and normalization (numpy copies of
``repro.data``'s modules, so both packages get the same data from one
seed), and the out-of-core data sources (``sources``)."""
from repro_torch.data.sources import (ArraySource, ConcatSource, DataSource,
                                      NpyFileSource, SyntheticGMMSource,
                                      as_source)

__all__ = ["ArraySource", "ConcatSource", "DataSource", "NpyFileSource",
           "SyntheticGMMSource", "as_source"]
