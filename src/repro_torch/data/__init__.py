"""Synthetic dataset analogues, PCA and normalization (numpy copies of
``repro.data``'s modules, so both packages get the same data from one
seed)."""
