"""The port's FedGenGMM activation monitor (``repro_torch.monitor``) against
the JAX package's, at internlm2-1.8b's smoke config on the CPU (and at
the recurrent families').

Deterministic stages run on carried-across state: the JAX model's weights
(``convert.model_params_from_jax``), the JAX monitor's projection and its
aggregated global GMM (``convert.monitor_from_jax``). Tolerances:

- features in float32 (both configs ``dtype=float32``): rtol/atol 1e-5
  (the same backbone as tests/test_torch_models.py, pooled and projected);
- scores under the same global GMM: rtol/atol 2e-4, the kernels' bound
  (tests/test_kernels.py); the port scores through ``log_prob_chunked``,
  the JAX package through ``GMM.log_prob``.

The projection is drawn from a torch generator, so it is held to its
distribution: N(0, 1/d_model) entries, mean within 5 standard errors of 0
and variance within 5 standard errors (sqrt(2/n) relative) of 1/d_model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.monitor import FedGMMMonitor as JaxMonitor
from repro.monitor import MonitorConfig as JaxMonitorConfig
from repro.monitor import extract_features as jax_extract
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, monitor_from_jax
from repro_torch.models import init_params, transformer
from repro_torch.monitor import (FedGMMMonitor, MonitorConfig,
                                 extract_features, feature_projection)

SMALL = dict(k_local=2, k_global=4, h=50)


@pytest.fixture(scope="module")
def carried():
    """f32 configs of both packages, the JAX weights and the port's copy."""
    jc = dataclasses.replace(jax_config("internlm2-1.8b", "smoke"),
                             dtype=jnp.float32)
    tc = dataclasses.replace(get_config("internlm2-1.8b", "smoke"),
                             dtype=torch.float32)
    params = jax_init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    return jc, tc, params, model


def traffic(rng, n, s, ood=False, vocab=512):
    """In-distribution tokens (zipf-ish, ids below 100) or uniform high
    ids, as tests/test_monitor.py draws them."""
    if ood:
        return rng.integers(400, vocab, (n, s)).astype(np.int32)
    return rng.zipf(1.5, size=(n, s)).clip(0, 99).astype(np.int32)


def test_extract_features_matches_jax(carried):
    jc, tc, params, model = carried
    proj = np.array(jax.random.normal(jax.random.key(3), (jc.d_model, 32))
                      / np.sqrt(jc.d_model), dtype=np.float32)
    toks = traffic(np.random.default_rng(0), 6, 24)
    want = jax_extract(params, jc, {"tokens": jnp.asarray(toks)},
                       jnp.asarray(proj))
    got = extract_features(model, tc, {"tokens": toks},
                           torch.as_tensor(proj))
    assert got.shape == (6, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_score_matches_jax_under_the_same_global_gmm(carried):
    jc, tc, params, model = carried
    rng = np.random.default_rng(1)
    jmon = JaxMonitor(jc, JaxMonitorConfig(**SMALL))
    for cid in range(3):
        for _ in range(2):
            jmon.observe(cid, params,
                         {"tokens": jnp.asarray(traffic(rng, 8, 16))})
    g = jmon.aggregate()
    mon = monitor_from_jax(tc, MonitorConfig(**SMALL), np.asarray(jmon.proj),
                           tuple(np.asarray(a) for a in
                                 (g.weights, g.means, g.covs)), device="cpu")
    for ood in (False, True):
        toks = traffic(rng, 10, 16, ood)
        want = jmon.score(params, {"tokens": jnp.asarray(toks)})
        got = mon.score(model, {"tokens": toks})
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_recurrent_features_and_scores_match_jax(arch):
    """The recurrent families' pooled features (f32 1e-5) and scores
    under the JAX monitor's global GMM (2e-4)."""
    jc = dataclasses.replace(jax_config(arch, "smoke"), dtype=jnp.float32)
    tc = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    params = jax_init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    rng = np.random.default_rng(5)
    jmon = JaxMonitor(jc, JaxMonitorConfig(**SMALL))
    jmon.observe(0, params, {"tokens": jnp.asarray(traffic(rng, 12, 16))})
    g = jmon.aggregate()
    mon = monitor_from_jax(tc, MonitorConfig(**SMALL), np.asarray(jmon.proj),
                           tuple(np.asarray(a) for a in
                                 (g.weights, g.means, g.covs)), device="cpu")
    toks = traffic(rng, 8, 16, ood=True)
    with torch.no_grad():
        got = extract_features(model, tc, {"tokens": toks}, mon.proj)
        scores = mon.score(model, {"tokens": toks})
    want = jax_extract(params, jc, {"tokens": jnp.asarray(toks)}, jmon.proj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        scores, jmon.score(params, {"tokens": jnp.asarray(toks)}),
        rtol=2e-4, atol=2e-4)


def test_monitor_end_to_end():
    """tests/test_monitor.py's check on the port: four clients observe
    in-distribution traffic; OOD traffic scores higher in the median."""
    cfg = get_config("internlm2-1.8b", "smoke")
    model = init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    mon = FedGMMMonitor(cfg, MonitorConfig(**SMALL), device="cpu")
    for cid in range(4):
        for _ in range(4):
            mon.observe(cid, model, {"tokens": traffic(rng, 8, 32)})
    g = mon.aggregate()
    assert g.n_components == 4
    id_scores = mon.score(model, {"tokens": traffic(rng, 16, 32)})
    ood_scores = mon.score(model, {"tokens": traffic(rng, 16, 32, ood=True,
                                                     vocab=cfg.vocab_size)})
    assert np.all(np.isfinite(id_scores)) and id_scores.shape == (16,)
    assert np.median(ood_scores) > np.median(id_scores), \
        (np.median(id_scores), np.median(ood_scores))


def test_features_shape_and_vision_offset():
    """(B, feature_dim) float32, finite; a vision config pools the final
    hidden states over the token positions after its prefix only."""
    cfg = get_config("internvl2-26b", "smoke")
    model = init_params(0, cfg, device="cpu")
    proj = feature_projection(cfg, MonitorConfig(), device="cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": traffic(rng, 4, 16),
             "prefix": rng.normal(0, 0.02, (4, cfg.n_prefix, cfg.d_model))
             .astype(np.float32)}
    f = extract_features(model, cfg, batch, proj)
    assert f.shape == (4, 32) and bool(torch.all(torch.isfinite(f)))
    x, offset = transformer._with_prefix(model, cfg, batch)
    assert offset == cfg.n_prefix and x.shape[1] == cfg.n_prefix + 16
    h, _, _ = transformer._backbone(model, cfg, x, torch.arange(
        x.shape[1], dtype=torch.float32))
    want = h[:, cfg.n_prefix:].float().mean(1) @ proj
    torch.testing.assert_close(f, want, rtol=0, atol=0)


@pytest.mark.parametrize("d_model", [256, 2048])
def test_projection_distribution(d_model):
    cfg = dataclasses.replace(get_config("internlm2-1.8b", "smoke"),
                              d_model=d_model)
    proj = feature_projection(cfg, MonitorConfig(), device="cpu").double()
    n = proj.numel()
    var = 1.0 / d_model
    assert proj.shape == (d_model, 32)
    assert abs(float(proj.mean())) < 5 * np.sqrt(var / n)
    assert abs(float(proj.var()) / var - 1) < 5 * np.sqrt(2.0 / n)
    # a shared seed gives every client the same basis; another seed another
    again = feature_projection(cfg, MonitorConfig(), device="cpu").double()
    assert torch.equal(proj, again)
    other = feature_projection(cfg, MonitorConfig(seed=1), device="cpu")
    assert not torch.equal(proj.float(), other)


def test_score_before_aggregate_raises():
    cfg = get_config("internlm2-1.8b", "smoke")
    mon = FedGMMMonitor(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="aggregate"):
        mon.score(init_params(0, cfg, device="cpu"),
                  {"tokens": np.zeros((1, 4), np.int32)})
