"""The port's AdamW (``repro_torch.optim``) against ``repro.optim`` on the
same numpy trees and gradients, and tests/test_train.py's four AdamW cases
mirrored.

Tolerances (float32): the schedule to 1e-7 relative (both compute it in
float32; ``cos`` may differ by an ulp); the global norm to 1e-6 relative
(the port sums per-leaf norms, the reference per-leaf sums of squares);
``m``, ``v`` and the parameters after each of 3 steps to rtol 1e-5, atol
1e-7 (the updates are the same float32 ops, rounded apart by an ulp where
torch fuses ``a + alpha * b``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadam
from repro_torch.optim import (AdamWConfig, apply_updates, global_norm,
                               init_opt_state, schedule)

SHAPES = {"embed": (11, 6), "layers": (2, 6, 5), "norm": (6,),
          "scalar": ()}
TIGHT = dict(rtol=1e-5, atol=1e-7)


def tree(rng, scale=1.0):
    return {k: (scale * rng.normal(0, 1, s)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("cfg", [
    AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5),
    AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3, clip_norm=100.0),
    AdamWConfig(lr=1e-1, weight_decay=0.0, warmup_steps=10,
                total_steps=100),
], ids=["clipped", "unclipped", "warmup_no_decay"])
def test_apply_updates_matches_jax(cfg):
    """3 steps on a tree of mixed shapes: params, m, v, step, grad_norm
    and lr after each."""
    rng = np.random.default_rng(0)
    p0 = tree(rng)
    jcfg = jadam.AdamWConfig(*cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jadam.init_opt_state(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = init_opt_state(tp)
    for _ in range(3):
        g = tree(rng, scale=3.0)
        jp, js, jm = jadam.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg)
        tp2, ts, tm = apply_updates(
            tp, {k: torch.tensor(v) for k, v in g.items()}, ts, cfg)
        assert all(tp2[k] is tp[k] for k in tp)       # updated in place
        assert ts["step"] == int(js["step"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-7)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **TIGHT)
            np.testing.assert_allclose(ts["m"][k].numpy(),
                                       np.asarray(js["m"][k]), **TIGHT)
            np.testing.assert_allclose(ts["v"][k].numpy(),
                                       np.asarray(js["v"][k]), **TIGHT)


@pytest.mark.parametrize("warmup,total", [(1, 10), (100, 10_000), (5, 5)])
def test_schedule_matches_jax(warmup, total):
    cfg = AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    jcfg = jadam.AdamWConfig(*cfg)
    for step in sorted({0, 1, warmup // 2, warmup, warmup + 1,
                        (warmup + total) // 2, total - 1, total,
                        total + 7}):
        want = float(jadam.schedule(jcfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(schedule(cfg, step), want, rtol=1e-7,
                                   atol=0)


def test_global_norm_matches_jax():
    g = tree(np.random.default_rng(1), scale=5.0)
    want = float(jadam.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    got = global_norm({k: torch.tensor(v) for k, v in g.items()})
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(
        float(global_norm([torch.tensor(v) for v in g.values()])), want,
        rtol=1e-6)


def test_init_opt_state_from_a_module():
    mod = torch.nn.Linear(3, 2)
    state = init_opt_state(mod)
    assert state["step"] == 0
    assert set(state["m"]) == set(state["v"]) == {"weight", "bias"}
    assert all(float(t.abs().sum()) == 0 and t.dtype == torch.float32
               for t in state["m"].values())


# tests/test_train.py::TestAdamW, mirrored

class TestAdamW:
    def test_minimizes_quadratic(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                          total_steps=200)
        params = {"w": torch.tensor([5.0, -3.0])}
        state = init_opt_state(params)
        for _ in range(150):
            grads = {"w": 2 * params["w"]}
            params, state, _ = apply_updates(params, grads, state, cfg)
        assert float(params["w"].abs().max()) < 0.1

    def test_clip_norm(self):
        cfg = AdamWConfig(lr=1e-3, clip_norm=1.0)
        params = {"w": torch.zeros(3)}
        state = init_opt_state(params)
        _, _, m = apply_updates(params, {"w": torch.full((3,), 1e6)}, state,
                                cfg)
        assert float(m["grad_norm"]) > 1.0  # pre-clip norm reported

    def test_schedule_warmup_and_decay(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
        assert schedule(cfg, 5) < 1.0
        peak = schedule(cfg, 10)
        end = schedule(cfg, 100)
        assert peak > end
        assert end >= 0.1 * cfg.lr - 1e-6  # floor at 10%

    def test_weight_decay_shrinks(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=1,
                          total_steps=10)
        params = {"w": torch.tensor([10.0])}
        state = init_opt_state(params)
        p2, _, _ = apply_updates(params, {"w": torch.zeros(1)}, state, cfg)
        assert float(p2["w"][0]) < 10.0
