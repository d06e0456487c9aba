"""The port's static-batching serving loop (``repro_torch.launch.serve``):
tests/test_serve.py's four cases on the CPU, the greedy tokens of the JAX
engine on the same carried-across weights and queue, the monitor hook and
the CLI.

The token comparison runs both configs in float32
(``dataclasses.replace(cfg, dtype=...)``), where logits agree to about
2e-6 (tests/test_torch_models.py), far inside the gaps between the top
two logits of these prompts, so greedy argmax picks the same tokens; the
test asserts that margin before it compares tokens.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeEngine as JaxServeEngine
from repro.models import init_params as jax_init_params
from repro.models import prefill_forward as jax_prefill
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import init_params


@pytest.fixture(scope="module")
def engine():
    cfg = get_config("internlm2-1.8b", "smoke")
    params = init_params(0, cfg, device="cpu")
    return ServeEngine(cfg, params, max_batch=3, max_context=96,
                       device="cpu")


def make_queue(n, rng, max_new=5, cls=Request):
    return [cls(i, rng.integers(0, 100, rng.integers(4, 17))
                .astype(np.int32), max_new) for i in range(n)]


def test_all_requests_served(engine):
    rng = np.random.default_rng(0)
    results = engine.serve(make_queue(7, rng))
    assert sorted(r.rid for r in results) == list(range(7))
    assert all(len(r.tokens) == 5 for r in results)


def test_respects_token_budget(engine):
    rng = np.random.default_rng(1)
    queue = [Request(0, rng.integers(0, 100, 8).astype(np.int32), 2),
             Request(1, rng.integers(0, 100, 8).astype(np.int32), 7)]
    by_rid = {r.rid: r for r in engine.serve(queue)}
    assert len(by_rid[0].tokens) == 2
    assert len(by_rid[1].tokens) == 7


def test_batching_deterministic_vs_solo(engine):
    """Greedy decode of a request does not depend on its same-length batch
    peers (left-padding shifts RoPE phases, so peers share the length)."""
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 100, 12).astype(np.int32)
    solo = engine.serve([Request(0, prompt, 4)])[0].tokens
    peers = [Request(1, rng.integers(0, 100, 12).astype(np.int32), 4),
             Request(2, prompt, 4),
             Request(3, rng.integers(0, 100, 12).astype(np.int32), 4)]
    batched = {r.rid: r.tokens for r in engine.serve(peers)}
    assert batched[2] == solo


def test_throughput_stats(engine):
    rng = np.random.default_rng(3)
    for r in engine.serve(make_queue(4, rng)):
        assert r.ttft_s > 0 and r.latency_s >= r.ttft_s


def test_greedy_tokens_equal_the_jax_engine():
    """The same weights (carried across) and the same queue of ragged
    prompts: every request gets the JAX engine's tokens, left pads and
    per-request budgets included."""
    jc = dataclasses.replace(jax_config("internlm2-1.8b", "smoke"),
                             dtype=jnp.float32)
    tc = dataclasses.replace(get_config("internlm2-1.8b", "smoke"),
                             dtype=torch.float32)
    params = jax_init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    rng = np.random.default_rng(4)
    queue = make_queue(7, rng, max_new=6, cls=JaxRequest)
    queue[2] = queue[2]._replace(max_new=3)
    # the first token's margin: top-2 logit gap of every prompt alone
    for r in queue:
        logits, _ = jax_prefill(params, jc, {"tokens": jnp.asarray(
            r.prompt[None])}, capacity=64)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        assert top2[1] - top2[0] > 1e-4
    want = JaxServeEngine(jc, params, max_batch=3, max_context=64) \
        .serve(queue)
    got = ServeEngine(tc, model, max_batch=3, max_context=64,
                      device="cpu").serve([Request(*r) for r in queue])
    assert [(r.rid, r.tokens) for r in got] == \
        [(r.rid, r.tokens) for r in want]
    assert len(got[2].tokens) == 3


def test_greedy_tokens_moe_equal_the_jax_engine():
    """deepseek-moe-16b's smoke config (a dense head layer, then MoE with a
    shared expert) at its own capacity factor: the JAX engine's tokens.
    A decode step routes the batch's tokens as one group, so peers share
    capacity in both engines alike."""
    jc = dataclasses.replace(jax_config("deepseek-moe-16b", "smoke"),
                             dtype=jnp.float32)
    tc = dataclasses.replace(get_config("deepseek-moe-16b", "smoke"),
                             dtype=torch.float32)
    params = jax_init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    rng = np.random.default_rng(6)
    queue = make_queue(7, rng, max_new=6, cls=JaxRequest)
    for r in queue:
        logits, _ = jax_prefill(params, jc, {"tokens": jnp.asarray(
            r.prompt[None])}, capacity=64)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        assert top2[1] - top2[0] > 1e-4
    want = JaxServeEngine(jc, params, max_batch=3, max_context=64) \
        .serve(queue)
    got = ServeEngine(tc, model, max_batch=3, max_context=64,
                      device="cpu").serve([Request(*r) for r in queue])
    assert [(r.rid, r.tokens) for r in got] == \
        [(r.rid, r.tokens) for r in want]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_greedy_tokens_recurrent_equal_the_jax_engine(arch):
    """The recurrent families (their decode states written in place) on
    the same weights and a ragged queue: the JAX engine's tokens. Each
    padded batch's top-2 first-logit gap is checked first."""
    jc = dataclasses.replace(jax_config(arch, "smoke"), dtype=jnp.float32)
    tc = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    params = jax_init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    rng = np.random.default_rng(8)
    queue = [JaxRequest(i, rng.integers(0, 100, n).astype(np.int32), 4)
             for i, n in enumerate((9, 14, 5, 14))]
    want = JaxServeEngine(jc, params, max_batch=2, max_context=32) \
        .serve(queue)
    eng = ServeEngine(tc, model, max_batch=2, max_context=32, device="cpu")
    for i in (0, 2):
        tokens, _ = eng._pad_batch(queue[i:i + 2])
        logits, _ = eng._prefill(model, {"tokens": tokens})
        top2 = torch.topk(logits, 2).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4
    got = eng.serve([Request(*r) for r in queue])
    assert [(r.rid, r.tokens) for r in got] == \
        [(r.rid, r.tokens) for r in want]


def test_monitor_observes_once_a_batch():
    class Counting:
        def __init__(self):
            self.calls = []

        def observe(self, cid, params, batch):
            self.calls.append((cid, tuple(batch["tokens"].shape)))

    cfg = get_config("internlm2-1.8b", "smoke")
    mon = Counting()
    eng = ServeEngine(cfg, init_params(0, cfg, device="cpu"), max_batch=3,
                      max_context=64, monitor=mon, device="cpu")
    queue = make_queue(7, np.random.default_rng(5), max_new=2)
    eng.serve(queue)
    assert [c for c, _ in mon.calls] == [0, 0, 0]
    assert [s[0] for _, s in mon.calls] == [3, 3, 1]


def test_engine_defaults_to_cuda_and_checks_the_model_device():
    cfg = get_config("internlm2-1.8b", "smoke")
    model = init_params(0, cfg, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="model is on"):
            ServeEngine(cfg, model)
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, model)


def test_cli(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--requests", "5",
                                      "--max-new", "3", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "served 5 requests / 15 tokens" in out and "on cpu" in out
