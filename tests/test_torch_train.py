"""The port's training path (``train_forward``, ``launch/steps.py``,
``launch/train.py``) against the JAX package's on the same numpy batches
and the same weights (the JAX ``init_params`` carried across by
``convert.model_params_from_jax``), at the registered smoke configs on
the CPU (the loss and gradient checks of the RG-LRU, xLSTM and
encoder-decoder configs run from their own test files).

Tolerances:

- float32 loss and metrics rtol/atol 1e-5;
- float32 gradients 1e-4 relative to each tensor's largest entry (``max
  |got - want| <= 1e-4 * max |want|``), over every leaf;
- three ``make_train_step`` steps, each from the reference's state:
  ``grad_norm`` and the losses 1e-5 relative, ``lr`` 1e-7, ``m`` and ``v``
  1e-4 relative to each tensor's largest entry, the step count exact.
  Adam divides ``m`` by ``sqrt(v)``, so an entry whose gradient is at
  rounding level moves by about ``lr`` with a sign the rounding picks: the
  parameters are held at rtol 1e-5, atol 1e-6 where the step's gradient is
  at least 1e-2 of its tensor's largest, and within ``2 * lr`` (two
  opposite Adam moves) elsewhere;
- bfloat16 loss atol 5e-2 (the substrate's bf16 bound,
  tests/test_torch_models.py).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import adamw as jadam
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import model_params_from_jax, model_params_to_jax
from repro_torch.launch import steps, train as train_mod
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamWConfig, init_opt_state

ARCHS = list_archs()
# the families ported last run ``check_train_forward`` and ``check_grads``
# from their own files (tests/test_torch_rglru.py, test_torch_xlstm.py,
# test_torch_encdec.py), so no one file carries the slowest cases
LATE = ("recurrentgemma-9b", "seamless-m4t-medium", "xlstm-350m")
EARLY = [a for a in ARCHS if a not in LATE]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 5e-2


def np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def close_rel(got, want, rel=1e-4):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * float(np.abs(want).max()), (err, np.abs(want).max())


def configs(arch, dtype=torch.float32, **changes):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jc = dataclasses.replace(jax_config(arch, "smoke"), dtype=jdt, **changes)
    tc = dataclasses.replace(get_config(arch, "smoke"), dtype=dtype,
                             **changes)
    return jc, tc


def masters(arch, dtype=torch.float32, **changes):
    """Both configs, the JAX params and the same weights as float32 port
    masters with gradients on."""
    jc, tc = configs(arch, dtype, **changes)
    params = jtr.init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu", dtype=torch.float32)
    return jc, tc, params, model.requires_grad_()


def make_batch(cfg, rng, b, s):
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": (rng.uniform(size=(b, s)) < 0.9).astype(np.float32)}
    if cfg.frontend == "vision":
        batch["prefix"] = rng.normal(0, 0.02, (b, cfg.n_prefix, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.n_enc_layers:
        batch["src_embeds"] = rng.normal(
            0, 0.02, (b, s // cfg.src_ratio, cfg.d_model)).astype(np.float32)
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def jax_leaves(tree):
    """{flat key: leaf} of a JAX tree (the checkpoint's keys)."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def as_jax_leaves(model, by_name):
    """Tensors named as the model's parameters (gradients, Adam moments),
    stacked into the JAX tree's layout -> {flat key: numpy array}."""
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(by_name[n])
        tree = model_params_to_jax(model)
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    return jax_leaves(tree)


# ----------------------------------------------------------------------
# train_forward
# ----------------------------------------------------------------------

def check_train_forward(arch, s):
    """Loss, nll and aux of ``arch``'s smoke config against the
    reference's at S = ``s``."""
    jc, tc, params, model = masters(arch)
    batch = make_batch(jc, np.random.default_rng(0), 1 if s > 64 else 2, s)
    jl, jm = jax.jit(lambda p, b: jtr.train_forward(p, jc, b))(
        params, jbatch(batch))
    with torch.no_grad():
        tl, tm = ttr.train_forward(model, tc, batch)
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), **F32)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), **F32)
    assert (float(tm["aux"]) > 0) == (tc.moe is not None)


@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("arch", EARLY)
def test_train_forward_matches_jax(arch, s):
    """Loss, nll and aux of the dense and MoE smoke configs: S = 64 below
    ``loss_chunk`` (512, one block) and S = 1024, two chunks."""
    check_train_forward(arch, s)


def test_loss_chunk_that_does_not_divide_is_one_block():
    """S = 600 with ``loss_chunk`` 512: the reference's single shot."""
    jc, tc, params, model = masters("internlm2-1.8b")
    batch = make_batch(jc, np.random.default_rng(1), 1, 600)
    jl, _ = jtr.train_forward(params, jc, jbatch(batch))
    with torch.no_grad():
        tl, _ = ttr.train_forward(model, tc, batch)
    np.testing.assert_allclose(float(tl), float(jl), **F32)


def check_grads(arch):
    """``torch.autograd`` through the chunked loss (``loss_chunk`` 32, S =
    96: three chunks) and ``arch``'s layers, against
    ``jax.value_and_grad``, every leaf."""
    jc, tc, params, model = masters(arch, loss_chunk=32)
    batch = make_batch(jc, np.random.default_rng(2), 2, 96)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.train_forward(p, jc, b), has_aux=True))(
        params, jbatch(batch))
    tl, _ = ttr.train_forward(model, tc, batch)
    names = [n for n, _ in model.named_parameters()]
    tg = torch.autograd.grad(tl, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    want = jax_leaves(jg)
    got = as_jax_leaves(model, dict(zip(names, tg)))
    assert sorted(got) == sorted(want)
    for key in want:
        close_rel(got[key], want[key])


@pytest.mark.parametrize("arch", EARLY)
def test_grads_match_jax(arch):
    """Gradients of the dense and MoE smoke configs (chunked attention,
    routing) against the reference's."""
    check_grads(arch)


# ----------------------------------------------------------------------
# make_train_step
# ----------------------------------------------------------------------

STEP_CFG = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)


def from_jax(tree, cfg):
    """name -> float32 tensor of a JAX tree in the port model's layout."""
    model = model_params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                  device="cpu", dtype=torch.float32)
    return dict(model.named_parameters())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b",
                                  "mixtral-8x7b", "internvl2-26b"])
def test_train_step_matches_jax(arch):
    """Three steps of ``make_train_step`` against the JAX step on the same
    batches: metrics, step, m, v and the parameters (bounds in the module
    docstring). Each step starts the port from the JAX step's state
    (masters, m, v), so a rounding-level sign that Adam turned into an
    ``lr``-sized move is compared in the step that made it and does not
    carry into the next step's gradients."""
    jc, tc, params, model = masters(arch)
    jstep = jax.jit(jsteps.make_train_step(jc, jadam.AdamWConfig(*STEP_CFG)))
    tstep = steps.make_train_step(tc, STEP_CFG)
    jos = jadam.init_opt_state(params)
    tos = init_opt_state(model)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(3)
    for _ in range(3):
        with torch.no_grad():
            for n, t in from_jax(params, tc).items():
                named[n].copy_(t)
            for which in ("m", "v"):
                for n, t in from_jax(jos[which], tc).items():
                    tos[which][n].copy_(t)
        m_before = jax_leaves(jos["m"])
        batch = make_batch(jc, rng, 2, 64)
        params, jos, jm = jstep(params, jos, jbatch(batch))
        tm = tstep(model, tos, batch)
        assert set(tm) == {"loss", "nll", "aux", "grad_norm", "lr"}
        assert all(isinstance(v, float) for v in tm.values())
        for k in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-7)
        assert tos["step"] == int(jos["step"])
        for which in ("m", "v"):
            got = as_jax_leaves(model, tos[which])
            for key, want in jax_leaves(jos[which]).items():
                close_rel(got[key], want)
        # this step's clipped gradient, from the reference's m
        m_after = jax_leaves(jos["m"])
        got = jax_leaves(model_params_to_jax(model))
        for key, want in jax_leaves(params).items():
            g = np.abs(m_after[key] - 0.9 * m_before[key]) / 0.1
            sharp = g >= 1e-2 * g.max()
            np.testing.assert_allclose(got[key][sharp], want[sharp],
                                       rtol=1e-5, atol=1e-6, err_msg=key)
            diff = float(np.abs(got[key] - want).max())
            assert diff <= 2 * tm["lr"] + 1e-6, (key, diff)


def test_train_step_needs_trainable_masters():
    cfg = get_config("internlm2-1.8b", "smoke")
    serving = ttr.init_params(0, cfg, device="cpu")
    step = steps.make_train_step(cfg, STEP_CFG)
    batch = make_batch(cfg, np.random.default_rng(4), 1, 8)
    with pytest.raises(ValueError, match="master=True"):
        step(serving, init_opt_state(serving), batch)


def test_bf16_cast_covers_norm_scales():
    """Each step casts every floating leaf, the norm scales included, to
    the compute dtype: the step's loss is ``train_forward`` on a model
    whose every leaf was rounded to bf16 (bit for bit), not on one with
    float32 norms; and the JAX step's within the bf16 bound."""
    jc, tc, params, model = masters("deepseek-moe-16b", torch.bfloat16)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.fill_(0.3)          # not a bf16 value
    params = model_params_to_jax(model)
    params = jax.tree.map(jnp.asarray, params)
    batch = make_batch(jc, np.random.default_rng(5), 2, 64)
    cast = model_params_from_jax(model_params_to_jax(model), tc,
                                 device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for p in cast.parameters():
            p.copy_(p.to(torch.bfloat16).to(torch.float32))
        want, _ = ttr.train_forward(cast, tc, batch)
        f32_norms, _ = ttr.train_forward(
            model_params_from_jax(model_params_to_jax(model), tc,
                                  device="cpu"), tc, batch)
    tm = steps.make_train_step(tc, STEP_CFG)(model, init_opt_state(model),
                                             batch)
    assert tm["loss"] == float(want)
    assert tm["loss"] != float(f32_norms)
    _, _, jm = jax.jit(jsteps.make_train_step(
        jc, jadam.AdamWConfig(*STEP_CFG)))(
        params, jadam.init_opt_state(params), jbatch(batch))
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b"])
def test_remat_changes_nothing(arch):
    """``remat`` on (each pattern group, each loss chunk and each query
    chunk under ``torch.utils.checkpoint``) against off: the loss and every
    gradient within float32 rounding (rtol 1e-6, atol 1e-7)."""
    out = []
    for remat in (False, True):
        _, tc, _, model = masters(arch, loss_chunk=32, remat=remat)
        batch = make_batch(tc, np.random.default_rng(6), 2, 96)
        loss, _ = ttr.train_forward(model, tc, batch)
        out.append((loss, torch.autograd.grad(loss, list(
            model.parameters()))))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-7)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_prefill_and_decode_steps():
    """``make_prefill_step``/``make_decode_step`` are the model's own
    entry points with the config bound."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", "smoke"),
                              dtype=torch.float32)
    model = ttr.init_params(0, cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, 512, (2, 20))
    logits, cache = steps.make_prefill_step(cfg, 32)(model,
                                                     {"tokens": toks})
    want, _ = ttr.prefill_forward(model, cfg, {"tokens": toks}, 32)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    tok = torch.argmax(logits, -1)
    got, _ = steps.make_decode_step(cfg)(model, cache, tok, 20)
    assert got.shape == (2, 512) and bool(torch.isfinite(got).all())


# ----------------------------------------------------------------------
# The trainer, its CLI and its checkpoint
# ----------------------------------------------------------------------

def test_train_loss_decreases():
    """tests/test_train.py::test_train_loss_decreases on the port."""
    _, losses = train_mod.train("internlm2-1.8b", "smoke", steps=15,
                                batch_size=4, seq_len=64, log_every=100,
                                device="cpu")
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


def test_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="cuda"):
        train_mod.train("internlm2-1.8b", "smoke", steps=1)


def test_cli(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "deepseek-moe-16b", "--variant", "smoke",
        "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
        "--checkpoint", str(tmp_path / "ck")])
    train_mod.main()
    out = capsys.readouterr().out
    assert "step    1 loss" in out and "final loss" in out
    assert (tmp_path / "ck.npz").exists() and (tmp_path / "ck.json").exists()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-26b"])
def test_checkpoint_loads_in_jax(arch, tmp_path):
    """A checkpoint the port's trainer wrote restores with
    ``repro.checkpoint.load_checkpoint`` into the JAX ``init_params``
    tree, and JAX's ``prefill_forward`` on it gives the port's prefill
    logits (float32, 1e-5)."""
    path = str(tmp_path / "ck")
    model, _ = train_mod.train(arch, "smoke", steps=2, batch_size=2,
                               seq_len=16, log_every=100,
                               checkpoint_path=path, device="cpu")
    jc, tc = configs(arch)
    like = jtr.init_params(jax.random.key(1), jc)
    restored, meta = jax_load_checkpoint(path, like)
    assert meta == {"step": 2, "arch": arch, "variant": "smoke"}
    batch = make_batch(jc, np.random.default_rng(8), 2, 24)
    del batch["targets"], batch["mask"]
    jl, _ = jtr.prefill_forward(restored, jc, jbatch(batch), capacity=64)
    with torch.no_grad():
        tl, _ = ttr.prefill_forward(model, tc, batch, capacity=64)
    np.testing.assert_allclose(np32(tl), np.asarray(jl), **F32)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """The converse: a JAX tree saved by ``repro.checkpoint`` restores
    with the port's ``load_checkpoint`` into ``model_params_to_jax``'s
    layout and, through ``model_params_from_jax``, gives JAX's logits."""
    jc, tc = configs("mixtral-8x7b")
    params = jtr.init_params(jax.random.key(2), jc)
    jax_save_checkpoint(str(tmp_path / "ck"), params, {"step": 0})
    like = model_params_to_jax(ttr.init_params(0, tc, device="cpu",
                                               master=True))
    tree, meta = load_checkpoint(str(tmp_path / "ck"), like)
    assert meta == {"step": 0}
    model = model_params_from_jax(tree, tc, device="cpu")
    batch = make_batch(jc, np.random.default_rng(9), 2, 24)
    jl, _ = jtr.prefill_forward(params, jc, {"tokens": jnp.asarray(
        batch["tokens"])}, capacity=64)
    tl, _ = ttr.prefill_forward(model, tc, {"tokens": batch["tokens"]},
                                capacity=64)
    np.testing.assert_allclose(np32(tl), np.asarray(jl), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_jax_is_the_inverse(arch, tmp_path):
    """``model_params_to_jax`` gives back the tree ``model_params_from_jax``
    took, key for key and bit for bit, and the port's ``save_checkpoint``
    writes it under the JAX package's flat keys."""
    jc, tc = configs(arch)
    params = jax.tree.map(np.asarray, jtr.init_params(jax.random.key(3), jc))
    model = model_params_from_jax(params, tc, device="cpu")
    back = jax_leaves(model_params_to_jax(model))
    want = jax_leaves(params)
    assert sorted(back) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key])
    save_checkpoint(str(tmp_path / "ck"), model_params_to_jax(model))
    restored, _ = jax_load_checkpoint(str(tmp_path / "ck"),
                                      jtr.init_params(jax.random.key(4), jc))
    for key, leaf in jax_leaves(restored).items():
        np.testing.assert_array_equal(leaf, want[key])
