"""The port's architecture registry (``repro_torch.configs``) and its copy of
``repro/data/tokens.py`` against the JAX package's: all ten configs field
for field, parameter counts, and the token streams array for array."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import get_citation as jax_citation
from repro.configs import get_config as jax_config
from repro.data import tokens as jax_tokens
from repro.models import count_params as jax_count_params
from repro.models import init_params as jax_init_params
from repro_torch.configs import (INPUT_SHAPES, get_citation, get_config,
                                 list_archs)
from repro_torch.data import tokens
from repro_torch.models import count_params, init_params, transformer

PORTED = ["deepseek-67b", "deepseek-moe-16b", "gemma-7b", "internlm2-1.8b",
          "internvl2-26b", "mixtral-8x7b", "recurrentgemma-9b",
          "seamless-m4t-medium", "xlstm-350m", "yi-6b"]
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def test_list_archs_is_the_ten():
    """Every architecture the JAX package registers: five dense-attention
    decoders, two MoE ones, RG-LRU, xLSTM and the encoder-decoder."""
    assert list_archs() == PORTED


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_jax_field_for_field(arch, variant):
    jc, tc = jax_config(arch, variant), get_config(arch, variant)
    jf = [f.name for f in dataclasses.fields(jc)]
    assert [f.name for f in dataclasses.fields(tc)] == jf
    for name in jf:
        if name == "dtype":
            assert DTYPES[getattr(jc, name)] == tc.dtype
        elif name == "xlstm" and jc.xlstm is not None:
            assert tuple(tc.xlstm) == tuple(jc.xlstm)
            assert type(tc.xlstm).__name__ == "XLSTMDims"
        else:
            assert getattr(tc, name) == getattr(jc, name), name
    assert tc.layer_types() == jc.layer_types()
    assert (tc.hd, tc.n_groups, tc.n_tail) == (jc.hd, jc.n_groups, jc.n_tail)
    assert get_citation(arch) == jax_citation(arch)


def test_input_shapes():
    assert INPUT_SHAPES == JAX_INPUT_SHAPES


@pytest.mark.parametrize("arch", PORTED)
def test_count_params_smoke(arch):
    cfg = get_config(arch, "smoke")
    want = jax_count_params(jax_init_params(jax.random.key(0),
                                            jax_config(arch, "smoke")))
    assert count_params(init_params(0, cfg, device="cpu")) == want


def test_count_params_internlm2_full():
    """1,889,110,016 parameters at full width: the reference's count from
    ``jax.eval_shape``, the port's from one full-width layer drawn on the
    CPU times the depth, plus the embedding, head and final norm."""
    jc = jax_config("internlm2-1.8b", "full")
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.key(0), jc))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert want == 1_889_110_016
    cfg = get_config("internlm2-1.8b", "full")
    layer = transformer._layer_init(torch.Generator(), cfg)
    total = count_params(layer) * cfg.n_layers \
        + 2 * cfg.vocab_size * cfg.d_model + cfg.d_model
    assert total == want


@pytest.mark.parametrize("seed,vocab,length", [(0, 512, 4096),
                                               (3, 92544, 10000)])
def test_synthetic_stream(seed, vocab, length):
    np.testing.assert_array_equal(
        tokens.synthetic_stream(seed, vocab, length),
        jax_tokens.synthetic_stream(seed, vocab, length))


def test_batches():
    got = list(tokens.batches(1, 512, 4, 16, 3))
    want = list(jax_tokens.batches(1, 512, 4, 16, 3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def full_counts(arch, monkeypatch):
    """(the reference's full count from ``jax.eval_shape``, the port's from
    ``init_params`` with every dense draw made on the meta device: shapes
    only, nothing allocated)."""
    jc = jax_config(arch, "full")
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.key(0), jc))

    def meta(gen, shape, *_):
        return torch.empty(shape, device="meta")

    from repro_torch.models import attention, mlp, moe, rglru, xlstm
    for mod in (attention, mlp, moe, rglru, xlstm):
        monkeypatch.setattr(mod, "dense_init", meta)
    monkeypatch.setattr(transformer, "embed_init", meta)
    return (sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)),
            count_params(init_params(0, get_config(arch, "full"),
                                     device="cpu")))


@pytest.mark.parametrize("arch,want", [("deepseek-moe-16b", 16_375_728_128),
                                       ("mixtral-8x7b", 46_702_792_704)])
def test_count_params_moe_full(arch, want, monkeypatch):
    """The MoE configs' full counts, without allocating."""
    assert full_counts(arch, monkeypatch) == (want, want)


@pytest.mark.parametrize("arch,want", [
    ("recurrentgemma-9b", 11_712_739_328), ("xlstm-350m", 449_324_128),
    ("seamless-m4t-medium", 977_860_608)])
def test_count_params_full(arch, want, monkeypatch):
    """The RG-LRU, xLSTM and encoder-decoder configs' full counts, without
    allocating: recurrentgemma-9b is 21.8 GiB in bf16 (dense d_rnn x d_rnn
    gates, untied embedding and head)."""
    assert full_counts(arch, monkeypatch) == (want, want)
