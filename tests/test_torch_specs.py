"""The port's sharding specs against the JAX package's, for all ten
registered architectures at full size (``repro_torch.models.transformer``'s
``param_specs``/``cache_specs``, ``optim.adamw.opt_state_specs``,
``launch.steps.batch_specs``, ``configs.base``'s ``input_specs``,
``decode_capacity`` and ``uses_ring``, ``launch.mesh``'s axes).

A port spec is a tuple of mesh-axis entries; the reference's
``PartitionSpec`` is compared as the tuple of its entries. The port's
parameter specs are keyed by ``named_parameters()`` names and its cache is
a list of per-layer dicts: both are mapped into the reference's tree
(``convert.specs_to_jax``, the mapping of ``model_params_to_jax``, which
adds the stacked leading ``None``). Every port build here is on the meta
device: nothing is allocated. Like ``tests/test_specs.py``, every sharded
dim must divide its tensor dim (a 16-way model axis, fsdp up to 32-way).
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.configs import base as jax_base
from repro.launch import mesh as jax_mesh
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.optim import adamw as jax_adamw
from repro_torch import convert
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs import base
from repro_torch.launch import mesh, steps
from repro_torch.models.transformer import (cache_specs, init_cache,
                                            init_params, param_specs)
from repro_torch.optim.adamw import opt_state_specs

ARCHS = list_archs()
SHAPES = list(INPUT_SHAPES)
AXIS = {"model": 16, "data": 16, "pod": 2}
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


def _tuples(tree):
    """A reference spec tree with each ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _divides(shape, spec, what):
    assert len(spec) <= len(shape), (what, shape, spec)
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        size = 1
        for a in entry if isinstance(entry, tuple) else (entry,):
            size *= AXIS[a]
        assert dim % size == 0, (what, shape, spec)


def _cache_to_jax(cfg, per_layer: list, stack) -> dict:
    """The port's per-layer cache list in the reference's head / stacked
    blocks / tail layout."""
    head, n = cfg.first_k_dense, len(cfg.pattern)
    body = per_layer[head:head + cfg.n_groups * n]
    blocks = [{k: stack(body[i][k], cfg.n_groups) for k in body[i]}
              for i in range(n)] if cfg.n_groups else []
    return {"head": per_layer[:head], "blocks": blocks,
            "tail": per_layer[head + cfg.n_groups * n:]}


@pytest.mark.parametrize("fsdp", ["data", ("pod", "data"), None])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, fsdp):
    cfg = get_config(arch)
    model = init_params(0, cfg, "meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    specs = param_specs(cfg, fsdp=fsdp, model_axis_size=16)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        _divides(p.shape, specs[name], (arch, name))
    got = convert.specs_to_jax(model, specs)
    want = _tuples(jax_tf.param_specs(jax_config(arch), fsdp=fsdp,
                                      model_axis_size=16))
    assert got == want


@pytest.mark.parametrize("mode", ["hd", "seq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, mode):
    cfg = get_config(arch)
    enc_len = 8192 if cfg.n_enc_layers else 0
    cache = init_cache(cfg, 128, 32768, device="meta", enc_len=enc_len)
    specs = cache_specs(cfg, "data", None, cache_mode=mode)
    assert [set(c) for c in cache] == [set(s) for s in specs]
    for layer, (c, s) in enumerate(zip(cache, specs)):
        for k, t in c.items():
            assert t.device.type == "meta"
            _divides(t.shape, s[k], (arch, layer, k))
    got = _cache_to_jax(cfg, specs, lambda s, g: (None,) + s)
    assert got == _tuples(jax_tf.cache_specs(jax_config(arch), "data", None,
                                             cache_mode=mode))
    # a batch too small to shard: the cache length on the data axis
    got = _cache_to_jax(cfg, cache_specs(cfg, None, "data", mode),
                        lambda s, g: (None,) + s)
    assert got == _tuples(jax_tf.cache_specs(jax_config(arch), None, "data",
                                             cache_mode=mode))


def _shape_dtype(t):
    if isinstance(t, torch.Tensor):
        assert t.device.type == "meta"
        return tuple(t.shape), t.dtype
    return tuple(t.shape), DTYPES[jnp.dtype(t.dtype)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_and_batch_specs_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    got, want = base.input_specs(cfg, shape), jax_base.input_specs(jcfg,
                                                                  shape)
    assert set(got) == set(want)
    if "cache" in got:
        got = dict(got, cache=_cache_to_jax(
            cfg, got["cache"],
            lambda t, g: torch.empty((g,) + tuple(t.shape), dtype=t.dtype,
                                     device="meta")))
    assert jax.tree.map(_shape_dtype, got) == jax.tree.map(_shape_dtype,
                                                           want)
    assert base.decode_capacity(cfg, shape) == \
        jax_base.decode_capacity(jcfg, shape)
    assert base.uses_ring(shape) == jax_base.uses_ring(shape)
    kind = INPUT_SHAPES[shape]["kind"]
    for multi_pod in (False, True):
        assert steps.batch_specs(cfg, shape, multi_pod, kind) == _tuples(
            jax_steps.batch_specs(jcfg, shape, multi_pod, kind))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "xlstm-350m"])
def test_opt_state_specs_equal_reference(arch):
    cfg = get_config(arch)
    p_specs = param_specs(cfg, fsdp=("pod", "data"))
    o_specs = opt_state_specs(p_specs)
    assert o_specs["m"] is p_specs and o_specs["v"] is p_specs
    model = init_params(0, cfg, "meta", master=True)
    got = {"m": convert.specs_to_jax(model, o_specs["m"]),
           "v": convert.specs_to_jax(model, o_specs["v"]),
           "step": o_specs["step"]}
    want = _tuples(jax_adamw.opt_state_specs(
        jax_tf.param_specs(jax_config(arch), fsdp=("pod", "data"))))
    assert got == want


def test_mesh_axes_equal_reference():
    for multi_pod in (False, True):
        assert mesh.fsdp_axes(multi_pod) == jax_mesh.fsdp_axes(multi_pod)
        for b in (1, 8, 16, 32, 48, 128, 256, 512):
            assert mesh.batch_axes(multi_pod, b) == \
                jax_mesh.batch_axes(multi_pod, b)
