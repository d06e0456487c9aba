"""Logical-axis sharding constraints for model internals (port of
``repro/models/sharding_ctx.py``).

The model code names the dims of an activation with logical axes
(``"batch"``, ``"model"``, ``"expert"``); the launcher maps them to mesh
axes before it runs a step (:func:`set_axes`, as the reference's
``build_jitted`` does). Where the axes are set and the activation is a
``DTensor``, :func:`constrain` redistributes it to those placements on its
own mesh: the counterpart of ``jax.lax.with_sharding_constraint``, which
is how head_dim carries the model axis and batch the data axes inside
attention, MoE and the recurrences.

In every other case (axes not set, a plain tensor) :func:`constrain`
returns its input, the same object, so a single-card run is untouched.

The products (:func:`einsum`, :func:`matmul`) and the few functions
``DTensor`` splits badly or not at all (:func:`local`,
:func:`embedding`, :func:`gather_last`) are the plain ops on plain
tensors. With ``DTensor``s each runs on the local shards through one
wrapper, :func:`on_shards`, laid out as its call site states: a
product's site names the logical axis of each split letter, as the
reference's constraint next to it names the result's.

A spec is the port's stand-in for ``PartitionSpec``: a tuple with one
entry a tensor dim, each ``None`` (replicated), a mesh-axis name, or a
tuple of names (the dim sharded over all of them, major to minor).
:func:`placements` turns one into ``DTensor`` placements.
"""
from __future__ import annotations

import functools
import sys
from typing import Sequence, Union

import torch

Axis = Union[None, str, tuple]

_MAP: dict[str, Axis] = {"batch": None, "model": None, "expert": None}
_ENABLED = False


def is_dtensor(x) -> bool:
    """True for a ``DTensor``. ``torch.distributed.tensor`` is never
    imported here: it takes seconds to import, and a process that has not
    imported it holds no ``DTensor``, so the plain path never pays for
    it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def set_axes(batch: Axis, model: Axis = "model", expert: Axis = None):
    """Configure logical axes (call before running a step function)."""
    global _ENABLED
    _MAP["batch"] = batch
    _MAP["model"] = model
    _MAP["expert"] = expert if expert is not None else model
    _ENABLED = True


def clear_axes():
    global _ENABLED
    _ENABLED = False


def placements(mesh, spec: Sequence[Axis]) -> list:
    """The ``DTensor`` placements, one a mesh dim, of ``spec`` on
    ``mesh``. A tuple entry shards its tensor dim over each named mesh dim;
    ``DTensor`` splits such a dim over the mesh dims in mesh order, which
    is JAX's major-to-minor order when the names come in mesh order (a
    tuple out of that order raises)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def axis_size(x, dim: str) -> int:
    """The number of shards the logical ``dim`` maps to on ``x``'s mesh
    (1 for a plain tensor or with the axes not set)."""
    if not _ENABLED or not is_dtensor(x):
        return 1
    axes = _MAP.get(dim)
    axes = () if axes is None else axes if isinstance(axes, tuple) else \
        (axes,)
    mesh = x.device_mesh
    size = 1
    for a in axes:
        size *= mesh.size(mesh.mesh_dim_names.index(a))
    return size


def constrain(x, dims: Sequence[Union[str, None]]):
    """Redistribute ``x`` to the placements its logical ``dims`` name.

    Returns ``x`` itself when the axes are not set or ``x`` is not a
    ``DTensor``."""
    if not _ENABLED or not is_dtensor(x):
        return x
    # redistributed even when it is laid out so already: like the
    # reference's constraint, this pins the gradient's layout too
    return x.redistribute(x.device_mesh, _logical(x, dims))


def _logical(x, dims, mesh=None) -> list:
    """The placements on ``mesh`` (``x``'s own by default) of ``x`` laid
    out as its logical ``dims`` (the dims past them whole)."""
    spec = [_MAP.get(d) if isinstance(d, str) else d for d in dims]
    return placements(mesh or x.device_mesh,
                      spec + [None] * (x.ndim - len(spec)))


def _mesh_axes(axis: Axis) -> Axis:
    """A logical axis (``"batch"``, ``"model"``, ``"expert"``) as the mesh
    axes it maps to; a mesh-axis name or tuple of names as it is."""
    return _MAP[axis] if isinstance(axis, str) and axis in _MAP else axis


def layout(x, letters: str) -> dict:
    """The mesh axes each of ``x``'s dims, named by ``letters``, is sharded
    over: the map :func:`einsum` takes, for a product that keeps the
    layout of a tensor laid out already (a decode cache)."""
    names = x.device_mesh.mesh_dim_names
    out: dict = {}
    for i, p in enumerate(x.placements):
        if p.is_shard():
            c = letters[p.dim]
            out[c] = tuple(out.get(c, ())) + (names[i],)
    return out


def on_shards(fn, args: tuple, in_placements: list, out_placements: list,
              shape):
    """``fn`` on each rank's shards: every argument is redistributed to
    its ``in_placements`` and the local result is this rank's part, laid
    out as ``out_placements``, of a result of global ``shape``. Plain
    tensors among ``args`` count as replicated. An argument replicated
    over a mesh dim that splits the result (sharded or a partial sum
    there) gets a partial sum as its gradient: every rank's share adds to
    it. This is ``local_map``'s contract with its ``in_grad_placements``
    so set, and the result's shape given: ``local_map`` takes a dim to
    split evenly, and one the mesh splits unevenly (8 experts over a model
    axis of 16) is laid out here as ``DTensor`` lays it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    local_args = []
    for a, pl in zip(args, in_placements):
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        grad = [Partial() if p.is_replicate() and not o.is_replicate()
                else p for p, o in zip(pl, out_placements)]
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        # a partial gradient flows on unreduced where no redistribution
        # stands in its way: a weight used at every timestep sums once
        local_args.append(a.to_local(grad_placements=grad))
    out = fn(*local_args)
    shape = torch.Size(shape)
    return DTensor.from_local(out, mesh, out_placements, run_check=False,
                              shape=shape, stride=_stride(out, shape))


def _stride(local: torch.Tensor, shape) -> tuple:
    """The global stride of a tensor of ``shape`` whose shards are laid out
    as ``local`` is (its dims in the same memory order), so a shard keeps
    the layout, and the bits of what reads it, that the plain op gives."""
    order = sorted(range(local.ndim), key=lambda d: (-local.stride(d), d))
    stride, step = [0] * len(shape), 1
    for d in reversed(order):
        stride[d] = step
        step *= shape[d]
    return tuple(stride)


def einsum(eq: str, *operands, shard: dict):
    """``torch.einsum(eq, *operands)``; with ``DTensor`` operands, run on
    each rank's shards laid out as the call site states in ``shard``: a
    map from the equation's letters to the logical axis (or mesh axes)
    each is split over, every other letter whole. Each operand is laid
    out so, the local einsum is this rank's part, and a contracted letter
    in ``shard`` leaves a partial sum over its mesh axes. (``DTensor``'s
    own einsum runs as matmuls over flattened dims and mislays or refuses
    a dim sharded inside a flattened group.)"""
    if not any(is_dtensor(o) for o in operands):
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import Partial
    mesh = next(o for o in operands if is_dtensor(o)).device_mesh
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    axes = {c: _mesh_axes(a) for c, a in shard.items()}
    axes = {c: a for c, a in axes.items() if a is not None}
    used = [n for a in axes.values()
            for n in (a if isinstance(a, tuple) else (a,))]
    if len(used) != len(set(used)):
        raise ValueError(f"{eq}: two letters on one mesh axis in {shard}")
    out_pl = placements(mesh, [axes.get(c) for c in out])
    for c in set(axes) - set(out):
        for a in axes[c] if isinstance(axes[c], tuple) else (axes[c],):
            out_pl[mesh.mesh_dim_names.index(a)] = Partial()
    sizes: dict = {}
    for sub, o in zip(subs, operands):
        sizes.update(zip(sub, o.shape))
    return on_shards(functools.partial(torch.einsum, eq), operands,
                     [placements(mesh, [axes.get(c) for c in sub])
                      for sub in subs], out_pl, [sizes[c] for c in out])


def _shards(x, dim: int) -> int:
    """How many ways a ``DTensor`` splits its ``dim`` over the mesh."""
    from torch.distributed.tensor import Shard
    mesh, n = x.device_mesh, 1
    for i, p in enumerate(x.placements):
        if type(p) is Shard and p.dim == dim % x.ndim:
            n *= mesh.size(i)
    return n


def logsumexp(x, dim: int):
    """``torch.logsumexp(x, dim)``. A ``DTensor`` split along ``dim``
    across ranks reduces there in two steps (the max, then the sum of
    exps, each a small all-reduce), as GSPMD partitions the reference's;
    ``DTensor``'s own strategy would gather the dim whole first (a vocab
    axis of logits, a sharded cache length)."""
    if not is_dtensor(x) or _shards(x, dim) == 1:
        return torch.logsumexp(x, dim=dim)
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    return torch.log(torch.sum(torch.exp(x - m), dim=dim)) + \
        m.squeeze(dim)


def softmax(x, dim: int):
    """``torch.softmax(x, dim)``, split along ``dim`` as
    :func:`logsumexp` is."""
    if not is_dtensor(x) or _shards(x, dim) == 1:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True).detach())
    return e / torch.sum(e, dim=dim, keepdim=True)


def matmul(x, w, *, k: Axis = None, n: Axis = None,
           batch: Axis = "batch"):
    """``x @ w`` for a 2-D ``w``; with ``DTensor``s, through :func:`einsum`
    with ``x``'s first dim on ``batch``, the contracted dim on ``k`` and
    the output dim on ``n`` (column parallel: ``n="model"``; row
    parallel: ``k="model"``, a partial sum)."""
    if not is_dtensor(x) and not is_dtensor(w):
        return x @ w
    lead = "abcdefgh"[:x.ndim - 1]
    return einsum(f"{lead}y,yz->{lead}z", x, w,
                  shard={"a": batch, "y": k, "z": n})


def local(fn, args: tuple, dims: tuple):
    """``fn(*args)`` for a function whose result has its first argument's
    shape; with ``DTensor`` arguments, run on each rank's shards
    (:func:`on_shards`), each argument laid out as its logical ``dims``
    and the result as the first's. For a function that acts along dims
    every shard holds whole and shards consistently over the rest (an
    elementwise function, a cumulative sum along the sequence, the
    RG-LRU's causal conv along it, channel by channel): ``DTensor`` lacks
    strategies for some of these ops' pieces (``log_sigmoid``'s backward,
    ``flip`` in a cumsum's backward, a padded slice) in some torch
    versions."""
    lead = args[0]
    if not is_dtensor(lead):
        return fn(*args)
    pls = [_logical(a, d, lead.device_mesh) for a, d in zip(args, dims)]
    return on_shards(fn, args, pls, pls[0], lead.shape)


def _vocab_offset(x, dim: int, pls) -> tuple:
    """(rows, first row) of this rank's shard of ``x``'s ``dim`` when laid
    out as ``pls``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    size, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, pls)
    return size[dim], offset[dim]


def embedding(table, tokens):
    """``table[tokens]``; with a ``DTensor`` table, the vocab-parallel
    lookup: the table's vocab on the model axis and its rows whole, the
    tokens' first dim on the batch axes; each rank looks its tokens up in
    its rows and writes zeros for the tokens it does not hold, leaving a
    partial sum over the model axis."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial
    mesh = table.device_mesh
    tab_pl = _logical(table, ("model", None))
    tok_pl = _logical(tokens, ("batch",), mesh)
    rows, first = _vocab_offset(table, 0, tab_pl)
    out_pl = [Partial() if t.is_shard() else p
              for t, p in zip(tab_pl, tok_pl)]

    def lookup(tab, tok):
        idx = tok - first
        held = (idx >= 0) & (idx < rows)
        return torch.where(held[..., None],
                           tab[idx.clamp(0, max(rows - 1, 0))], 0) \
            .to(tab.dtype)

    return on_shards(lookup, (table, tokens), [tab_pl, tok_pl], out_pl,
                     tuple(tokens.shape) + (table.shape[1],))


def gather_last(x, idx, dims: tuple):
    """``x[..., idx]`` element by element: ``torch.gather(x, -1,
    idx[..., None])[..., 0]``. With a ``DTensor`` ``x``, laid out as its
    logical ``dims`` (the last on the model axis: a vocab), each rank picks
    the entries its shard holds and zeros elsewhere, leaving a partial
    sum (the reference's masked sum keeps a sharded vocab axis so;
    ``DTensor`` would gather the whole axis first)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial
    x_pl = _logical(x, dims)
    idx_pl = _logical(idx, dims[:-1], x.device_mesh)
    size, first = _vocab_offset(x, x.ndim - 1, x_pl)
    out_pl = [Partial() if p.is_shard() and p.dim == x.ndim - 1 else q
              for p, q in zip(x_pl, idx_pl)]

    def pick(xl, il):
        rel = il - first
        val = torch.gather(xl, -1, rel.clamp(0, max(size - 1, 0))[
            ..., None])[..., 0]
        return torch.where((rel >= 0) & (rel < size), val,
                           torch.zeros((), dtype=xl.dtype,
                                       device=xl.device))

    return on_shards(pick, (x, idx), [x_pl, idx_pl], out_pl, idx.shape)


def write_slot(cache: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """``cache[:, slot] = value`` in place, the counterpart of the
    reference's ``dynamic_update_slice`` along a cache's length (dim 1).

    A ``DTensor`` cache writes its local shard: ``value`` is laid out as
    the cache is on its other dims, and the rank whose shard of dim 1
    holds ``slot`` writes it (a rank whose shard does not, writes
    nothing). A plain tensor is written directly."""
    if not is_dtensor(cache):
        cache[:, slot] = value
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = cache.device_mesh
    want = [Replicate() if not isinstance(p, Shard) or p.dim == 1 else
            Shard(p.dim - 1 if p.dim > 1 else 0) for p in cache.placements]
    if not is_dtensor(value):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    local_value = value.redistribute(mesh, want).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    if offset[1] <= slot < offset[1] + shape[1]:
        cache.to_local()[:, slot - offset[1]] = local_value
