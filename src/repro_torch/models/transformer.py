"""The transformer stack of the substrate: dense-attention and MoE decoders,
their training loss, prefill and decode (port of
``repro/models/transformer.py``).

One config object describes every architecture the JAX package registers.
This port runs the attention layer types (``attn``, ``swa``,
``local_attn``, ``dense_attn``) with a dense or an MoE feed-forward block
(``cfg.moe``; DeepSeekMoE's ``first_k_dense`` leading layers keep a dense
one of width ``first_dense_d_ff``) and the vision-prefix frontend: the
decoders of internlm2, yi, gemma, deepseek-67b, internvl2, mixtral and
deepseek-moe. The RG-LRU (``rglru``), xLSTM (``mlstm``, ``slstm``) and
encoder-decoder (``xattn``, ``n_enc_layers``) families and the audio
frontend raise ``NotImplementedError``: they are ROADMAP Queue A's later
items.

The model is an ``nn.Module`` (:class:`Transformer`) whose layers form one
``nn.ModuleList`` in layer order; the JAX package's stacked ``blocks``
(a leading group axis, for its layer scan) are unstacked by
``repro_torch.convert.model_params_from_jax``. A serving model holds its
matrices in the compute dtype (``cfg.dtype``), cast once when it is built
or loaded, which gives the values of the reference's per-op
``.astype(x.dtype)``; norm scales stay float32; nothing takes a gradient.
A training master (``init_params(..., master=True)``) holds every leaf in
float32 with gradients on; ``repro_torch.launch.steps.make_train_step``
casts every floating leaf, the norm scales included, to ``cfg.dtype`` once
a step, as the reference's train step does.

Three entry points:
    train_forward   — full-sequence causal-LM loss (chunked over the vocab
                      head), with MoE's load-balance loss
    prefill_forward — forward + KV cache construction
    decode_step     — one token with the cache (full, windowed, or ring)

``cfg.remat`` rematerialises, where gradients are on, at the reference's
three points: each pattern group of layers, each loss chunk and each query
chunk of attention (``torch.utils.checkpoint``, non-reentrant). The
recomputation reads the module's tensors again, so a caller that swaps
them in (``torch.func.functional_call``) runs the backward inside the
same call.

The decode cache is one preallocated buffer per layer, ``k`` and ``v``
each (B, C, KV, hd) in the compute dtype, written in place at
``min(pos, C - 1)`` (``pos % C`` for a ring).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import make_generator, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import embed_init, frozen, rms_norm

ATTN_TYPES = ("attn", "swa", "local_attn", "dense_attn")
LATER = "ROADMAP Queue A"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's model config, field for field (the configs are
    compared with it). Carried over and not yet read by the port:
    ``d_rnn``, ``xlstm`` and ``src_ratio`` (their families wait for
    ROADMAP Queue A) and ``long_window`` (the dry-run's long-context
    cell)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    activation: str = "silu"
    gated_mlp: bool = True
    pattern: tuple = ("attn",)
    window: Optional[int] = None        # SWA window for "swa" layers
    local_window: int = 2048            # window for "local_attn" layers
    rope_theta: float = 10000.0
    embed_scale: bool = False           # gemma-style sqrt(d) embed scaling
    # moe
    moe: Optional[moe_mod.MoEDims] = None
    first_k_dense: int = 0
    first_dense_d_ff: int = 0
    # rglru
    d_rnn: int = 0
    # xlstm
    xlstm: Optional[Any] = None
    # encoder-decoder
    n_enc_layers: int = 0
    src_ratio: int = 4                  # encoder frames = seq_len // ratio
    # modality frontends (STUB: the caller provides the embeddings)
    frontend: Optional[str] = None      # "vision" | "audio" | None
    n_prefix: int = 0                   # vision prefix tokens
    # numerics / scheduling
    dtype: Any = torch.bfloat16
    chunk_q: int = 256
    loss_chunk: int = 512               # seq-chunked loss (0 = single shot)
    long_window: int = 4096             # ring-buffer window for long_500k
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_dims(self, window=None) -> attn.AttnDims:
        return attn.AttnDims(self.n_heads, self.n_kv_heads, self.hd,
                             self.rope_theta, window)

    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.pattern)

    @property
    def n_tail(self) -> int:
        return (self.n_layers - self.first_k_dense) % len(self.pattern)

    def layer_types(self) -> list[str]:
        body = list(self.pattern) * self.n_groups + \
            list(self.pattern)[: self.n_tail]
        return ["dense_attn"] * self.first_k_dense + body


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run
    yet: RG-LRU, xLSTM, encoder-decoder and the audio frontend."""
    if cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder (xattn) layers are not ported yet "
            f"({LATER})")
    if cfg.frontend not in (None, "vision"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported yet "
            f"({LATER})")
    for lt in cfg.layer_types():
        if lt not in ATTN_TYPES:
            raise NotImplementedError(
                f"{cfg.name}: layer type {lt!r} is not ported yet ({LATER})")


# ======================================================================
# Modules + init
# ======================================================================

class Block(nn.Module):
    """One decoder layer: pre-norm attention, then a dense ``ffn`` or an
    MoE ``moe`` feed-forward block (the JAX package's keys)."""

    def __init__(self, ln1, attention: attn.Attention, ln2,
                 ffn: mlp_mod.MLP = None, moe: moe_mod.MoE = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block takes exactly one of ffn and moe")
        self.ln1 = frozen(ln1)
        self.attn = attention
        self.ln2 = frozen(ln2)
        self.ffn = ffn
        self.moe = moe


class Transformer(nn.Module):
    """``embed`` (V, D), ``head`` (D, V), ``final_norm`` (D,) and
    ``layers`` in layer order (``cfg.layer_types()``)."""

    def __init__(self, cfg: ModelConfig, embed, head, final_norm,
                 layers: list[Block]):
        super().__init__()
        check_supported(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, config "
                             f"says {cfg.n_layers}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.head = frozen(head)
        self.final_norm = frozen(final_norm)
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _layer_init(gen: torch.Generator, cfg: ModelConfig,
                dense_ffn: bool = False, dtype=None) -> Block:
    """One layer, matrices in ``dtype`` (default ``cfg.dtype``), norm
    scales float32 zeros."""
    dtype = cfg.dtype if dtype is None else dtype
    d = cfg.d_model
    zeros = torch.zeros((d,), dtype=torch.float32, device=gen.device)
    attention = attn.attn_init(gen, d, cfg.attn_dims(), dtype)
    if cfg.moe is not None and not dense_ffn:
        return Block(zeros, attention, zeros.clone(),
                     moe=moe_mod.moe_init(gen, d, cfg.moe, dtype))
    width = cfg.first_dense_d_ff if dense_ffn and cfg.first_dense_d_ff \
        else cfg.d_ff
    ffn = mlp_mod.mlp_init(gen, d, width, cfg.gated_mlp, dtype)
    return Block(zeros, attention, zeros.clone(), ffn=ffn)


def init_params(seed, cfg: ModelConfig, device="cuda", *,
                master: bool = False) -> Transformer:
    """A model with weights drawn in float32 from ``seed`` (an int, or a
    ``torch.Generator`` on ``device``). Norm scales start at zero (the norm
    scales by ``1 + scale``). A serving model (``master=False``) casts its
    matrices to ``cfg.dtype`` tensor by tensor and takes no gradient; a
    training master keeps every leaf float32 with gradients on (the
    reference's ``init_params``, which its train step casts)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        make_generator(seed, device)
    dtype = torch.float32 if master else cfg.dtype
    d, v = cfg.d_model, cfg.vocab_size
    embed = embed_init(gen, (v, d)).to(dtype)
    head = embed_init(gen, (d, v)).to(dtype)
    layers = [_layer_init(gen, cfg, dense_ffn=i < cfg.first_k_dense,
                          dtype=dtype)
              for i in range(cfg.n_layers)]
    model = Transformer(cfg, embed, head,
                        torch.zeros((d,), dtype=torch.float32, device=device),
                        layers)
    return model.requires_grad_(master)


# ======================================================================
# Layer forward (full sequence)
# ======================================================================

def _window(cfg: ModelConfig, ltype: str) -> Optional[int]:
    return cfg.window if ltype == "swa" else (
        cfg.local_window if ltype == "local_attn" else None)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _layer_forward(p: Block, cfg: ModelConfig, ltype: str, x, positions,
                   causal: bool = True):
    """Full-sequence layer. Returns (x, aux, state): aux is the MoE
    load-balance loss (a float32 zero for a dense layer), state the
    layer's rotated (k, v), the seed of its decode cache."""
    if ltype not in ATTN_TYPES:
        raise NotImplementedError(
            f"layer type {ltype!r} is not ported yet ({LATER})")
    dims = cfg.attn_dims(_window(cfg, ltype))
    out, (k, v) = attn.attention_forward(
        p.attn, rms_norm(x, p.ln1), positions, dims, causal=causal,
        chunk=cfg.chunk_q, return_kv=True, remat=_remat(cfg))
    x = x + out
    h = rms_norm(x, p.ln2)
    if p.moe is not None:
        out, aux = moe_mod.moe_forward(p.moe, h, cfg.moe, cfg.activation)
    else:
        out = mlp_mod.mlp_forward(p.ffn, h, cfg.activation)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux, {"k": k, "v": v}


def _embed(params: Transformer, cfg: ModelConfig, tokens):
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = params.embed.to(cfg.dtype)[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return x


def _with_prefix(params: Transformer, cfg: ModelConfig, batch: dict):
    """Token embeddings, after the vision prefix where the config has one
    -> (x, offset)."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.frontend == "vision" and cfg.n_prefix:
        prefix = torch.as_tensor(batch["prefix"], device=params.device)
        return torch.cat([prefix.to(cfg.dtype), x], dim=1), cfg.n_prefix
    return x, 0


def _segments(params: Transformer, cfg: ModelConfig):
    """The layers as (span of (block, type) pairs, rematerialised) in the
    reference's order: each ``first_k_dense`` head layer alone, each
    pattern group (the reference's scan body, under ``jax.checkpoint``
    when ``cfg.remat``), then each tail layer alone."""
    pairs = list(zip(params.layers, cfg.layer_types()))
    head, n = cfg.first_k_dense, len(cfg.pattern)
    segs = [([pr], False) for pr in pairs[:head]]
    for g in range(cfg.n_groups):
        segs.append((pairs[head + g * n: head + (g + 1) * n], True))
    segs += [([pr], False) for pr in pairs[head + cfg.n_groups * n:]]
    return segs


def _backbone(params: Transformer, cfg: ModelConfig, x, positions,
              collect_states: bool = False):
    """Run all decoder layers and the final norm. Returns (x, the summed
    aux loss, per-layer states or None)."""
    states = []

    def run(span, x, aux):
        for p, lt in span:
            x, a, st = _layer_forward(p, cfg, lt, x, positions)
            aux = aux + a
            if collect_states:
                states.append(st)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for span, grouped in _segments(params, cfg):
        if grouped and _remat(cfg) and not collect_states:
            x, aux = checkpoint(run, span, x, aux, use_reentrant=False)
        else:
            x, aux = run(span, x, aux)
    x = rms_norm(x, params.final_norm)
    return x, aux, (states if collect_states else None)


def train_forward(params: Transformer, cfg: ModelConfig, batch: dict):
    """batch: ``tokens`` (B, S) [, ``prefix`` (B, P, D)], ``targets`` (B,
    S), ``mask`` (B, S). Returns (loss, {"nll", "aux"}): the masked mean
    NLL over the token positions (a vision prefix is sliced off first),
    plus ``0.01 * aux / n_layers`` for an MoE config."""
    check_supported(cfg)
    dev = params.device
    x, offset = _with_prefix(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.float32, device=dev)
    x, aux, _ = _backbone(params, cfg, x, positions)
    x = x[:, offset:]
    targets = torch.as_tensor(batch["targets"], device=dev).long()
    mask = torch.as_tensor(batch["mask"], device=dev).to(torch.float32)
    nll_sum = _chunked_nll(params, cfg, x, targets, mask)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = nll_sum / denom
    if cfg.moe is not None:
        loss = loss + 0.01 * aux / max(cfg.n_layers, 1)
    return loss, {"nll": nll_sum / denom, "aux": aux}


def _nll_block(head, cfg: ModelConfig, xc, tc, mc):
    """Summed NLL of one sequence block. xc (B, cs, D), tc/mc (B, cs);
    ``head`` the (D, V) vocab head."""
    logits = (xc @ head.to(cfg.dtype)).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None])[..., 0]
    return torch.sum((logz - gold) * mc)


def _chunked_nll(params: Transformer, cfg: ModelConfig, x, targets, mask):
    """Total NLL over sequence chunks of ``cfg.loss_chunk``, each
    rematerialised under ``cfg.remat`` so that one (B, chunk, V) logits
    block is live in forward and backward; one block when ``s <= chunk``
    or the chunk does not divide ``s``, as in the reference."""
    s = x.shape[1]
    cs = cfg.loss_chunk
    if not cs or s <= cs or s % cs:
        return _nll_block(params.head, cfg, x, targets, mask)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, cs):
        args = (params.head, cfg, x[:, start:start + cs],
                targets[:, start:start + cs], mask[:, start:start + cs])
        total = total + (checkpoint(_nll_block, *args, use_reentrant=False)
                         if _remat(cfg) else _nll_block(*args))
    return total


def _logits(params: Transformer, cfg: ModelConfig, x_last):
    return (x_last @ params.head.to(cfg.dtype)).to(torch.float32)


# ======================================================================
# Prefill + decode
# ======================================================================

def _cache_from_state(cfg: ModelConfig, st: dict, capacity: int,
                      ring: bool) -> dict:
    """A prefill layer state as a fixed-capacity decode cache: the last
    ``capacity`` positions (rolled so absolute position p sits at
    ``p % capacity`` for a ring), or all of them followed by zeros."""
    k, v = st["k"], st["v"]
    s = k.shape[1]
    if s >= capacity:
        k, v = k[:, s - capacity:], v[:, s - capacity:]
        if ring and s % capacity:
            k = torch.roll(k, s % capacity, dims=1)
            v = torch.roll(v, s % capacity, dims=1)
        return {"k": k.to(cfg.dtype).contiguous(),
                "v": v.to(cfg.dtype).contiguous()}
    out = {}
    for name, t in (("k", k), ("v", v)):
        buf = t.new_zeros((t.shape[0], capacity) + t.shape[2:],
                          dtype=cfg.dtype)
        buf[:, :s] = t
        out[name] = buf
    return out


def prefill_forward(params: Transformer, cfg: ModelConfig, batch: dict,
                    capacity: int, ring: bool = False):
    """Full-sequence forward that also builds the decode cache. ``batch``
    holds ``tokens`` (B, S) and, for a vision config, ``prefix`` (B, P, D).

    Returns (last-position logits (B, V) float32, cache): the cache is one
    {"k", "v"} buffer pair per layer, (B, capacity, KV, hd) each
    (capacity >= S for full attention; == window for ring buffers)."""
    check_supported(cfg)
    x, offset = _with_prefix(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)
    x, _, states = _backbone(params, cfg, x, positions, collect_states=True)
    cache = [_cache_from_state(cfg, st, capacity, ring) for st in states]
    return _logits(params, cfg, x[:, -1]), cache


def decode_step(params: Transformer, cfg: ModelConfig, cache: list,
                token, pos: int, *, ring: bool = False):
    """One-token decode. token (B,) integer; pos the absolute position (an
    int). ``ring=True`` treats the caches as ring buffers. The cache is
    updated in place. Returns (logits (B, V) float32, cache)."""
    check_supported(cfg)
    token = torch.as_tensor(token, device=params.device)
    x = _embed(params, cfg, token[:, None])
    for p, lt, st in zip(params.layers, cfg.layer_types(), cache):
        x = _decode_layer(p, cfg, lt, st, x, pos, ring)
    x = rms_norm(x, params.final_norm)
    return _logits(params, cfg, x[:, 0]), cache


def _decode_layer(p: Block, cfg: ModelConfig, lt: str, st: dict, x, pos,
                  ring: bool):
    """One layer of decode; writes the layer's cache slot in place. An MoE
    block routes the B new tokens as one group (capacity couples them)."""
    if lt not in ATTN_TYPES:
        raise NotImplementedError(
            f"layer type {lt!r} is not ported yet ({LATER})")
    window = _window(cfg, lt)
    out, _, _ = attn.attention_decode(p.attn, rms_norm(x, p.ln1), pos,
                                      st["k"], st["v"],
                                      cfg.attn_dims(window), ring=ring,
                                      window=window)
    x = x + out
    h = rms_norm(x, p.ln2)
    if p.moe is not None:
        return x + moe_mod.moe_forward(p.moe, h, cfg.moe, cfg.activation)[0]
    return x + mlp_mod.mlp_forward(p.ffn, h, cfg.activation)


def init_cache(cfg: ModelConfig, b: int, capacity: int,
               device="cuda") -> list:
    """A zero decode cache: one {"k", "v"} pair of (B, capacity, KV, hd)
    buffers in ``cfg.dtype`` per layer."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (b, capacity, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]
