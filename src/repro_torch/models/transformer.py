"""The transformer stack of the substrate: every architecture the JAX
package registers, its training loss, prefill and decode (port of
``repro/models/transformer.py``).

One config object describes every architecture: dense decoders
(llama-style GQA, layer types ``attn``, ``swa``, ``local_attn``,
``dense_attn``) with a dense or an MoE feed-forward block (``cfg.moe``;
DeepSeekMoE's ``first_k_dense`` leading layers keep a dense one of width
``first_dense_d_ff``), hybrid recurrent (RecurrentGemma: ``rglru`` +
``local_attn``), xLSTM (``mlstm``, ``slstm``), the vision-prefix decoder
and the encoder-decoder (Seamless-style: frame embeddings -> a
bidirectional ``enc_attn`` encoder; decoder layers grow cross-attention,
``xattn``). The modality frontends are stubs, as in the reference: the
caller provides ``prefix`` or ``src_embeds`` embeddings.

The model is an ``nn.Module`` (:class:`Transformer`) whose decoder layers
form one ``nn.ModuleList`` in layer order (and the encoder's another); the
JAX package's stacked ``blocks`` (a leading group axis, for its layer
scan) are unstacked by ``repro_torch.convert.model_params_from_jax``. A
serving model holds its matrices in the compute dtype (``cfg.dtype``),
cast once when it is built or loaded, which gives the values of the
reference's per-op ``.astype(x.dtype)``; norm scales and the four
recurrent leaves the reference reads in float32 (``rglru.log_lambda``,
``mlstm.b_if``, ``slstm.b``, ``slstm.r``) stay float32; nothing takes a
gradient. A training master (``init_params(..., master=True)``) holds
every leaf in float32 with gradients on;
``repro_torch.launch.steps.make_train_step`` casts every floating leaf,
the norm scales included, to ``cfg.dtype`` once a step, as the
reference's train step does.

Three entry points:
    train_forward   — full-sequence causal-LM loss (chunked over the vocab
                      head), with MoE's load-balance loss
    prefill_forward — forward + decode cache construction
    decode_step     — one token with the cache (full, windowed, or ring)

On a mesh (``DTensor`` parameters laid out by :func:`param_specs`, the
``sharding_ctx`` axes set by the launcher) the reference's layouts hold:
FSDP masters, heads and d_ff on the model axis, the training residual
stream sequence-sharded between sublayers (Megatron-SP), the vocab axis
sharded through the loss; :func:`cache_specs` lays out the decode cache.
With no mesh the sharding helpers return the plain ops' results.

``cfg.remat`` rematerialises, where gradients are on, at the reference's
points: each pattern group of layers, each encoder layer, each loss chunk
and each query chunk of attention (``torch.utils.checkpoint``,
non-reentrant); mLSTM's query chunks always are. The recomputation reads
the module's tensors again, so a caller that swaps them in
(``torch.func.functional_call``) runs the backward inside the same call.

The decode cache is one dict of preallocated buffers per layer, written in
place: an attention layer's ``k`` and ``v`` (B, C, KV, hd) in the compute
dtype at ``min(pos, C - 1)`` (``pos % C`` for a ring), with the
encoder-decoder's cross-attention memory ``xk``/``xv`` (B, S_enc, KV, hd);
a recurrent layer's state (RG-LRU ``h``, ``conv``; mLSTM ``c``, ``n``,
``m``; sLSTM ``h``, ``c``, ``n``, ``m``), overwritten by ``copy_``.
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
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import embed_init, frozen, rms_norm
from repro_torch.models.sharding_ctx import (constrain, einsum, embedding,
                                             gather_last, logsumexp,
                                             matmul)

ATTN_TYPES = ("attn", "swa", "local_attn", "dense_attn", "enc_attn", "xattn")
LAYER_TYPES = ATTN_TYPES + ("rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's model config, field for field (the configs are
    compared with it)."""

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
    xlstm: Optional[xlstm_mod.XLSTMDims] = None
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


def _decoder_ltype(cfg: ModelConfig, ltype: str) -> str:
    """Decoder layers grow cross-attention in encoder-decoder models."""
    if cfg.n_enc_layers and ltype in ("attn", "swa", "dense_attn"):
        return "xattn"
    return ltype


def decoder_types(cfg: ModelConfig) -> list[str]:
    """The decoder's layer types in layer order, cross-attention
    included."""
    return [_decoder_ltype(cfg, lt) for lt in cfg.layer_types()]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer type the JAX package rejects too
    (its ``_layer_init``, ``_decode_layer`` and ``_zero_state``)."""
    for lt in decoder_types(cfg):
        if lt not in LAYER_TYPES:
            raise ValueError(lt)


# ======================================================================
# Modules + init
# ======================================================================

class Block(nn.Module):
    """One attention layer: pre-norm self-attention, in an encoder-decoder's
    decoder then pre-norm cross-attention (``lnx``, ``xattn``), then a
    dense ``ffn`` or an MoE ``moe`` feed-forward block (the JAX package's
    keys)."""

    def __init__(self, ln1, attention: attn.Attention, ln2,
                 ffn: mlp_mod.MLP = None, moe: moe_mod.MoE = None,
                 lnx=None, xattn: attn.Attention = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block takes exactly one of ffn and moe")
        if (lnx is None) != (xattn is None):
            raise ValueError("cross-attention takes both lnx and xattn")
        self.ln1 = frozen(ln1)
        self.attn = attention
        self.lnx = None if lnx is None else frozen(lnx)
        self.xattn = xattn
        self.ln2 = frozen(ln2)
        self.ffn = ffn
        self.moe = moe


class RGLRUBlock(nn.Module):
    """A RecurrentGemma recurrent layer: ``ln1``, ``rglru``, ``ln2``,
    ``ffn``."""

    def __init__(self, ln1, rglru: rglru_mod.RGLRU, ln2, ffn: mlp_mod.MLP):
        super().__init__()
        self.ln1 = frozen(ln1)
        self.rglru = rglru
        self.ln2 = frozen(ln2)
        self.ffn = ffn


class XLSTMBlock(nn.Module):
    """An xLSTM layer: ``ln`` and one of ``mlstm`` and ``slstm``."""

    def __init__(self, ln, mlstm: xlstm_mod.MLSTM = None,
                 slstm: xlstm_mod.SLSTM = None):
        super().__init__()
        if (mlstm is None) == (slstm is None):
            raise ValueError("an xLSTM block takes exactly one of mlstm and "
                             "slstm")
        self.ln = frozen(ln)
        self.mlstm = mlstm
        self.slstm = slstm


class Encoder(nn.Module):
    """The encoder-decoder's bidirectional encoder: ``layers``
    (``enc_attn`` blocks) and ``final_norm``."""

    def __init__(self, layers: list[Block], final_norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = frozen(final_norm)


class Transformer(nn.Module):
    """``embed`` (V, D), ``head`` (D, V), ``final_norm`` (D,), ``layers``
    in layer order (:func:`decoder_types`) and, for an encoder-decoder
    config, ``encoder``."""

    def __init__(self, cfg: ModelConfig, embed, head, final_norm,
                 layers: list[nn.Module], encoder: Encoder = None):
        super().__init__()
        check_supported(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, config "
                             f"says {cfg.n_layers}")
        n_enc = 0 if encoder is None else len(encoder.layers)
        if n_enc != cfg.n_enc_layers:
            raise ValueError(f"{cfg.name}: {n_enc} encoder layers, config "
                             f"says {cfg.n_enc_layers}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.head = frozen(head)
        self.final_norm = frozen(final_norm)
        self.layers = nn.ModuleList(layers)
        self.encoder = encoder

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _layer_init(gen: torch.Generator, cfg: ModelConfig, ltype: str = "attn",
                dense_ffn: bool = False, dtype=None) -> nn.Module:
    """One layer of type ``ltype``, matrices in ``dtype`` (default
    ``cfg.dtype``), norm scales float32 zeros."""
    dtype = cfg.dtype if dtype is None else dtype
    d = cfg.d_model

    def norm():
        return torch.zeros((d,), dtype=torch.float32, device=gen.device)

    if ltype in ATTN_TYPES:
        attention = attn.attn_init(gen, d, cfg.attn_dims(), dtype)
        cross = {}
        if ltype == "xattn":
            cross = dict(lnx=norm(),
                         xattn=attn.attn_init(gen, d, cfg.attn_dims(), dtype))
        if cfg.moe is not None and not dense_ffn and ltype != "enc_attn":
            return Block(norm(), attention, norm(),
                         moe=moe_mod.moe_init(gen, d, cfg.moe, dtype),
                         **cross)
        width = cfg.first_dense_d_ff if dense_ffn and cfg.first_dense_d_ff \
            else cfg.d_ff
        ffn = mlp_mod.mlp_init(gen, d, width, cfg.gated_mlp, dtype)
        return Block(norm(), attention, norm(), ffn=ffn, **cross)
    if ltype == "rglru":
        cell = rglru_mod.rglru_init(gen, d, rglru_mod.RGLRUDims(cfg.d_rnn),
                                    dtype)
        return RGLRUBlock(norm(), cell, norm(), mlp_mod.mlp_init(
            gen, d, cfg.d_ff, cfg.gated_mlp, dtype))
    if ltype == "mlstm":
        return XLSTMBlock(norm(), mlstm=xlstm_mod.mlstm_init(
            gen, d, cfg.xlstm, dtype))
    if ltype == "slstm":
        return XLSTMBlock(norm(), slstm=xlstm_mod.slstm_init(
            gen, d, cfg.xlstm, dtype))
    raise ValueError(ltype)


class _ShapeOnly(torch.Generator):
    """A generator whose draws land on the meta device: a build through it
    has every shape and dtype and no values (the counterpart of
    ``jax.eval_shape`` of the reference's ``init_params``)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _build_device(device) -> torch.device:
    """``"meta"`` (shapes only) or what :func:`resolve_device` accepts."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_params(seed, cfg: ModelConfig, device="cuda", *,
                master: bool = False) -> Transformer:
    """A model with weights drawn in float32 from ``seed`` (an int, or a
    ``torch.Generator`` on ``device``). Norm scales start at zero (the norm
    scales by ``1 + scale``). A serving model (``master=False``) casts its
    matrices to ``cfg.dtype`` tensor by tensor (the four float32 recurrent
    leaves excepted) and takes no gradient; a training master keeps every
    leaf float32 with gradients on (the reference's ``init_params``, which
    its train step casts). ``device="meta"`` builds the shapes and dtypes
    only, allocating nothing (the dry-run's build)."""
    check_supported(cfg)
    device = _build_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    elif device.type == "meta":
        gen = _ShapeOnly()
    else:
        gen = make_generator(seed, device)
    dtype = torch.float32 if master else cfg.dtype
    d, v = cfg.d_model, cfg.vocab_size
    embed = embed_init(gen, (v, d)).to(dtype)
    head = embed_init(gen, (d, v)).to(dtype)
    layers = [_layer_init(gen, cfg, lt, dense_ffn=i < cfg.first_k_dense,
                          dtype=dtype)
              for i, lt in enumerate(decoder_types(cfg))]
    encoder = None
    if cfg.n_enc_layers:
        encoder = Encoder(
            [_layer_init(gen, cfg, "enc_attn", dtype=dtype)
             for _ in range(cfg.n_enc_layers)],
            torch.zeros((d,), dtype=torch.float32, device=device))
    model = Transformer(cfg, embed, head,
                        torch.zeros((d,), dtype=torch.float32, device=device),
                        layers, encoder)
    return model.requires_grad_(master)


def _layer_specs(cfg: ModelConfig, ltype: str, fsdp, model_axis_size: int,
                 dense_ffn: bool = False) -> dict:
    """One layer's specs as :func:`_layer_init` nests its modules."""
    p: dict = {}
    if ltype in ATTN_TYPES:
        p["ln1"] = (None,)
        p["attn"] = attn.attn_specs(fsdp)
        if ltype == "xattn":
            p["lnx"] = (None,)
            p["xattn"] = attn.attn_specs(fsdp)
        p["ln2"] = (None,)
        if cfg.moe is not None and not dense_ffn and ltype != "enc_attn":
            p["moe"] = moe_mod.moe_specs(cfg.moe, model_axis_size, fsdp)
        else:
            p["ffn"] = mlp_mod.mlp_specs(cfg.gated_mlp, fsdp)
    elif ltype == "rglru":
        p["ln1"] = (None,)
        p["rglru"] = rglru_mod.rglru_specs(fsdp)
        p["ln2"] = (None,)
        p["ffn"] = mlp_mod.mlp_specs(cfg.gated_mlp, fsdp)
    elif ltype == "mlstm":
        p["ln"] = (None,)
        p["mlstm"] = xlstm_mod.mlstm_specs(fsdp)
    elif ltype == "slstm":
        p["ln"] = (None,)
        p["slstm"] = xlstm_mod.slstm_specs(fsdp)
    return p


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def param_specs(cfg: ModelConfig, fsdp="data",
                model_axis_size: int = 16) -> dict:
    """The sharding spec of every parameter, keyed by its
    :meth:`Transformer.named_parameters` name. ``fsdp`` is the mesh axis
    (or tuple of axes) that also shards the d_model/d_ff dims (ZeRO-3),
    ``None`` for the serving layout; the model axis carries heads, d_ff,
    d_rnn, the vocab or the experts."""
    check_supported(cfg)
    specs = {"embed": ("model", fsdp), "head": (fsdp, "model"),
             "final_norm": (None,)}
    for i, lt in enumerate(decoder_types(cfg)):
        specs.update(_flatten(
            _layer_specs(cfg, lt, fsdp, model_axis_size,
                         dense_ffn=i < cfg.first_k_dense), f"layers.{i}."))
    if cfg.n_enc_layers:
        for i in range(cfg.n_enc_layers):
            specs.update(_flatten(
                _layer_specs(cfg, "enc_attn", fsdp, model_axis_size),
                f"encoder.layers.{i}."))
        specs["encoder.final_norm"] = (None,)
    return specs


# ======================================================================
# Layer forward (full sequence)
# ======================================================================

def _window(cfg: ModelConfig, ltype: str) -> Optional[int]:
    return cfg.window if ltype == "swa" else (
        cfg.local_window if ltype == "local_attn" else None)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _cross_attention(p: Block, cfg: ModelConfig, x, ek, ev):
    """Cross-attention of the decoder rows over the encoder memory (ek, ev)
    (B, S_enc, KV, hd): grouped queries from ``lnx``-normed ``x``, no
    RoPE, an all-zero additive mask -> (B, S, D)."""
    hx = rms_norm(x, p.lnx)
    dims = cfg.attn_dims()
    b, s = hx.shape[:2]
    q = attn._project_q_grouped(p.xattn, hx, dims)
    mask = torch.zeros((1, s, ek.shape[1]), dtype=torch.float32,
                       device=x.device)
    out = attn.gqa_scores_softmax_out(q, ek.to(hx.dtype), ev.to(hx.dtype),
                                      mask)
    out = out.reshape(b, s, dims.n_heads, dims.head_dim)
    return einsum("bshe,hed->bsd", out, p.xattn.wo.to(hx.dtype),
                  shard={"b": "batch", "h": "model"})   # row parallel


def _join(out, seq_parallel: bool = False):
    """A sublayer's output in the residual stream's layout: sequence-sharded
    on the model axis under sequence parallelism (the reference's
    reduce-scatter), else replicated over it (the reduction GSPMD places
    for a row-parallel output, which ``DTensor``'s cost model could trade
    for a reduce-scatter onto another dim). A plain tensor is returned
    as it is."""
    return constrain(out, ("batch", "model" if seq_parallel else None, None))


def _layer_forward(p: nn.Module, cfg: ModelConfig, ltype: str, x,
                   positions, enc_kv=None, seq_parallel: bool = False):
    """Full-sequence layer. Returns (x, aux, state): aux is the MoE
    load-balance loss (a float32 zero elsewhere), state the seed of the
    layer's decode cache (an attention layer's rotated (k, v) and, with
    cross-attention, the encoder memory ``enc_kv`` as ``xk``/``xv``; a
    recurrent layer's last state). Only the encoder's ``enc_attn`` is
    bidirectional.

    With ``seq_parallel`` (training), the residual stream stays
    sequence-sharded on the model axis between sublayers (the
    reference's Megatron-SP): each sublayer gathers its input once and
    its output is reduce-scattered (these act on ``DTensor``s only)."""
    def gather_in(h):
        return constrain(h, ("batch", None, None)) if seq_parallel else h

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ltype in ATTN_TYPES:
        dims = cfg.attn_dims(_window(cfg, ltype))
        out, (k, v) = attn.attention_forward(
            p.attn, gather_in(rms_norm(x, p.ln1)), positions, dims,
            causal=ltype != "enc_attn", chunk=cfg.chunk_q,
            return_kv=True, remat=_remat(cfg))
        x = x + _join(out, seq_parallel)
        state = {"k": k, "v": v}
        if ltype == "xattn":
            x = x + _join(_cross_attention(p, cfg, x, *enc_kv),
                          seq_parallel)
            state["xk"], state["xv"] = enc_kv
        h = gather_in(rms_norm(x, p.ln2))
        if p.moe is not None:
            out, aux = moe_mod.moe_forward(p.moe, h, cfg.moe, cfg.activation)
        else:
            out = mlp_mod.mlp_forward(p.ffn, h, cfg.activation)
        return x + _join(out, seq_parallel), aux, state
    if ltype == "rglru":
        out, state = rglru_mod.rglru_forward(
            p.rglru, gather_in(rms_norm(x, p.ln1)))
        x = x + _join(out, seq_parallel)
        x = x + _join(mlp_mod.mlp_forward(
            p.ffn, gather_in(rms_norm(x, p.ln2)), cfg.activation),
            seq_parallel)
        return x, aux, state
    if ltype == "mlstm":
        out, state = xlstm_mod.mlstm_forward(
            p.mlstm, gather_in(rms_norm(x, p.ln)), cfg.chunk_q)
        return x + _join(out, seq_parallel), aux, state
    if ltype == "slstm":
        out, state = xlstm_mod.slstm_forward(
            p.slstm, gather_in(rms_norm(x, p.ln)), cfg.xlstm.n_heads)
        return x + _join(out, seq_parallel), aux, state
    raise ValueError(ltype)


def _embed(params: Transformer, cfg: ModelConfig, tokens):
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = embedding(params.embed.to(cfg.dtype), tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return constrain(x, ("batch",) + (None,) * (x.ndim - 1))


def _with_prefix(params: Transformer, cfg: ModelConfig, batch: dict):
    """Token embeddings, after the vision prefix where the config has one
    -> (x, offset)."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.frontend == "vision" and cfg.n_prefix:
        prefix = torch.as_tensor(batch["prefix"], device=params.device)
        return torch.cat([prefix.to(cfg.dtype), x], dim=1), cfg.n_prefix
    return x, 0


def _encoder_layer(p: Block, cfg: ModelConfig, x, positions):
    return _layer_forward(p, cfg, "enc_attn", x, positions)[0]


def _run_encoder(params: Transformer, cfg: ModelConfig, src_embeds):
    """Bidirectional encoder over frame embeddings (B, S_src, D) -> its
    final-normed output (B, S_src, D) in ``cfg.dtype``; each layer
    rematerialised under ``cfg.remat``."""
    x = torch.as_tensor(src_embeds, device=params.device).to(cfg.dtype)
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)
    for p in params.encoder.layers:
        x = (checkpoint(_encoder_layer, p, cfg, x, positions,
                        use_reentrant=False)
             if _remat(cfg) else _encoder_layer(p, cfg, x, positions))
    return rms_norm(x, params.encoder.final_norm)


def _encode(params: Transformer, cfg: ModelConfig, batch: dict):
    """The encoder's output for ``batch["src_embeds"]``, or None for a
    decoder-only config."""
    if not cfg.n_enc_layers:
        return None
    return _run_encoder(params, cfg, batch["src_embeds"])


def _enc_kv(p: Block, enc_x):
    """One decoder layer's cross-attention K/V of the encoder output (no
    RoPE)."""
    return attn._project_kv(p.xattn, enc_x)


def _segments(params: Transformer, cfg: ModelConfig):
    """The layers as (span of (block, type) pairs, rematerialised) in the
    reference's order: each ``first_k_dense`` head layer alone, each
    pattern group (the reference's scan body, under ``jax.checkpoint``
    when ``cfg.remat``), then each tail layer alone."""
    pairs = list(zip(params.layers, decoder_types(cfg)))
    head, n = cfg.first_k_dense, len(cfg.pattern)
    segs = [([pr], False) for pr in pairs[:head]]
    for g in range(cfg.n_groups):
        segs.append((pairs[head + g * n: head + (g + 1) * n], True))
    segs += [([pr], False) for pr in pairs[head + cfg.n_groups * n:]]
    return segs


def _backbone(params: Transformer, cfg: ModelConfig, x, positions,
              enc_x=None, collect_states: bool = False,
              seq_parallel: bool = True):
    """Run all decoder layers (cross-attending to ``enc_x`` where the
    config has an encoder) and the final norm. Returns (x, the summed aux
    loss, per-layer states or None). ``seq_parallel`` as
    :func:`_layer_forward` (the reference's, off for prefill: prefill
    saves no residuals, so it would only add gathers)."""
    states = []

    def run(span, x, aux, enc_x):
        for p, lt in span:
            enc_kv = _enc_kv(p, enc_x) if lt == "xattn" else None
            x, a, st = _layer_forward(p, cfg, lt, x, positions, enc_kv,
                                      seq_parallel)
            aux = aux + a
            if collect_states:
                states.append(st)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for span, grouped in _segments(params, cfg):
        if grouped and _remat(cfg) and not collect_states:
            x, aux = checkpoint(run, span, x, aux, enc_x, use_reentrant=False)
        else:
            x, aux = run(span, x, aux, enc_x)
    x = rms_norm(x, params.final_norm)
    return x, aux, (states if collect_states else None)


def train_forward(params: Transformer, cfg: ModelConfig, batch: dict):
    """batch: ``tokens`` (B, S) [, ``prefix`` (B, P, D) | ``src_embeds``
    (B, S_src, D)], ``targets`` (B, S), ``mask`` (B, S). Returns (loss,
    {"nll", "aux"}): the masked mean NLL over the token positions (a
    vision prefix is sliced off first), plus ``0.01 * aux / n_layers`` for
    an MoE config."""
    check_supported(cfg)
    dev = params.device
    x, offset = _with_prefix(params, cfg, batch)
    enc_x = _encode(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.float32, device=dev)
    x, aux, _ = _backbone(params, cfg, x, positions, enc_x)
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
    vocab = ("batch", None, "model")
    logits = constrain(matmul(xc, head.to(cfg.dtype), n="model")
                       .to(torch.float32), vocab)
    logz = logsumexp(logits, dim=-1)
    return torch.sum((logz - gather_last(logits, tc, vocab)) * mc)


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
    return matmul(x_last, params.head.to(cfg.dtype),
                  n="model").to(torch.float32)


# ======================================================================
# Prefill + decode
# ======================================================================

def _cache_from_state(cfg: ModelConfig, st: dict, capacity: int,
                      ring: bool) -> dict:
    """A prefill layer state as a decode cache. Attention: the last
    ``capacity`` positions (rolled so absolute position p sits at
    ``p % capacity`` for a ring), or all of them followed by zeros, and
    the cross-attention memory as it is. A recurrent state: fresh
    contiguous buffers of its tensors, which decode overwrites."""
    if "k" not in st:
        return {name: t.clone(memory_format=torch.contiguous_format)
                for name, t in st.items()}
    k, v = st["k"], st["v"]
    s = k.shape[1]
    if s >= capacity:
        k, v = k[:, s - capacity:], v[:, s - capacity:]
        if ring and s % capacity:
            k = torch.roll(k, s % capacity, dims=1)
            v = torch.roll(v, s % capacity, dims=1)
        out = {"k": k.to(cfg.dtype).contiguous(),
               "v": v.to(cfg.dtype).contiguous()}
    else:
        out = {}
        for name, t in (("k", k), ("v", v)):
            buf = t.new_zeros((t.shape[0], capacity) + t.shape[2:],
                              dtype=cfg.dtype)
            buf[:, :s] = t
            out[name] = buf
    for name in ("xk", "xv"):
        if name in st:
            out[name] = st[name].to(cfg.dtype).contiguous()
    return out


def prefill_forward(params: Transformer, cfg: ModelConfig, batch: dict,
                    capacity: int, ring: bool = False):
    """Full-sequence forward that also builds the decode cache. ``batch``
    holds ``tokens`` (B, S) and, for a vision config, ``prefix`` (B, P,
    D), for an encoder-decoder one ``src_embeds`` (B, S_src, D).

    Returns (last-position logits (B, V) float32, cache): the cache is one
    dict a layer (see the module docstring); attention buffers are (B,
    capacity, KV, hd) (capacity >= S for full attention; == window for
    ring buffers)."""
    check_supported(cfg)
    x, offset = _with_prefix(params, cfg, batch)
    enc_x = _encode(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)
    x, _, states = _backbone(params, cfg, x, positions, enc_x,
                             collect_states=True, seq_parallel=False)
    cache = [_cache_from_state(cfg, st, capacity, ring) for st in states]
    return _logits(params, cfg, x[:, -1]), cache


def decode_step(params: Transformer, cfg: ModelConfig, cache: list,
                token, pos: int, *, ring: bool = False):
    """One-token decode. token (B,) integer; pos the absolute position (an
    int). ``ring=True`` treats the attention caches as ring buffers. The
    cache is updated in place. Returns (logits (B, V) float32, cache)."""
    check_supported(cfg)
    token = torch.as_tensor(token, device=params.device)
    x = _embed(params, cfg, token[:, None])
    for p, lt, st in zip(params.layers, decoder_types(cfg), cache):
        x = _decode_layer(p, cfg, lt, st, x, pos, ring)
    x = rms_norm(x, params.final_norm)
    return constrain(_logits(params, cfg, x[:, 0]), ("batch", "model")), cache


def _overwrite(st: dict, new: dict) -> None:
    """Write a recurrent layer's new state into its cache buffers."""
    for name, t in new.items():
        st[name].copy_(t)


def _decode_layer(p: nn.Module, cfg: ModelConfig, lt: str, st: dict, x,
                  pos, ring: bool):
    """One layer of decode; writes the layer's cache in place. An MoE
    block routes the B new tokens as one group (capacity couples them)."""
    if lt in ATTN_TYPES and lt != "enc_attn":
        window = _window(cfg, lt)
        out, _, _ = attn.attention_decode(p.attn, rms_norm(x, p.ln1), pos,
                                          st["k"], st["v"],
                                          cfg.attn_dims(window), ring=ring,
                                          window=window)
        x = x + _join(out)
        if lt == "xattn":
            x = x + _join(_cross_attention(p, cfg, x, st["xk"], st["xv"]))
        h = rms_norm(x, p.ln2)
        if p.moe is not None:
            return x + _join(moe_mod.moe_forward(p.moe, h, cfg.moe,
                                                 cfg.activation)[0])
        return x + _join(mlp_mod.mlp_forward(p.ffn, h, cfg.activation))
    if lt == "rglru":
        out, h, tail = rglru_mod.rglru_decode(p.rglru, rms_norm(x, p.ln1),
                                              st["h"], st["conv"])
        _overwrite(st, {"h": h, "conv": tail})
        x = x + _join(out)
        return x + _join(mlp_mod.mlp_forward(p.ffn, rms_norm(x, p.ln2),
                                             cfg.activation))
    if lt == "mlstm":
        out, new = xlstm_mod.mlstm_decode(p.mlstm, rms_norm(x, p.ln), st)
        _overwrite(st, new)
        return x + _join(out)
    if lt == "slstm":
        out, new = xlstm_mod.slstm_decode(p.slstm, rms_norm(x, p.ln), st,
                                          cfg.xlstm.n_heads)
        _overwrite(st, new)
        return x + _join(out)
    raise ValueError(lt)


def _zero_state(cfg: ModelConfig, ltype: str, b: int, capacity: int,
                enc_len: int, device) -> dict:
    """One layer's zero decode cache, the reference's ``_zero_state``
    (recurrent stabilisers start at -30), each tensor its own buffer."""
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    kvh, hd = cfg.n_kv_heads, cfg.hd
    if ltype in ATTN_TYPES and ltype != "enc_attn":
        st = {"k": zeros((b, capacity, kvh, hd), cfg.dtype),
              "v": zeros((b, capacity, kvh, hd), cfg.dtype)}
        if ltype == "xattn":
            st["xk"] = zeros((b, enc_len, kvh, hd), cfg.dtype)
            st["xv"] = zeros((b, enc_len, kvh, hd), cfg.dtype)
        return st
    if ltype == "rglru":
        return {"h": zeros((b, cfg.d_rnn)),
                "conv": zeros((b, rglru_mod.CONV_W - 1, cfg.d_rnn),
                              cfg.dtype)}
    if ltype == "mlstm":
        xh, xd = cfg.xlstm.n_heads, cfg.xlstm.head_dim
        return {"c": zeros((b, xh, xd, xd)), "n": zeros((b, xh, xd)),
                "m": full((b, xh), -30.0)}
    if ltype == "slstm":
        d = cfg.d_model
        return {"h": zeros((b, d)), "c": zeros((b, d)), "n": zeros((b, d)),
                "m": full((b, d), -30.0)}
    raise ValueError(ltype)


def init_cache(cfg: ModelConfig, b: int, capacity: int, device="cuda",
               enc_len: int = 0) -> list:
    """A zero decode cache, one dict of buffers a layer: attention ``k``
    and ``v`` (B, capacity, KV, hd) in ``cfg.dtype`` (and ``xk``/``xv``
    (B, enc_len, KV, hd) with cross-attention), recurrent states as the
    reference's ``_zero_state``. ``device="meta"`` builds shapes only."""
    check_supported(cfg)
    device = _build_device(device)
    return [_zero_state(cfg, lt, b, capacity, enc_len, device)
            for lt in decoder_types(cfg)]


def _state_specs(cfg: ModelConfig, ltype: str, batch_axis, seq_axis,
                 cache_mode: str = "hd") -> dict:
    """Specs matching :func:`_zero_state`. ``batch_axis`` shards B (or None
    when B is too small); ``seq_axis`` optionally shards the cache length
    (long-context B=1 decode). ``cache_mode``: ``"hd"``, head_dim on the
    model axis; ``"seq"``, the cache length on the model axis
    (flash-decoding style; on the data axis too when the batch does not
    shard)."""
    if ltype in ATTN_TYPES and ltype != "enc_attn":
        if cache_mode == "seq":
            seq_entry = "model" if batch_axis else ("data", "model")
            s = (batch_axis, seq_entry, None, None)
        else:
            s = (batch_axis, seq_axis, None, "model")
        st = {"k": s, "v": s}
        if ltype == "xattn":
            st["xk"] = (batch_axis, None, None, "model")
            st["xv"] = (batch_axis, None, None, "model")
        return st
    if ltype == "rglru":
        return {"h": (batch_axis, "model"),
                "conv": (batch_axis, None, "model")}
    if ltype == "mlstm":
        return {"c": (batch_axis, None, "model", None),
                "n": (batch_axis, None, "model"),
                "m": (batch_axis, None)}
    if ltype == "slstm":
        s = (batch_axis, "model")
        return {"h": s, "c": s, "n": s, "m": s}
    raise ValueError(ltype)


def cache_specs(cfg: ModelConfig, batch_axis, seq_axis=None,
                cache_mode: str = "hd") -> list:
    """The specs of :func:`init_cache`'s list, one dict a layer."""
    check_supported(cfg)
    return [_state_specs(cfg, lt, batch_axis, seq_axis, cache_mode)
            for lt in decoder_types(cfg)]
