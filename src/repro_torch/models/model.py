"""Every model family of the reference (dense and MoE attention stacks,
the mamba hybrid, xLSTM, whisper's encoder-decoder, internvl2's vision
prefix): parameters, caches, the train forward, prefill and decode (port
of ``repro.models.model``).

Parameters live in an ``nn.Module`` tree with one :class:`Block` per layer
(the reference stacks them ``[G, ...]`` per pattern position and scans;
here ``lax.scan`` over groups becomes a Python loop over ``model.blocks``,
layer ``l`` built from ``cfg.pattern[l % P]``). A block is a pre-norm
mixer (attention, mamba, mLSTM or sLSTM) and, unless its ``ff`` is
``"none"``, a pre-norm SwiGLU or MoE FF. Every weight keeps the
reference's ``[in, out]`` layout (``x @ w``) and its truncated-normal init;
norms start at one. With ``tie_embeddings`` there is no ``lm_head``: the
head is ``embed.T``.

An encoder-decoder config (``encoder_layers > 0``) adds ``encoder``
(``encoder_layers`` non-causal attention blocks and a norm, run by
:func:`encode` over precomputed frame embeddings) and gives every decoder
attention block a pre-norm cross-attention over the encoder's output
(``cross_kv``); a vision config adds ``vision_proj``, which projects the
patch embeddings put in front of the token stream. Sinusoidal positions
(``pos="sinusoidal"``) are added to the token embeddings, before the
prefix, as the reference adds them.

Caches are the reference's ``{"b<i>": {...}}``, one entry per pattern
position ``i``, each leaf with a leading group axis ``[G, B, ...]``: an
attention position holds ``{"k", "v"}`` (``[G, B, S, K, hd]``, in the
format ``kv_policy`` gives ``kv/b<i>``), a recurrent one its mixer's state
(``models.ssm`` / ``models.xlstm``). Layer ``l`` reads position ``l % P``,
group ``l // P``. Paged decode instead binds the pool slabs ``{"b<i>":
{"k", "v"}}`` of shape ``[G, P, T, K, W]`` at the attention positions and
a ``[B, max_pages]`` page table; every cache, state and slab write happens
in place.

Parameters are created with ``requires_grad=False``: serving runs under
``torch.inference_mode``, and training (``repro_torch.train``) turns the
gradients on.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.f2p import F2PFormat
from repro_torch.models import attention as A
from repro_torch.models import parallel as TP
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.common import (rms_norm, sinusoidal_positions,
                                      softmax_cross_entropy, swiglu,
                                      truncnorm_init)
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.moe import MoE
from repro_torch.models.sharding import constrain


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# the sinusoidal table's length at decode (whisper's decode positions)
MAX_POS = 65536


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, causal: bool = True):
        super().__init__()
        D, hd, H, K = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        dt = cfg.torch_dtype
        self.causal = causal
        self.wq = _param((D, H * hd), dt, device)
        self.wk = _param((D, K * hd), dt, device)
        self.wv = _param((D, K * hd), dt, device)
        self.wo = _param((H * hd, D), dt, device)

    def weights(self) -> dict:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}

    def init_order(self) -> list[tuple[nn.Parameter, float]]:
        return [(self.wq, 0.02), (self.wk, 0.02), (self.wv, 0.02),
                (self.wo, 0.02)]

    def init_fixed(self):
        pass

    def apply(self, x, cfg: ModelConfig, *, mode, cache=None, pos_offset=0,
              pages=None):
        return A.attention_apply(self.weights(), x, cfg, mode=mode,
                                 cache=cache, pos_offset=pos_offset,
                                 causal=self.causal, pages=pages)[0]


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, F, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        self.gate = _param((D, F), dt, device)
        self.up = _param((D, F), dt, device)
        self.down = _param((F, D), dt, device)

    def init_order(self) -> list[tuple[nn.Parameter, float]]:
        return [(self.gate, 0.02), (self.up, 0.02), (self.down, 0.02)]


_RECURRENT_MIXERS = {"mamba": SSM.Mamba, "mlstm": XL.MLSTM,
                     "slstm": XL.SLSTM}


class Block(nn.Module):
    """Pre-norm block: the ``spec.mixer`` mixer, then (``cross``, attention
    mixers only) a pre-norm cross-attention over the encoder's output, then
    a SwiGLU (``ff="dense"``) or MoE FF, or none (``ff="none"``: no
    ``norm2``). ``causal=False`` makes the attention mixer non-causal (the
    encoder's blocks)."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, device, *,
                 cross: bool = False, causal: bool = True):
        super().__init__()
        dt = cfg.torch_dtype
        self.spec = spec
        self.norm1 = _param((cfg.d_model,), dt, device)
        self.mixer = (Attention(cfg, device, causal) if spec.mixer == "attn"
                      else _RECURRENT_MIXERS[spec.mixer](cfg, device))
        self.cross = None
        if cross and spec.mixer == "attn":
            self.norm_cross = _param((cfg.d_model,), dt, device)
            self.cross = Attention(cfg, device)
        if spec.ff != "none":
            self.norm2 = _param((cfg.d_model,), dt, device)
            self.ff = (MoE(cfg, device) if spec.ff == "moe"
                       else FeedForward(cfg, device))

    def forward(self, x, cfg: ModelConfig, *, mode, cache=None, pos_offset=0,
                pages=None, cross_kv=None, seq_split: bool = False):
        """Returns (x, the MoE aux loss or None). With ``opt_seq_par`` (a
        train call over more than one position) the residual stream is
        pinned to ``seq_sp`` and the normalized mixer / FF inputs to the
        full sequence, as the reference's block. ``seq_split``: ``x`` is
        this model rank's chunk of the sequence (the sharded step under
        ``opt_seq_par``): the norms and the residual adds run on the chunk,
        each mixer / FF input is gathered whole over the model axis and
        its output chunked again."""
        sp = seq_split or (cfg.opt_seq_par and mode == "train"
                           and x.shape[1] > 1)

        def to_sp(t):
            if seq_split:
                return TP.chunk_model(t, 1, "train.tp_seq")
            return constrain(t, ("batch", "seq_sp", None)) if sp else t

        def to_full(t):
            if seq_split:
                return TP.gather_model_replicated(t, 1, "train.tp_seq")
            return constrain(t, ("batch", None, None)) if sp else t

        def norm(t, w):
            # a rank normalizes its chunk only: the weight's gradient is
            # summed over the model axis
            return rms_norm(t, TP.to_model(w, "train.tp_seq_norm")
                            if seq_split else w, cfg.norm_eps)

        if not seq_split:
            x = to_sp(x)
        h = to_full(norm(x, self.norm1))
        h = self.mixer.apply(h, cfg, mode=mode, cache=cache,
                             pos_offset=pos_offset, pages=pages)
        x = x + to_sp(h)
        if self.cross is not None and cross_kv is not None:
            h = to_full(norm(x, self.norm_cross))
            x = x + to_sp(A.attention_apply(self.cross.weights(), h, cfg,
                                            mode="train",
                                            cross_kv=cross_kv)[0])
        aux = None
        if self.spec.ff == "moe":
            h = to_full(norm(x, self.norm2))
            h, out = self.ff(h, cfg, sp=sp)
            x, aux = x + to_sp(h), out["aux_loss"]
        elif self.spec.ff == "dense":
            h = norm(x, self.norm2)
            if seq_split:
                h = to_full(h)
            h = swiglu(h, self.ff.gate, self.ff.up, self.ff.down,
                       constrain_ff=not sp,
                       split=self.ff.down.shape[0] != cfg.d_ff)
            x = x + to_sp(h)
        if not sp:
            x = constrain(x, ("batch", "seq", None))
        return x, aux


class Encoder(nn.Module):
    """Whisper's encoder: ``encoder_layers`` non-causal attention blocks
    with dense FFs, then an RMS norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        spec = BlockSpec("attn", "dense")
        self.blocks = nn.ModuleList(Block(cfg, spec, device, causal=False)
                                    for _ in range(cfg.encoder_layers))
        self.norm = _param((cfg.d_model,), cfg.torch_dtype, device)


class Model(nn.Module):
    """Parameters of a model (allocated, not initialised)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        D, V, dt = cfg.d_model, cfg.vocab_size, cfg.torch_dtype
        self.embed = _param((V, D), dt, device)
        self.final_norm = _param((D,), dt, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else _param((D, V), dt, device))
        P = len(cfg.pattern)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.pattern[i % P], device, cross=cfg.is_encdec)
            for i in range(cfg.n_layers))
        self.encoder = Encoder(cfg, device) if cfg.is_encdec else None
        self.vision_proj = (_param((D, D), dt, device)
                            if cfg.frontend == "vision" else None)
        # the sinusoidal rows of every position, cast to the model dtype (as
        # the reference casts before it adds); not a parameter nor saved
        self.register_buffer(
            "pos_table", None if cfg.pos != "sinusoidal" else
            torch.from_numpy(sinusoidal_positions(MAX_POS, D)).to(
                device=device, dtype=dt), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        """The LM head ``[D, V]``: ``embed.T`` when tied."""
        return self.embed.T if self.lm_head is None else self.lm_head


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Random weights from ``torch.Generator(device).manual_seed(seed)`` in
    the reference's layout and distribution: truncated normal(-2, 2) x 0.02
    for embed, lm_head (none when tied) and every projection (x 0.01 for an
    MoE router, in f32, and the mLSTM gates; x 0.1 for the mamba conv),
    drawn in that order and layer by layer, each block's in the reference's
    order (the mixer's leaves, the cross-attention's, then the FF's), then
    the encoder's blocks and ``vision_proj``; ones for the norms and the
    reference's constants for the undrawn leaves (``init_fixed``)."""
    device = torch.device(device)
    model = Model(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def fill(p: nn.Parameter, scale: float = 0.02):
        p.data.copy_(truncnorm_init(p.shape, p.dtype, gen, device, scale))

    with torch.no_grad():
        fill(model.embed)
        if model.lm_head is not None:
            fill(model.lm_head)
        model.final_norm.fill_(1.0)
        enc = [] if model.encoder is None else list(model.encoder.blocks)
        for blk in [*model.blocks, *enc]:
            blk.norm1.fill_(1.0)
            order = blk.mixer.init_order()
            blk.mixer.init_fixed()
            if blk.cross is not None:
                blk.norm_cross.fill_(1.0)
                order += blk.cross.init_order()
            if blk.spec.ff != "none":
                blk.norm2.fill_(1.0)
                order += blk.ff.init_order()
            for w, scale in order:
                fill(w, scale)
        if model.encoder is not None:
            model.encoder.norm.fill_(1.0)
        if model.vision_proj is not None:
            fill(model.vision_proj)
    return model


def kv_format(kv_policy=None, position: int = 0) -> F2PFormat:
    """The quantized-KV format of attention position ``position`` under
    ``kv_policy`` (a :class:`~repro_torch.autotune.policy.FormatPolicy` or
    None): the rule path is ``kv/b<position>``, as in the reference, so
    ``kv/*`` sets a stack-wide format and an exact path one position's
    layers; no policy keeps ``attention.KV_FMT``."""
    if kv_policy is None:
        return A.KV_FMT
    fmt, _ = kv_policy.f2p_for(f"kv/b{position}", (A.KV_FMT, 0))
    return fmt


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                quantized_kv: bool = False, kv_policy=None,
                attn_kv: bool = True, device="cuda"):
    """Caches ``{"b<i>": {...}}`` for every position of the pattern, each
    leaf ``[G, batch, ...]``: ``{"k","v"}`` ``[G, batch, max_seq, K, hd]``
    at an attention position, the mixer's zero state at a recurrent one.

    ``attn_kv=False`` leaves the attention positions out: the paged engine
    binds pool slabs there instead, and no dense ``[batch, max_seq]`` row
    is allocated. Quantized caches are always bit-packed, position ``i`` in
    the format :func:`kv_format` picks for ``kv/b<i>``."""
    device = torch.device(device)
    lead = (cfg.n_groups,)
    dt = cfg.torch_dtype
    out = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "attn":
            if attn_kv:
                out[f"b{i}"] = A.init_cache(cfg, batch, max_seq, quantized_kv,
                                            dt, device,
                                            fmt=kv_format(kv_policy, i),
                                            lead=lead)
        elif spec.mixer == "mamba":
            out[f"b{i}"] = SSM.init_mamba_cache(cfg, batch, dt, device, lead)
        elif spec.mixer == "mlstm":
            out[f"b{i}"] = XL.init_mlstm_cache(cfg, batch, device, lead)
        else:
            out[f"b{i}"] = XL.init_slstm_cache(cfg, batch, device, lead)
    return out


def layer_cache(caches, i: int, cfg: ModelConfig | None = None):
    """Layer ``i``'s cache view: ``{"k","v"}`` at an attention layer, the
    mixer's state leaves at a recurrent one (views share storage, so
    in-place writes land in the stack). With ``cfg``, ``caches`` is the
    per-position dict of :func:`init_caches` (or the pool slabs beside the
    recurrent state) and layer ``i`` is group ``i // P`` of position
    ``b<i % P>``; without, ``caches`` is one position's stack and ``i`` its
    group."""
    from repro_torch.core.qtensor import QTensor

    if cfg is not None:
        P = len(cfg.pattern)
        caches, i = caches[f"b{i % P}"], i // P

    def one(c):
        if isinstance(c, QTensor):
            return QTensor(c.codes[i], c.scales[i], c.fmt, c.block,
                           c.shape[1:], c.packed)
        return c[i]

    return {name: one(c) for name, c in caches.items()}


def _frames(frames, cfg: ModelConfig):
    if frames is None:
        # the reference fails here too (a KeyError on batch["frames"])
        raise KeyError(f"frames: {cfg.name} is an encoder-decoder; pass the "
                       "encoder's frame embeddings [B, encoder_seq, D]")
    return frames


def _embed(model: Model, tokens, cfg: ModelConfig):
    """Token embeddings, plus the sinusoidal rows 0..S-1 (cast to the model
    dtype first, as the reference) where ``pos="sinusoidal"``. An
    embedding of fewer than ``vocab_size`` rows is this model rank's slice
    of the vocabulary: it looks up the tokens it holds, zeros elsewhere,
    and the rows are summed over the model axis."""
    table = model.embed
    if table.shape[0] != cfg.vocab_size:
        vl = table.shape[0]
        idx = tokens - TP.model_rank() * vl
        inside = (idx >= 0) & (idx < vl)
        x = table[idx.clamp(0, vl - 1)] * inside[..., None].to(table.dtype)
        x = TP.from_model(x, "train.tp_embed")
    else:
        x = table[tokens]
    if cfg.pos == "sinusoidal":
        x = x + model.pos_table[:x.shape[1]]
    return constrain(x, ("batch", "seq", None))


def _lm_logits(model: Model, x):
    """``x @ head``, pinned to ("batch", "seq", "vocab")."""
    return constrain(x @ model.head(), ("batch", "seq", "vocab"))


def encode(model: Model, frames, cfg: ModelConfig | None = None):
    """Whisper's encoder over precomputed frame embeddings ``[B, Se, D]``
    (stub frontend): cast to the model dtype, plus sinusoidal positions,
    non-causal blocks, then the RMS norm. Returns ``[B, Se, D]``, the
    ``cross_kv`` of :func:`decode_step`."""
    cfg = cfg or model.cfg
    x = torch.as_tensor(frames, device=model.device).to(cfg.torch_dtype)
    x = x + model.pos_table[:x.shape[1]]
    split = _seq_split(x, cfg)
    if split:
        x = TP.chunk_model(x, 1, "train.tp_seq")
    for blk in model.encoder.blocks:
        x, _ = blk(x, cfg, mode="train", seq_split=split)
    if split:
        x = TP.gather_model_replicated(x, 1, "train.tp_seq")
    return rms_norm(x, model.encoder.norm, cfg.norm_eps)


def _seq_split(x, cfg: ModelConfig) -> bool:
    """Whether the residual stream ``x`` [B, S, D] runs split over the
    sequence: ``opt_seq_par`` under a model axis of m > 1 ranks (the
    sharded step), S a multiple of m and longer than it."""
    m = TP.model_size()
    return cfg.opt_seq_par and m > 1 and x.shape[1] % m == 0 \
        and x.shape[1] > m


def _maybe_prefix(model: Model, x, patches, cfg: ModelConfig):
    """Prepend the projected vision-patch embeddings (VLM stub frontend)."""
    if cfg.frontend == "vision" and patches is not None:
        pre = torch.as_tensor(patches, device=x.device).to(
            cfg.torch_dtype) @ model.vision_proj
        x = torch.cat([pre, x], dim=1)
    return x


def train_forward(model: Model, batch, cfg: ModelConfig | None = None):
    """batch: tokens ``[B, S]``, labels ``[B, S]`` (-1 = masked), and
    ``frames`` (an encoder-decoder: required) or ``patches`` (a vision
    config: optional; the labels are padded with -1 over the prefix).
    Returns (loss, metrics): mean token CE + 0.01 x the MoE layers' summed
    aux loss (0 for a dense stack), as the reference. With ``cfg.remat``
    every decoder block is recomputed in the backward
    (``torch.utils.checkpoint``), so only the block inputs stay alive
    between forward and backward."""
    from torch.utils.checkpoint import checkpoint

    cfg = cfg or model.cfg
    dev = model.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).to(torch.int64)
    labels = torch.as_tensor(batch["labels"], device=dev).to(torch.int64)
    patches = batch.get("patches")
    x = _maybe_prefix(model, _embed(model, tokens, cfg), patches, cfg)
    cross_kv = (encode(model, _frames(batch.get("frames"), cfg), cfg)
                if cfg.is_encdec else None)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    split = _seq_split(x, cfg)
    if split:
        x = TP.chunk_model(x, 1, "train.tp_seq")
    for blk in model.blocks:
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(blk, x, cfg, mode="train", cross_kv=cross_kv,
                              seq_split=split, use_reentrant=False)
        else:
            x, a = blk(x, cfg, mode="train", cross_kv=cross_kv,
                       seq_split=split)
        if a is not None:
            aux = aux + a
    if split:
        x = TP.gather_model_replicated(x, 1, "train.tp_seq")
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if cfg.frontend == "vision" and patches is not None:
        pad = torch.full((labels.shape[0], patches.shape[1]), -1,
                         dtype=labels.dtype, device=dev)
        labels = torch.cat([pad, labels], dim=1)
    loss = lm_loss(model, x, labels, cfg)
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}


def lm_loss(model: Model, x, labels, cfg: ModelConfig):
    """Mean token CE of the final hidden states ``x`` against ``labels``. A
    head of fewer than ``vocab_size`` columns is this model rank's slice of
    the vocabulary: the rank computes its logits, and the loss reduces the
    softmax over the model axis."""
    head = model.head()
    if head.shape[1] == cfg.vocab_size:
        return softmax_cross_entropy(_lm_logits(model, x), labels)
    logits = TP.to_model(x, "train.tp_logits") @ head
    return softmax_cross_entropy(
        logits, labels, vocab_start=TP.model_rank() * head.shape[1])


@torch.inference_mode()
def prefill(model: Model, tokens: torch.Tensor, caches, last_index=None,
            cfg: ModelConfig | None = None, *, frames=None, patches=None):
    """Consume prompts ``[B, S]``: writes the caches in place and returns
    the last-token logits ``[B, V]`` (at ``last_index[b]`` when given, for
    bucket-padded prompts). ``cfg`` overrides ``model.cfg`` for serve-time
    switches such as ``fused_attention``. An encoder-decoder needs
    ``frames`` ``[B, encoder_seq, D]`` (encoded here; pass :func:`encode`'s
    output to :func:`decode_step` as ``cross_kv``); a vision config takes
    ``patches`` ``[B, P, D]``, put in front of the tokens: the caches then
    hold P + S positions, and ``last_index`` and the decode positions
    count the prefix."""
    cfg = cfg or model.cfg
    x = _maybe_prefix(model, _embed(model, tokens, cfg), patches, cfg)
    cross_kv = (encode(model, _frames(frames, cfg), cfg) if cfg.is_encdec
                else None)
    for i, blk in enumerate(model.blocks):
        x, _ = blk(x, cfg, mode="prefill", cache=layer_cache(caches, i, cfg),
                   pos_offset=0, cross_kv=cross_kv)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if last_index is not None:
        li = torch.as_tensor(last_index, device=x.device).to(torch.int64)
        x = x[torch.arange(x.shape[0], device=x.device), li][:, None]
    else:
        x = x[:, -1:]
    return _lm_logits(model, x)[:, 0]


@torch.inference_mode()
def decode_step(model: Model, token: torch.Tensor, pos, caches, pages=None,
                cfg: ModelConfig | None = None, cross_kv=None):
    """One decode step: token ``[B, 1]``; ``pos`` a scalar write index or a
    per-slot ``[B]`` vector. With ``pages`` (``[B, max_pages]`` int32) the
    caches are pool slabs attended in place through the page table.
    ``cross_kv`` (an encoder-decoder): :func:`encode`'s output, attended
    by every decoder block's cross-attention (its K and V are projected
    from it again at every step, as the reference does). Returns logits
    ``[B, V]``; caches are updated in place."""
    cfg = cfg or model.cfg
    x = model.embed[token]
    if cfg.pos == "sinusoidal":
        table = model.pos_table
        if isinstance(pos, torch.Tensor) and pos.ndim:   # per-slot [B]
            x = x + table[pos.to(torch.int64)][:, None]
        else:
            x = x + table[int(pos)][None, None]
    for i, blk in enumerate(model.blocks):
        x, _ = blk(x, cfg, mode="decode", cache=layer_cache(caches, i, cfg),
                   pos_offset=pos, pages=pages, cross_kv=cross_kv)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _lm_logits(model, x)[:, 0]
