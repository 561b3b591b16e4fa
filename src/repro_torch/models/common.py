"""Shared layer primitives (port of ``repro.models.common``): RMS norm,
RoPE, sinusoidal positions, SwiGLU, the truncated-normal init and the
token cross-entropy."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models import parallel as TP
from repro_torch.models.sharding import constrain


# f32 elements drawn per call: a larger tensor (an MoE's [E, D, F] experts)
# is drawn in slices of its leading axis, so the f32 draw never holds more
# than this beside the result
_INIT_CHUNK = 1 << 28


def truncnorm_init(shape, dtype, generator: torch.Generator, device,
                   scale: float = 0.02) -> torch.Tensor:
    """``scale * truncated_normal(-2, 2)`` drawn in f32 from ``generator``
    and cast to ``dtype`` — the reference's init distribution (torch draws
    other numbers than jax.random from the same seed)."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    if n <= _INIT_CHUNK or len(shape) < 2 or shape[0] == 1:
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (t * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, _INIT_CHUNK // (n // shape[0]))
    for i in range(0, shape[0], rows):
        out[i:i + rows] = truncnorm_init(out[i:i + rows].shape, dtype,
                                         generator, device, scale)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # built once per device: a host->device copy per call would make every
    # layer wait for the stream
    return torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                        device=device)


def _rope_table(head_dim: int, theta: float, device: torch.device):
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is None:
        return _rope_freqs_on(head_dim, theta, device)
    # under a FakeTensorMode (the dry run, which allows real inputs) the
    # cached table is made and returned real, so that no fake tensor stays
    # in the cache and a fake step reads the same constant as a real one
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return _rope_freqs_on(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = _rope_table(hd, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int) -> np.ndarray:
    """The reference's f32 ``[seq, d_model]`` table, bit for bit: sin at
    even columns, cos at odd ones. A row depends only on its position, so
    the first rows of a longer table are the table of a shorter one."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    ang = pos / (10000 ** (dim / d_model))
    out = np.zeros((seq, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def swiglu(x, w_gate, w_up, w_down, constrain_ff: bool = True,
           split: bool = False, leg: str = "train.tp_ff"):
    """Llama-style gated MLP. x [..., D]; w_gate/w_up [D, F]; w_down [F, D].
    ``constrain_ff`` pins the hidden activations to the "ff" axis; under
    sequence parallelism the caller passes False (the reference's
    knob).

    ``split``: the weights are this model rank's rows, as the rules place
    a stacked 2-D FF leaf (it takes the expert entry: gate / up split over
    D, down over F). The rank multiplies its columns of x by its gate and
    up rows, the partial products are summed over the model axis (one
    reduction of both), and it multiplies its columns of the hidden
    activations by its down rows, that partial output summed again."""
    if split:
        xl = TP.chunk_model(x, -1, leg + "_x")
        gu = TP.from_model(torch.cat([xl @ w_gate, xl @ w_up], dim=-1),
                          leg + "_gate_up")
        g, u = gu.chunk(2, dim=-1)
    else:
        g = x @ w_gate
        u = x @ w_up
    if constrain_ff:
        g = constrain(g, ("batch", None, "ff"))
        u = constrain(u, ("batch", None, "ff"))
    h = torch.nn.functional.silu(g) * u
    if split:
        return TP.from_model(TP.chunk_model(h, -1, leg + "_hidden") @ w_down,
                            leg)
    return h @ w_down


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0,
                          vocab_start: int | None = None) -> torch.Tensor:
    """Mean token CE in f32; labels < 0 are masked out. With
    ``vocab_start`` the logits are this model rank's columns of the
    vocabulary, from ``vocab_start`` on: the max, the sum of exps and the
    label's logit are reduced over the model axis (the softmax gradient
    stays local)."""
    logits = logits.to(torch.float32)
    if vocab_start is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None].to(
            torch.int64))[..., 0]
    else:
        lse, ll = _split_lse_and_label(logits, labels, vocab_start)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    mask = labels >= 0
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1)


def _split_lse_and_label(logits, labels, v0: int):
    """(logsumexp, the label's logit) of logits split over the vocabulary:
    three reductions over the model axis."""
    vl = logits.shape[-1]
    mx = TP.max_over_model(logits.amax(dim=-1), "train.tp_loss")
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    sumexp = TP.from_model(torch.exp(logits - mx[..., None]).sum(dim=-1),
                          "train.tp_loss_sumexp")
    lse = torch.log(sumexp) + mx
    idx = labels.to(torch.int64) - v0
    inside = (idx >= 0) & (idx < vl)
    ll = torch.gather(logits, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    ll = TP.from_model(torch.where(inside, ll, 0.0), "train.tp_loss_label")
    return lse, ll
