"""LFM2-MoE (Liquid AI's ``lfm2_moe``, e.g. LFM2-8B-A1B) in PyTorch.

The layer equations of Hugging Face's ``Lfm2Moe*`` modules:

- a layer: ``h = x + op(operator_norm(x))``, ``out = h +
  ffn(ffn_norm(h))``, where ``op`` is the layer's kind in
  ``layer_types``;
- ``conv``, the gated short convolution: ``B, C, x = in_proj(h)``
  split in three along the features, ``y = out_proj(C * conv(B * x))``
  with ``conv`` depthwise over the sequence, ``conv_L_cache`` taps,
  causal (left padding ``conv_L_cache - 1``);
- ``full_attention``: ``q = RMSNorm_head(q_proj h)``, ``k =
  RMSNorm_head(k_proj h)``, rotary embeddings on both (``rope_theta``,
  the halves rotated), causal grouped-query attention (each key/value
  head serves ``num_attention_heads / num_key_value_heads`` query
  heads), ``out_proj``;
- the feed-forward of the first ``num_dense_layers`` layers is a SwiGLU
  ``w2(silu(w1 h) * w3 h)`` of width ``intermediate_size``; every other
  layer's is :class:`~..parallel.moe.DroplessMoE`: ``num_experts``
  SwiGLU experts of width ``moe_intermediate_size``,
  ``num_experts_per_tok`` a token by sigmoid score plus
  ``expert_bias``, of which this model holds ``experts_held``;
- the model: token embedding, the layers, ``embedding_norm``, and the
  LM head tied to the embedding.

Cast points, as :mod:`.gpt`'s: fp32 parameters; the residual stream,
every projection, the convolution and its gates, attention and the
experts in ``cfg.dtype`` (bf16 by default); RMSNorm statistics and
scales, the QK norms and the rotary embedding in fp32, each rounded once
to ``cfg.dtype``; the router's logits, scores and weights in fp32; fp32
logits.  ``attention_impl="flash"`` runs attention through
:func:`horovod_tpu_torch.ops.flash_attention` (the CUDA kernels on the
card, key and value heads repeated to the query heads first);
``"plain"`` is the softmax written out, for the CPU.
"""

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common.timeline import span
from ..parallel.moe import DroplessMoE
from .gpt import _dense, _init_rng, _normal, resolve_device

_HF_KEYS = ("vocab_size", "hidden_size", "intermediate_size",
            "moe_intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "num_dense_layers",
            "num_experts", "num_experts_per_tok", "use_expert_bias",
            "norm_topk_prob", "routed_scaling_factor", "conv_L_cache",
            "conv_bias", "norm_eps", "rope_theta")


@dataclasses.dataclass(frozen=True)
class LFM2MoEConfig:
    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    layer_types: Tuple[str, ...] = (
        "conv", "conv", "full_attention", "conv", "conv", "conv",
        "full_attention", "conv", "conv", "conv", "full_attention", "conv",
        "conv", "conv", "full_attention", "conv", "conv", "conv",
        "full_attention", "conv", "conv", "full_attention", "conv", "conv")
    num_dense_layers: int = 2
    num_experts: int = 32
    num_experts_per_tok: int = 4
    use_expert_bias: bool = True
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    conv_L_cache: int = 3
    conv_bias: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    initializer_range: float = 0.02
    # The experts this model holds of each expert layer's num_experts
    # (expert parallelism: the rest are other ranks'); None holds all.
    experts_held: Optional[range] = None
    dtype: torch.dtype = torch.bfloat16
    # "plain": attention written out in torch; "flash":
    # ops/flash_attention.py (the CUDA kernels on the card).
    attention_impl: str = "plain"

    def __post_init__(self):
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for "
                             f"{self.num_hidden_layers} layers")
        unknown = set(self.layer_types) - {"conv", "full_attention"}
        if unknown:
            raise ValueError(f"unknown layer types {sorted(unknown)}")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of "
                             "num_key_value_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def held(self) -> range:
        return (range(self.num_experts) if self.experts_held is None
                else self.experts_held)

    @classmethod
    def from_dict(cls, published: dict, **kw) -> "LFM2MoEConfig":
        """The config from a published ``config.json``'s keys; ``kw`` sets
        the fields the file does not (``experts_held``, ``dtype``,
        ``attention_impl``) or overrides them."""
        fields = {k: published[k] for k in _HF_KEYS if k in published}
        fields["layer_types"] = tuple(published["layer_types"])
        fields.update(kw)
        return cls(**fields)


class _RMSNorm(torch.autograd.Function):
    """``x / rms(x) * weight`` over the last axis, computed in fp32 and
    rounded once to ``out_dtype``; saves ``x`` as it came and the fp32
    reciprocal rms, and makes the normalised ``x`` again in the
    backward."""

    @staticmethod
    def forward(ctx, x, weight, eps, out_dtype):
        xf = x.float()
        rstd = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, weight, rstd)
        return (xf * rstd * weight.float()).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        xhat = x.float() * rstd
        dy = dy.float()
        dw = (dy * xhat).reshape(-1, xhat.shape[-1]).sum(0)
        g = dy * weight.float()
        dx = rstd * (g - xhat * (g * xhat).mean(-1, keepdim=True))
        return dx.to(x.dtype), dw.to(weight.dtype), None, None


def rotary(seq_len: int, head_dim: int, theta: float, device):
    """fp32 ``(cos, sin)`` [seq_len, head_dim] of positions 0.. with the
    frequencies ``theta^(-2i/head_dim)`` repeated over the two halves."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=device,
                                       dtype=torch.float32) / head_dim)
    ang = torch.arange(seq_len, device=device, dtype=torch.float32)[:, None] \
        * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def apply_rotary(x, cos, sin):
    """``x`` [B, S, heads, D] rotated: ``x cos + rotate_half(x) sin``."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))

    def forward(self, x, out_dtype):
        return _RMSNorm.apply(x, self.weight, self.eps, out_dtype)


class ShortConv(nn.Module):
    """The gated short convolution: ``out_proj(C * conv(B * x))``."""

    def __init__(self, cfg: LFM2MoEConfig):
        super().__init__()
        self.config = cfg
        h, bias = cfg.hidden_size, cfg.conv_bias
        self.in_proj = nn.Linear(h, 3 * h, bias=bias)
        self.conv = nn.Conv1d(h, h, cfg.conv_L_cache, groups=h, bias=bias,
                              padding=cfg.conv_L_cache - 1)
        self.out_proj = nn.Linear(h, h, bias=bias)

    def forward(self, x):
        cfg, dt = self.config, self.config.dtype
        S = x.shape[1]
        b, c, xx = _dense(x, self.in_proj, dt).chunk(3, dim=-1)
        bx = (b * xx).transpose(1, 2)
        conv = F.conv1d(bx, self.conv.weight.to(dt),
                        None if self.conv.bias is None
                        else self.conv.bias.to(dt),
                        padding=cfg.conv_L_cache - 1,
                        groups=cfg.hidden_size)[..., :S]
        return _dense(c * conv.transpose(1, 2), self.out_proj, dt)


class Attention(nn.Module):
    """Grouped-query attention with per-head RMSNorm on q and k and
    rotary embeddings, causal."""

    def __init__(self, cfg: LFM2MoEConfig):
        super().__init__()
        self.config = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(h, cfg.num_attention_heads * hd, bias=False)
        self.k_proj = nn.Linear(h, cfg.num_key_value_heads * hd, bias=False)
        self.v_proj = nn.Linear(h, cfg.num_key_value_heads * hd, bias=False)
        self.out_proj = nn.Linear(cfg.num_attention_heads * hd, h, bias=False)
        self.q_layernorm = RMSNorm(hd, cfg.norm_eps)
        self.k_layernorm = RMSNorm(hd, cfg.norm_eps)

    def forward(self, x, cos, sin):
        cfg, dt = self.config, self.config.dtype
        B, S, _ = x.shape
        hd, kv = cfg.head_dim, cfg.num_key_value_heads
        q = _dense(x, self.q_proj, dt).view(B, S, -1, hd)
        k = _dense(x, self.k_proj, dt).view(B, S, kv, hd)
        v = _dense(x, self.v_proj, dt).view(B, S, kv, hd)
        q = apply_rotary(self.q_layernorm(q, torch.float32), cos, sin).to(dt)
        k = apply_rotary(self.k_layernorm(k, torch.float32), cos, sin).to(dt)
        rep = q.shape[2] // kv
        # Query head h reads key/value head h // rep.
        k, v = (t[:, :, :, None].expand(B, S, kv, rep, hd)
                .reshape(B, S, kv * rep, hd) for t in (k, v))
        if cfg.attention_impl == "flash":
            from ..ops.flash_attention import flash_attention
            ctx = flash_attention(q, k, v, causal=True).to(dt)
        else:
            ctx = self._plain_core(q, k, v)
        return _dense(ctx.reshape(B, S, -1), self.out_proj, dt)

    def _plain_core(self, q, k, v):
        S, hd = q.shape[1], q.shape[-1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
        causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class DenseFFN(nn.Module):
    """SwiGLU ``w2(silu(w1 x) * w3 x)``, no biases."""

    def __init__(self, hidden: int, inter: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.w1 = nn.Linear(hidden, inter, bias=False)
        self.w3 = nn.Linear(hidden, inter, bias=False)
        self.w2 = nn.Linear(inter, hidden, bias=False)

    def forward(self, x):
        dt = self.dtype
        return _dense(F.silu(_dense(x, self.w1, dt)) * _dense(x, self.w3, dt),
                      self.w2, dt)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LFM2MoEConfig, index: int):
        super().__init__()
        self.config = cfg
        self.kind = cfg.layer_types[index]
        h = cfg.hidden_size
        self.operator_norm = RMSNorm(h, cfg.norm_eps)
        if self.kind == "conv":
            self.conv = ShortConv(cfg)
        else:
            self.self_attn = Attention(cfg)
        self.ffn_norm = RMSNorm(h, cfg.norm_eps)
        self.moe = index >= cfg.num_dense_layers
        if self.moe:
            self.feed_forward = DroplessMoE(
                h, cfg.moe_intermediate_size, cfg.num_experts,
                cfg.num_experts_per_tok, cfg.held, cfg.norm_topk_prob,
                cfg.routed_scaling_factor, cfg.use_expert_bias)
        else:
            self.feed_forward = DenseFFN(h, cfg.intermediate_size, cfg.dtype)

    def forward(self, x, cos, sin):
        dt = self.config.dtype
        h = self.operator_norm(x, dt)
        if self.kind == "conv":
            with span("lfm2.conv"):
                h = self.conv(h)
        else:
            with span("lfm2.attention"):
                h = self.self_attn(h, cos, sin)
        x = x + h
        h = self.ffn_norm(x, dt)
        if self.moe:
            B, S, H = h.shape
            f = self.feed_forward(h.reshape(B * S, H)).view(B, S, H)
        else:
            with span("lfm2.ffn"):
                f = self.feed_forward(h)
        return x + f


class LFM2MoEForCausalLM(nn.Module):
    """The LFM2-MoE stack and its tied LM head; ``forward(ids)`` gives
    fp32 logits [B, S, vocab].

    ``device=None`` builds on the card (and raises if there is none);
    weights are drawn from ``seed`` (numpy, as :mod:`.gpt` draws them):
    N(0, ``initializer_range``) for every matrix, the embedding and the
    convolution, unit norm scales, zero biases and expert bias.  Build on
    the ``meta`` device to draw nothing and copy weights in."""

    def __init__(self, cfg: LFM2MoEConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.embedding_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self._rotary = {}
        self.reset_parameters(seed)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        rng = _init_rng(seed)
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                _normal(p, std, rng)
        for b in self.buffers():
            b.zero_()

    def _cos_sin(self, seq_len: int, device):
        key = (seq_len, str(device))
        if key not in self._rotary:
            cfg = self.config
            self._rotary[key] = rotary(seq_len, cfg.head_dim, cfg.rope_theta,
                                       device)
        return self._rotary[key]

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        with span("lfm2.forward"):
            cfg = self.config
            with span("lfm2.embed"):
                wte = self.embed_tokens.weight.to(cfg.dtype)
                x = F.embedding(input_ids, wte)
                cos, sin = self._cos_sin(input_ids.shape[1], x.device)
            for i, layer in enumerate(self.layers):
                with span("lfm2.block", layer=i,
                          op="conv" if layer.kind == "conv" else "attention",
                          ffn="moe" if layer.moe else "dense"):
                    x = layer(x, cos, sin)
            with span("lfm2.head"):
                x = self.embedding_norm(x, cfg.dtype)
                return torch.matmul(x, wte.t()).float()
