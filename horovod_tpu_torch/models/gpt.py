"""GPT-style decoder-only language model in PyTorch.

Counterpart of :mod:`horovod_tpu.models.gpt`, with the same cast points:
fp32 parameters; embeddings, dense layers and attention computed in
``cfg.dtype`` (bf16 by default); layer-norm statistics in fp32 with the
result in ``cfg.dtype``; tanh-GELU; a tied LM head ``x @ wte.T`` in
``cfg.dtype`` and fp32 logits.  ``attention_impl="flash"`` routes
attention through :func:`horovod_tpu_torch.ops.flash_attention`, whose
forward on a CUDA tensor is the hand-written kernel.

:func:`convert_flax_gpt_params` maps the JAX package's flax parameter
tree (flattened with ``/``) onto this module's ``state_dict``.
"""

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    # "einsum": plain torch attention; "flash": ops/flash_attention.py
    # (the CUDA kernel on the card), causal.
    attention_impl: str = "einsum"


def gpt2_small_config(**kw) -> GPTConfig:
    return GPTConfig(**kw)


def gpt2_medium_config(**kw) -> GPTConfig:
    defaults = dict(hidden_size=1024, num_layers=24, num_heads=16,
                    intermediate_size=4096)
    defaults.update(kw)
    return GPTConfig(**defaults)


def gpt_tiny_config(**kw) -> GPTConfig:
    """Tiny config for tests."""
    defaults = dict(vocab_size=512, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128,
                    max_position_embeddings=128, dropout=0.0)
    defaults.update(kw)
    return GPTConfig(**defaults)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  With no card present the caller must
    ask for the CPU explicitly; nothing falls back to it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _dense(x, layer: nn.Linear, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def _layer_norm(x, norm: nn.LayerNorm, dtype):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)

    def forward(self, x):
        cfg = self.config
        B, S, _ = x.shape
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        q, k, v = (_dense(x, lin, cfg.dtype).view(B, S, nh, hd)
                   for lin in (self.query, self.key, self.value))
        if cfg.attention_impl == "flash":
            if cfg.dropout > 0.0 and self.training:
                raise NotImplementedError(
                    "attention_impl='flash' does not apply attention "
                    "dropout; set dropout=0 or use 'einsum' (same "
                    "guard as the BERT family).")
            from ..ops.flash_attention import flash_attention
            ctx = flash_attention(q, k, v, causal=True).to(cfg.dtype)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
            scores = scores / math.sqrt(hd)
            causal = torch.ones(S, S, dtype=torch.bool,
                                device=x.device).tril()
            scores = torch.where(
                causal, scores,
                torch.tensor(torch.finfo(cfg.dtype).min, dtype=scores.dtype,
                             device=x.device))
            probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
            probs = F.dropout(probs, cfg.dropout, self.training)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return _dense(ctx.reshape(B, S, cfg.hidden_size), self.out,
                      cfg.dtype)


class GPTBlock(nn.Module):
    """Pre-LN residual block (GPT-2 layout)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.attention_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.attention = CausalSelfAttention(cfg)
        self.mlp_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(h, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, h)

    def forward(self, x):
        cfg = self.config
        h = self.attention(_layer_norm(x, self.attention_norm, cfg.dtype))
        x = x + F.dropout(h, cfg.dropout, self.training)
        m = _dense(_layer_norm(x, self.mlp_norm, cfg.dtype),
                   self.intermediate, cfg.dtype)
        m = F.gelu(m, approximate="tanh")
        m = _dense(m, self.output, cfg.dtype)
        return x + F.dropout(m, cfg.dropout, self.training)


def _trunc_normal(t: torch.Tensor, fan_in: int, g: torch.Generator):
    # flax's lecun_normal: variance 1/fan_in from a normal truncated at
    # two standard deviations (std rescaled by the truncation's 0.8796).
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


class GPTLMHeadModel(nn.Module):
    """Decoder stack + tied-embedding LM head.

    ``device=None`` builds on the card (and raises if there is none);
    weights are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` with flax's default initialisers, so a seed gives the same
    model on every device."""

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, h)
        self.layers = nn.ModuleList(GPTBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.reset_parameters(seed)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        g = torch.Generator().manual_seed(seed)
        for emb in (self.word_embeddings, self.position_embeddings):
            # flax Embed: variance_scaling(1, fan_in, normal, out_axis=0)
            # on a [num, H] table, whose fan-in is num.
            emb.weight.normal_(0.0, 1.0 / math.sqrt(emb.num_embeddings),
                               generator=g)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                _trunc_normal(mod.weight, mod.in_features, g)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        S = input_ids.shape[1]
        wte = self.word_embeddings.weight.to(cfg.dtype)
        pos = torch.arange(S, device=input_ids.device)
        x = (F.embedding(input_ids, wte) +
             F.embedding(pos, self.position_embeddings.weight.to(
                 cfg.dtype))[None])
        x = F.dropout(x, cfg.dropout, self.training)
        for block in self.layers:
            if cfg.remat and self.training:
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = _layer_norm(x, self.final_norm, cfg.dtype)
        return torch.matmul(x, wte.t()).float()


def lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy: position t predicts token t+1.
    ``mask`` (optional) is 1 where the TARGET token counts."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = input_ids[:, 1:].long()
    ll = logp.gather(-1, targets[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    m = mask[:, 1:].float()
    return -(ll * m).sum() / m.sum().clamp_min(1.0)


def convert_flax_gpt_params(flat: Dict[str, np.ndarray]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's GPT parameters, flattened with ``/`` (a leading
    ``params/`` is dropped), as this module's ``state_dict`` (fp32, CPU).

    Dense kernels are ``[in, out]`` (attention's ``[H, heads, hd]`` and
    ``[heads, hd, H]``, reshaped to 2-D) and become ``nn.Linear``
    weights ``[out, in]``; layer-norm ``scale`` becomes ``weight``."""
    sd = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        arr = np.asarray(value, dtype=np.float32)
        leaf = parts[-1]
        mod = parts[:-1]
        if mod and mod[0].startswith("layer_"):
            mod = ["layers", mod[0][len("layer_"):]] + mod[1:]
        prefix = ".".join(mod)
        if leaf == "embedding":
            name, out = "weight", arr
        elif leaf == "kernel":
            if mod[-1] == "out":               # [heads, hd, H]
                arr = arr.reshape(-1, arr.shape[-1])
            else:                              # [H, ...]
                arr = arr.reshape(arr.shape[0], -1)
            name, out = "weight", arr.T
        elif leaf == "bias":
            name, out = "bias", arr.reshape(-1)
        elif leaf == "scale":
            name, out = "weight", arr
        else:
            raise KeyError(f"unexpected flax GPT parameter {key!r}")
        sd[f"{prefix}.{name}"] = torch.tensor(out)
    return sd
