"""BERT encoder family in PyTorch.

Counterpart of :mod:`horovod_tpu.models.bert`, with the same cast
points as the port's GPT: fp32 parameters; embeddings, dense layers and
attention in ``cfg.dtype`` (bf16 by default); layer-norm statistics in
fp32 with the result in ``cfg.dtype``; tanh-GELU; post-LN residual
blocks; a tied MLM head ``x @ word_embeddings.T`` in ``cfg.dtype`` with
fp32 logits plus ``mlm_bias``.  Parameter names follow the flax tree
(``encoder.layers.N.attention.query`` for ``encoder/layer_N/attention/
query``), so the partition rules of :mod:`horovod_tpu_torch.parallel.
sharding` map onto them; :func:`convert_flax_bert_params` carries the
JAX package's weights over.

``attention_impl="flash"`` runs the port's flash kernel (non-causal);
like the JAX model it refuses a padding mask and attention dropout.
Dropout is flax's: a kept element is scaled by ``1 / (1 - rate)``.  Its
masks are drawn over the whole (global) activation from ``generator``,
so that a sharded forward drops what the unsharded one does.
"""

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.utils.checkpoint import checkpoint

from ..parallel.layers import embed, on_local_shards
from .gpt import (_dense, _init_rng, _layer_norm, _normal, _trunc_normal,
                  resolve_device)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    # Recompute each layer in the backward (torch.utils.checkpoint).
    remat: bool = False
    # "einsum": plain torch attention (takes a padding mask);
    # "flash": ops/flash_attention.py (the CUDA kernel on the card).
    attention_impl: str = "einsum"


def bert_large_config(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_base_config(**kw) -> BertConfig:
    return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                      intermediate_size=3072, **kw)


def bert_tiny_config(**kw) -> BertConfig:
    """Tiny config for tests and multi-rank dry runs."""
    defaults = dict(vocab_size=512, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128,
                    max_position_embeddings=128,
                    hidden_dropout=0.0, attention_dropout=0.0)
    defaults.update(kw)
    return BertConfig(**defaults)


def _dropout(x, rate: float, deterministic: bool,
             generator: Optional[torch.Generator]):
    """flax's Dropout: keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``.  The mask is drawn over ``x``'s global shape on
    ``x``'s device; a DTensor takes its own shard of it."""
    if deterministic or rate == 0.0:
        return x
    device = generator.device if generator is not None else x.device
    keep = torch.rand(tuple(x.shape), generator=generator,
                      device=device) >= rate
    keep = keep.to(x.device)
    if isinstance(x, DTensor):
        placements = [Replicate() if p.is_partial() else p
                      for p in x.placements]
        keep = distribute_tensor(keep, x.device_mesh, placements,
                                 src_data_rank=None)
    return x * keep.to(x.dtype) / (1.0 - rate)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)

    def forward(self, x, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        B, S, _ = x.shape
        hd = cfg.hidden_size // cfg.num_heads
        q, k, v = (_dense(x, lin, cfg.dtype).view(B, S, -1, hd)
                   for lin in (self.query, self.key, self.value))
        if cfg.attention_impl == "flash":
            if mask is not None:
                raise NotImplementedError(
                    "attention_impl='flash' does not support padding "
                    "masks yet; use 'einsum' or drop the mask.")
            if cfg.attention_dropout > 0.0 and not deterministic:
                raise NotImplementedError(
                    "attention_impl='flash' does not apply attention "
                    "dropout; set attention_dropout=0 or use 'einsum'.")
            from ..ops.flash_attention import flash_attention
            ctx = on_local_shards(flash_attention, q, k, v).to(cfg.dtype)
        else:
            drop = None
            if cfg.attention_dropout > 0.0 and not deterministic:
                # [B, heads, S, S] keep mask over the global probs.
                device = (generator.device if generator is not None
                          else x.device)
                drop = torch.rand((B, cfg.num_heads, S, S),
                                  generator=generator, device=device) \
                    >= cfg.attention_dropout
            ctx = on_local_shards(self._einsum_core, q, k, v,
                                  (mask, {0: 0}), (drop, {0: 0, 2: 1}))
        return _dense(ctx.reshape(B, S, cfg.hidden_size), self.out,
                      cfg.dtype)

    def _einsum_core(self, q, k, v, mask, keep):
        cfg = self.config
        # [batch, heads, q_len, k_len]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        scores = scores / math.sqrt(q.shape[-1])
        if mask is not None:
            big_neg = torch.tensor(torch.finfo(cfg.dtype).min,
                                   dtype=scores.dtype, device=q.device)
            scores = torch.where(mask[:, None, None, :].bool(), scores,
                                 big_neg)
        probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
        if keep is not None:
            probs = probs * keep.to(probs.dtype) / \
                (1.0 - cfg.attention_dropout)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.attention = SelfAttention(cfg)
        self.attention_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(h, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, h)
        self.output_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        attn_out = self.attention(x, mask, deterministic, generator)
        attn_out = _dropout(attn_out, cfg.hidden_dropout, deterministic,
                            generator)
        x = _layer_norm(x + attn_out, self.attention_norm, cfg.dtype)
        h = _dense(x, self.intermediate, cfg.dtype)
        h = F.gelu(h, approximate="tanh")
        h = _dense(h, self.output, cfg.dtype)
        h = _dropout(h, cfg.hidden_dropout, deterministic, generator)
        return _layer_norm(x + h, self.output_norm, cfg.dtype)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, h)
        if cfg.type_vocab_size:
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                      h)
        self.embeddings_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        S = input_ids.shape[1]
        emb = (embed(input_ids, self.word_embeddings.weight.to(cfg.dtype)) +
               self.position_embeddings.weight[:S].to(cfg.dtype)[None])
        if cfg.type_vocab_size:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            emb = emb + embed(
                token_type_ids,
                self.token_type_embeddings.weight.to(cfg.dtype))
        x = _layer_norm(emb, self.embeddings_norm, cfg.dtype)
        x = _dropout(x, cfg.hidden_dropout, deterministic, generator)
        for layer in self.layers:
            if cfg.remat and not deterministic:
                x = checkpoint(layer, x, attention_mask, deterministic,
                               generator, use_reentrant=False)
            else:
                x = layer(x, attention_mask, deterministic, generator)
        return x


class BertForMaskedLM(nn.Module):
    """Encoder + tied-embedding MLM head.

    ``device=None`` builds on the card (and raises if there is none);
    weights are drawn on the CPU from ``_init_rng(seed)`` (numpy) with
    flax's default initialisers, as ``GPTLMHeadModel.reset_parameters``
    draws them."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        h = cfg.hidden_size
        self.encoder = BertEncoder(cfg)
        self.mlm_transform = nn.Linear(h, h)
        self.mlm_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.reset_parameters(seed)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        rng = _init_rng(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Embedding):
                # flax Embed: variance_scaling(1, fan_in, normal,
                # out_axis=0) on a [num, H] table, whose fan-in is num.
                _normal(mod.weight, 1.0 / math.sqrt(mod.num_embeddings), rng)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                _trunc_normal(mod.weight, mod.in_features, rng)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.mlm_bias.zero_()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.config
        x = self.encoder(input_ids, token_type_ids, attention_mask,
                         deterministic, generator)
        x = _dense(x, self.mlm_transform, cfg.dtype)
        x = F.gelu(x, approximate="tanh")
        x = _layer_norm(x, self.mlm_norm, cfg.dtype)
        # Tied output projection: the word embedding matrix.
        wte = self.encoder.word_embeddings.weight.to(cfg.dtype)
        return torch.matmul(x, wte.t()).float() + self.mlm_bias


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over masked positions; ``mask`` is 1 where the token
    was masked (predicted).  On DTensors both sums are global."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    m = mask.float()
    return -(ll * m).sum() / m.sum().clamp_min(1.0)


def convert_flax_bert_params(flat: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's BERT parameters, flattened with ``/`` (a
    leading ``params/`` is dropped), as this module's ``state_dict``
    (fp32, CPU): ``layer_N`` becomes ``layers.N``; dense kernels
    ``[in, out]`` (attention's ``[H, heads, hd]`` and ``[heads, hd, H]``
    reshaped to 2-D) become ``nn.Linear`` weights ``[out, in]``;
    ``embedding`` and layer-norm ``scale`` become ``weight``."""
    sd = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        arr = np.asarray(value, dtype=np.float32)
        mod, leaf = parts[:-1], parts[-1]
        names = []
        for p in mod:
            names += (["layers", p[len("layer_"):]]
                      if p.startswith("layer_") else [p])
        if not mod:                            # mlm_bias
            sd[leaf] = torch.tensor(arr)
            continue
        if leaf in ("embedding", "scale"):
            name, out = "weight", arr
        elif leaf == "kernel":
            if mod[-1] == "out":               # [heads, hd, H]
                arr = arr.reshape(-1, arr.shape[-1])
            else:                              # [H, ...]
                arr = arr.reshape(arr.shape[0], -1)
            name, out = "weight", arr.T
        elif leaf == "bias":
            name, out = "bias", arr.reshape(-1)
        else:
            raise KeyError(f"unexpected flax BERT parameter {key!r}")
        sd[".".join(names + [name])] = torch.tensor(np.ascontiguousarray(out))
    return sd
