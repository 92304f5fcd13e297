"""LFM2-MoE in plain PyTorch, float32: the reference the port's
``horovod_tpu_torch.models.lfm2`` is held against.  It imports nothing
of the port and nothing of JAX, so it runs on the machine with the card
as well; it turns TF32 off where it computes.

It follows the layer equations of Hugging Face's ``Lfm2Moe*`` modules
(https://huggingface.co/LiquidAI/LFM2-8B-A1B, ``model_type: lfm2_moe``):
a layer is ``h = x + op(operator_norm(x))``, ``out = h +
ffn(ffn_norm(h))``; ``op`` is the gated short convolution ``out_proj(C
* conv(B * x))`` (``B, C, x = in_proj(h)``, depthwise and causal over
``conv_L_cache`` positions) or grouped-query attention with per-head
RMSNorm on q and k and rotary embeddings; ``ffn`` is a SwiGLU
``w2(silu(w1 h) * w3 h)``, dense in the first ``num_dense_layers``
layers and routed elsewhere: sigmoid scores over all experts, the top
``num_experts_per_tok`` of score plus ``expert_bias`` chosen, their
unbiased scores normalised by their sum + 1e-6 (``norm_topk_prob``) and
scaled by ``routed_scaling_factor``; then ``embedding_norm`` and the
head tied to the embedding; next-token cross-entropy.

Departures, each deliberate:

- the expert layers compute the part of the result that the experts in
  ``held`` give (the experts one rank holds under expert parallelism),
  routing over all of them; ``held = range(num_experts)`` is the whole
  layer.  Their weights are stacked: ``feed_forward.w1`` [len(held), I,
  H] and so on, in the port's ``state_dict`` names;
- the rotary tables stay in fp32 (Hugging Face casts them to the model's
  type);
- ``expert_bias`` is read from the weights where given (a buffer of the
  port's), else zero.
"""

import math

import torch
import torch.nn.functional as F


def dims(cfg: dict) -> dict:
    H, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"V": cfg["vocab_size"], "H": H, "heads": heads,
            "kv": cfg["num_key_value_heads"], "hd": H // heads,
            "I": cfg["intermediate_size"], "Im": cfg["moe_intermediate_size"],
            "E": cfg["num_experts"], "k": cfg["num_experts_per_tok"],
            "types": list(cfg["layer_types"]),
            "dense": cfg["num_dense_layers"], "eps": cfg["norm_eps"],
            "theta": cfg["rope_theta"], "taps": cfg["conv_L_cache"],
            "norm_topk": cfg["norm_topk_prob"],
            "scaling": cfg["routed_scaling_factor"]}


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def rotary(S, hd, theta, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(S, device=device, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rope(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def short_conv(w, p, h, d):
    S = h.shape[1]
    b, c, x = (h @ w[p + "conv.in_proj.weight"].t()).chunk(3, dim=-1)
    conv = F.conv1d((b * x).transpose(1, 2), w[p + "conv.conv.weight"],
                    padding=d["taps"] - 1, groups=d["H"])[..., :S]
    return (c * conv.transpose(1, 2)) @ w[p + "conv.out_proj.weight"].t()


def attention(w, p, h, d, cos, sin):
    B, S, _ = h.shape
    hd, kv = d["hd"], d["kv"]
    a = p + "self_attn."
    q = (h @ w[a + "q_proj.weight"].t()).view(B, S, -1, hd)
    k = (h @ w[a + "k_proj.weight"].t()).view(B, S, kv, hd)
    v = (h @ w[a + "v_proj.weight"].t()).view(B, S, kv, hd)
    q = rope(rms_norm(q, w[a + "q_layernorm.weight"], d["eps"]), cos, sin)
    k = rope(rms_norm(k, w[a + "k_layernorm.weight"], d["eps"]), cos, sin)
    rep = q.shape[2] // kv
    k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, -1)
    return ctx @ w[a + "out_proj.weight"].t()


def route(w, p, h, d):
    """(chosen experts [N, k], their weights [N, k]) of tokens ``h``."""
    f = p + "feed_forward."
    scores = torch.sigmoid(h @ w[f + "gate.weight"].t())
    bias = w.get(f + "expert_bias")
    pick = scores if bias is None else scores + bias
    chosen = torch.topk(pick, d["k"], dim=-1).indices
    weights = scores.gather(1, chosen)
    if d["norm_topk"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    return chosen, weights * d["scaling"]


def experts(w, p, h, d, held):
    """The routed layer's output on tokens ``h`` [N, H]: the part the
    experts ``held`` give."""
    f = p + "feed_forward."
    chosen, weights = route(w, p, h, d)
    out = torch.zeros_like(h)
    for j, e in enumerate(held):
        hit = chosen == e
        tok = hit.any(-1).nonzero()[:, 0]
        x = h[tok]
        act = F.silu(x @ w[f + "w1"][j].t()) * (x @ w[f + "w3"][j].t())
        weight = (weights * hit).sum(-1)[tok]
        out.index_add_(0, tok, (act @ w[f + "w2"][j].t()) * weight[:, None])
    return out


def dense_ffn(w, p, h):
    f = p + "feed_forward."
    act = F.silu(h @ w[f + "w1.weight"].t()) * (h @ w[f + "w3.weight"].t())
    return act @ w[f + "w2.weight"].t()


def forward(w: dict, ids: torch.Tensor, cfg: dict, held) -> torch.Tensor:
    """fp32 logits [B, S, V] of ``ids`` [B, S] under weights ``w``."""
    d = dims(cfg)
    B, S = ids.shape
    cos, sin = rotary(S, d["hd"], d["theta"], ids.device)
    wte = w["embed_tokens.weight"]
    x = wte[ids]
    for i, kind in enumerate(d["types"]):
        p = f"layers.{i}."
        h = rms_norm(x, w[p + "operator_norm.weight"], d["eps"])
        x = x + (short_conv(w, p, h, d) if kind == "conv"
                 else attention(w, p, h, d, cos, sin))
        h = rms_norm(x, w[p + "ffn_norm.weight"], d["eps"])
        if i < d["dense"]:
            x = x + dense_ffn(w, p, h)
        else:
            x = x + experts(w, p, h.reshape(B * S, -1), d,
                            held).view(B, S, -1)
    x = rms_norm(x, w["embedding_norm.weight"], d["eps"])
    return x @ wte.t()


def loss_of(w: dict, ids: torch.Tensor, cfg: dict, held) -> torch.Tensor:
    """Mean next-token cross-entropy over positions 0 .. S-2."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        logits = forward(w, ids, cfg, held)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, V),
                           ids[:, 1:].reshape(-1))
