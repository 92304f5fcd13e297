"""LFM2-8B-A1B in plain PyTorch, float32, TF32 off: the reference that
decides ``correct`` for the ``lfm2_8b_a1b`` cells.

The layer equations of Hugging Face's ``Lfm2Moe*`` modules (Liquid AI,
``model_type: lfm2_moe``): a layer is ``h = x + op(operator_norm(x))``,
``out = h + ffn(ffn_norm(h))``; ``op`` is the gated short convolution
``out_proj(C * conv(B * x))`` (``B, C, x = in_proj(h)``, depthwise,
causal over ``conv_L_cache`` positions) or grouped-query attention with
per-head RMSNorm on q and k and rotary embeddings; ``ffn`` is a SwiGLU,
dense in the first ``num_dense_layers`` layers and routed elsewhere
(sigmoid scores over all experts, top ``num_experts_per_tok`` of score
plus ``expert_bias``, unbiased scores normalised by their sum + 1e-6,
times ``routed_scaling_factor``); then ``embedding_norm`` and the head
tied to the embedding; next-token cross-entropy over positions 0..S-2.
Departures: the routed layers compute the part the held experts give
(``deployment``: the experts this chip holds of the published count,
routing over all), their weights stacked per layer; the rotary tables in
fp32; ``expert_bias`` zero, as ``assumed``.

The same mathematics as the repository's ``tests/plain_lfm2.py``, which
a tier-1 test holds this copy to.  Each layer is recomputed in the
backward (``torch.utils.checkpoint``, exact in fp32), so that the step
fits beside the fp32 weights, gradients and moments.  Parameters carry
the port's ``state_dict`` names.  Imports nothing of the port.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hvdbench import plain


def dims(cfg: dict) -> dict:
    """The sizes as run; ``E`` is the router's width (the published count)
    and ``held`` the experts this chip holds."""
    H, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    dep = cfg["deployment"]
    lo, hi = dep["experts_held"]
    if hi - lo != cfg["num_experts"]:
        raise ValueError(f"num_experts {cfg['num_experts']} is not the "
                         f"{hi - lo} experts held ({lo} .. {hi})")
    return {"V": cfg["vocab_size"], "H": H, "heads": heads,
            "kv": cfg["num_key_value_heads"], "hd": H // heads,
            "I": cfg["intermediate_size"], "Im": cfg["moe_intermediate_size"],
            "E": dep["num_experts_published"], "held": range(lo, hi),
            "k": cfg["num_experts_per_tok"],
            "types": list(cfg["layer_types"]),
            "dense": cfg["num_dense_layers"], "eps": cfg["norm_eps"],
            "theta": cfg["rope_theta"], "taps": cfg["conv_L_cache"],
            "norm_topk": cfg["norm_topk_prob"],
            "scaling": cfg["routed_scaling_factor"],
            "std": cfg["initializer_range"]}


def weight_specs(cfg: dict) -> list:
    """(name, shape, init, std): N(0, initializer_range) for every
    matrix, the embedding and the convolution, unit norm scales."""
    d = dims(cfg)
    H, hd, kv, std = d["H"], d["hd"], d["kv"], d["std"]
    specs = [("embed_tokens.weight", (d["V"], H), "normal", std)]
    for i, kind in enumerate(d["types"]):
        p = f"layers.{i}."
        specs.append((p + "operator_norm.weight", (H,), "ones", 0))
        if kind == "conv":
            specs += [(p + "conv.in_proj.weight", (3 * H, H), "normal", std),
                      (p + "conv.conv.weight", (H, 1, d["taps"]), "normal",
                       std),
                      (p + "conv.out_proj.weight", (H, H), "normal", std)]
        else:
            a = p + "self_attn."
            specs += [(a + "q_proj.weight", (d["heads"] * hd, H), "normal",
                       std),
                      (a + "k_proj.weight", (kv * hd, H), "normal", std),
                      (a + "v_proj.weight", (kv * hd, H), "normal", std),
                      (a + "out_proj.weight", (H, d["heads"] * hd), "normal",
                       std),
                      (a + "q_layernorm.weight", (hd,), "ones", 0),
                      (a + "k_layernorm.weight", (hd,), "ones", 0)]
        specs.append((p + "ffn_norm.weight", (H,), "ones", 0))
        f = p + "feed_forward."
        if i < d["dense"]:
            specs += [(f + "w1.weight", (d["I"], H), "normal", std),
                      (f + "w3.weight", (d["I"], H), "normal", std),
                      (f + "w2.weight", (H, d["I"]), "normal", std)]
        else:
            n = len(d["held"])
            specs += [(f + "gate.weight", (d["E"], H), "normal", std),
                      (f + "w1", (n, d["Im"], H), "normal", std),
                      (f + "w3", (n, d["Im"], H), "normal", std),
                      (f + "w2", (n, H, d["Im"]), "normal", std)]
    specs.append(("embedding_norm.weight", (H,), "ones", 0))
    return specs


def make_weights(cfg: dict, seed: int, device) -> dict:
    """fp32 weights from ``seed``: each normal leaf from its own stream
    (``plain.generator(device, seed, "weights", name)``), so no draw is
    larger than one leaf."""
    out = {}
    for name, shape, init, std in weight_specs(cfg):
        if init == "normal":
            out[name] = torch.randn(
                shape, generator=plain.generator(device, seed, "weights",
                                                 name),
                device=device, dtype=torch.float32).mul_(std)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out


def make_rows(cfg: dict, traffic: dict, rows: int, gen, device):
    """``rows`` sequences of ``seq_len`` token ids, uniform over the
    vocabulary."""
    return torch.randint(0, cfg["vocab_size"], (rows, traffic["seq_len"]),
                         generator=gen, device=device)


def rows_of(batch):
    return batch.shape[0]


def take_rows(batch, rows: int):
    return batch[:rows]


def _rotary(S, hd, theta, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(S, device=device, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def _rms(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _layer(w, i, kind, x, d, cos, sin, prec, remat):
    """Layer ``i`` on the residual stream ``x`` [B, S, H].  ``prec.value``
    where the port rounds to its 16-bit type: the residual stream, each
    norm's output, each projection's and the convolution's output, the
    gates' products, q and k after their norms and rotation, attention's
    probabilities and output, the experts' SwiGLU parts and the layer's
    routed sum; ``prec.operand``/``prec.product`` on the operands and
    output of every 16-bit matmul and of the convolution.  Norm
    statistics, softmax and the router stay fp32."""
    rnd = prec.value
    B, S, H = x.shape
    p = f"layers.{i}."

    def mm(a, b):
        return prec.product(prec.operand(a) @ prec.operand(b))

    def dense(h, name):
        return rnd(mm(h, w[name].t()))

    h = rnd(_rms(x, w[p + "operator_norm.weight"], d["eps"]))
    if kind == "conv":
        b, c, xx = dense(h, p + "conv.in_proj.weight").chunk(3, dim=-1)
        conv = prec.product(F.conv1d(
            prec.operand(rnd(b * xx).transpose(1, 2)),
            prec.operand(w[p + "conv.conv.weight"]),
            padding=d["taps"] - 1, groups=H))[..., :S]
        h = dense(rnd(c * rnd(conv).transpose(1, 2)),
                  p + "conv.out_proj.weight")
    else:
        a = p + "self_attn."
        hd, kv = d["hd"], d["kv"]
        q = dense(h, a + "q_proj.weight").view(B, S, -1, hd)
        k = dense(h, a + "k_proj.weight").view(B, S, kv, hd)
        v = dense(h, a + "v_proj.weight").view(B, S, kv, hd)
        q = rnd(_rope(_rms(q, w[a + "q_layernorm.weight"], d["eps"]),
                      cos, sin))
        k = rnd(_rope(_rms(k, w[a + "k_layernorm.weight"], d["eps"]),
                      cos, sin))
        rep = q.shape[2] // kv
        q = q.transpose(1, 2)
        k, v = (t.repeat_interleave(rep, dim=2).transpose(1, 2)
                for t in (k, v))
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()

        def core(q, k, v):
            scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
            probs = torch.softmax(
                scores.masked_fill(~causal, float("-inf")), -1)
            return rnd(mm(rnd(probs), v))

        # One key/value head's query heads at a time, each recomputed on
        # its own in the backward: one group's S x S scores live at once.
        ctx = torch.cat([
            checkpoint(core, *(t[:, g:g + rep] for t in (q, k, v)),
                       use_reentrant=False) if remat
            else core(*(t[:, g:g + rep] for t in (q, k, v)))
            for g in range(0, q.shape[1], rep)], dim=1)
        h = dense(ctx.transpose(1, 2).reshape(B, S, -1),
                  a + "out_proj.weight")
    x = rnd(x + h)
    h = rnd(_rms(x, w[p + "ffn_norm.weight"], d["eps"]))
    f = p + "feed_forward."
    if i < d["dense"]:
        act = rnd(rnd(F.silu(dense(h, f + "w1.weight")))
                  * dense(h, f + "w3.weight"))
        return rnd(x + dense(act, f + "w2.weight"))
    return rnd(x + _experts(w, f, h.reshape(B * S, H), d,
                            prec).view(B, S, H))


def _experts(w, f, h, d, prec):
    rnd = prec.value

    def mm(a, b):
        return prec.product(prec.operand(a) @ prec.operand(b))

    scores = torch.sigmoid(h @ w[f + "gate.weight"].t())
    bias = w.get(f + "expert_bias")
    pick = scores if bias is None else scores + bias
    chosen = torch.topk(pick, d["k"], dim=-1).indices
    weights = scores.gather(1, chosen)
    if d["norm_topk"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    weights = weights * d["scaling"]
    out = torch.zeros_like(h)
    for j, e in enumerate(d["held"]):
        hit = chosen == e
        tok = hit.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue  # adds nothing (and an fp8 scale needs a value)
        x = h[tok]
        act = rnd(rnd(F.silu(rnd(mm(x, w[f + "w1"][j].t()))))
                  * rnd(mm(x, w[f + "w3"][j].t())))
        weight = (weights * hit).sum(-1)[tok]
        out.index_add_(0, tok, rnd(mm(act, w[f + "w2"][j].t()))
                       * weight[:, None])
    return rnd(out)


def loss_of(w: dict, ids: torch.Tensor, cfg: dict, prec=plain.FP32,
            remat: bool = False):
    """Mean next-token cross-entropy of ``ids`` [B, S] under weights
    ``w``; ``remat`` recomputes each layer, and each group of attention
    heads, in the backward."""
    d = dims(cfg)
    S = ids.shape[1]
    rnd = prec.value
    cos, sin = _rotary(S, d["hd"], d["theta"], ids.device)
    wte = rnd(w["embed_tokens.weight"])
    x = wte[ids]
    for i, kind in enumerate(d["types"]):
        def layer(x, i=i, kind=kind):
            return _layer(w, i, kind, x, d, cos, sin, prec, remat)
        x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    x = rnd(_rms(x, w["embedding_norm.weight"], d["eps"]))
    logits = prec.product(prec.operand(x) @ prec.operand(wte).t())
    logits = rnd(logits)
    return F.cross_entropy(logits[:, :-1].reshape(-1, d["V"]),
                           ids[:, 1:].reshape(-1))


def grads_of(params: dict, ids, cfg: dict, block_rows: int,
             prec=plain.FP32):
    """(loss, gradients) of one rank's batch, ``block_rows`` rows at a
    time (rows are independent, and each block's loss is a mean over the
    same number of tokens); the first block's gradients hold the sum."""
    grads, total = None, 0.0
    B = ids.shape[0]
    for lo in range(0, B, block_rows):
        block = ids[lo:lo + block_rows]
        w = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = loss_of(w, block, cfg, prec, remat=True) * (block.shape[0] / B)
        loss.backward()
        total += float(loss.detach())
        if grads is None:
            grads = {n: w[n].grad for n in params}
        else:
            for n in grads:
                grads[n].add_(w[n].grad)
        del w, loss
    return total, grads


def optimizer(params: dict, cfg: dict, ranks: int):
    t = cfg["training"]
    return plain.AdamW(params, t["lr"], t["betas"], t["eps"],
                       t["weight_decay"], decay=lambda n, p: p.dim() >= 2)


def train(cfg: dict, weights: dict, batches, block_rows: int = 1,
          prec=plain.FP32) -> dict:
    """:func:`plain.train` of this model from ``weights`` (changed in
    place) on ``batches[step][rank]``."""
    with plain.full_fp32():
        return plain.train(
            weights, batches,
            lambda p, b: grads_of(p, b, cfg, block_rows, prec),
            optimizer(weights, cfg, len(batches[0])),
            clip=cfg["training"]["grad_clip"])
