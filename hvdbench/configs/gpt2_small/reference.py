"""GPT-2 small in plain PyTorch, float32, TF32 off: the reference that
decides ``correct`` for the ``gpt2_small`` cells.

The published GPT-2 layout (Radford et al. 2019; Hugging Face ``gpt2``):
learned token and position embeddings, pre-LN blocks of causal
self-attention and a tanh-GELU MLP (``gelu_new``), a final layer norm and
the LM head tied to the token table.  The loss is next-token
cross-entropy over positions 0..S-2, as nanoGPT trains it.  Parameters
carry the port's ``state_dict`` names so both sides can be handed one
set of tensors.  Imports nothing of the port.
"""

import math

import torch
import torch.nn.functional as F

from hvdbench import plain


def dims(cfg: dict) -> dict:
    h = cfg["n_embd"]
    return {"V": cfg["vocab_size"], "P": cfg["n_positions"], "H": h,
            "L": cfg["n_layer"], "heads": cfg["n_head"],
            "I": cfg["n_inner"] or 4 * h, "eps": cfg["layer_norm_epsilon"]}


def weight_specs(cfg: dict) -> list:
    """(name, shape, init, std): GPT-2's initialisation (N(0, 0.02), the
    residual projections N(0, 0.02 / sqrt(2 L)), zero biases, unit
    layer-norm scales)."""
    d = dims(cfg)
    std = cfg["initializer_range"]
    proj = std / math.sqrt(2 * d["L"])
    H, I = d["H"], d["I"]
    specs = [("word_embeddings.weight", (d["V"], H), "normal", std),
             ("position_embeddings.weight", (d["P"], H), "normal", std)]
    for i in range(d["L"]):
        p = f"layers.{i}."
        specs += [(p + "attention_norm.weight", (H,), "ones", 0),
                  (p + "attention_norm.bias", (H,), "zeros", 0)]
        for lin in ("query", "key", "value", "out"):
            specs += [(p + f"attention.{lin}.weight", (H, H), "normal",
                       proj if lin == "out" else std),
                      (p + f"attention.{lin}.bias", (H,), "zeros", 0)]
        specs += [(p + "mlp_norm.weight", (H,), "ones", 0),
                  (p + "mlp_norm.bias", (H,), "zeros", 0),
                  (p + "intermediate.weight", (I, H), "normal", std),
                  (p + "intermediate.bias", (I,), "zeros", 0),
                  (p + "output.weight", (H, I), "normal", proj),
                  (p + "output.bias", (H,), "zeros", 0)]
    specs += [("final_norm.weight", (H,), "ones", 0),
              ("final_norm.bias", (H,), "zeros", 0)]
    return specs


def make_weights(cfg: dict, seed: int, device) -> dict:
    return plain.draw_weights(weight_specs(cfg), seed, device)


def make_rows(cfg: dict, traffic: dict, rows: int, gen, device):
    """``rows`` sequences of ``seq_len`` token ids, uniform over the
    vocabulary."""
    return torch.randint(0, cfg["vocab_size"], (rows, traffic["seq_len"]),
                         generator=gen, device=device)


def rows_of(batch):
    return batch.shape[0]


def take_rows(batch, rows: int):
    return batch[:rows]


def loss_of(w: dict, ids: torch.Tensor, cfg: dict, prec=plain.FP32):
    """Mean next-token cross-entropy of ``ids`` [B, S] under weights
    ``w``.  ``prec.value`` is applied wherever the configuration computes
    in its 16-bit type (``port.compute_dtype``): embeddings, the residual
    stream, layer-norm outputs, every dense layer's output, attention's
    probabilities and output, the logits; ``prec.operand`` and
    ``prec.product`` on the operands and output of every matmul (the
    dense layers, QK^T, attention's PV, the tied head); layer-norm
    statistics, softmax and the loss stay fp32."""
    d = dims(cfg)
    B, S = ids.shape
    H, heads = d["H"], d["heads"]
    hd = H // heads
    rnd = prec.value

    def mm(a, b):
        return prec.product(prec.operand(a) @ prec.operand(b))

    def ln(x, name):
        return rnd(F.layer_norm(x, (H,), w[name + ".weight"],
                                w[name + ".bias"], d["eps"]))

    def dense(x, name):
        return rnd(mm(x, w[name + ".weight"].t()) + rnd(w[name + ".bias"]))

    wte = rnd(w["word_embeddings.weight"])
    causal = torch.ones(S, S, dtype=torch.bool, device=ids.device).tril()
    x = rnd(wte[ids] + rnd(w["position_embeddings.weight"][:S]))
    for i in range(d["L"]):
        p = f"layers.{i}."
        h = ln(x, p + "attention_norm")
        q, k, v = (dense(h, p + "attention." + n).view(B, S, heads, hd)
                   .transpose(1, 2) for n in ("query", "key", "value"))
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        ctx = rnd(mm(rnd(torch.softmax(scores, dim=-1)), v))
        x = rnd(x + dense(ctx.transpose(1, 2).reshape(B, S, H),
                          p + "attention.out"))
        h = ln(x, p + "mlp_norm")
        m = rnd(F.gelu(dense(h, p + "intermediate"), approximate="tanh"))
        x = rnd(x + dense(m, p + "output"))
    x = ln(x, "final_norm")
    logits = rnd(mm(x, wte.t()))
    return F.cross_entropy(logits[:, :-1].reshape(-1, d["V"]),
                           ids[:, 1:].reshape(-1))


def grads_of(params: dict, ids, cfg: dict, block_rows: int,
             prec=plain.FP32):
    """(loss, gradients) of one rank's batch, ``block_rows`` rows at a
    time (rows are independent, and each block's loss is a mean over
    the same number of tokens)."""
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    total = 0.0
    B = ids.shape[0]
    for lo in range(0, B, block_rows):
        block = ids[lo:lo + block_rows]
        w = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = loss_of(w, block, cfg, prec) * (block.shape[0] / B)
        loss.backward()
        total += float(loss.detach())
        for n in grads:
            grads[n].add_(w[n].grad)
    return total, grads


def optimizer(params: dict, cfg: dict, ranks: int):
    t = cfg["training"]
    return plain.AdamW(params, t["lr"], t["betas"], t["eps"],
                       t["weight_decay"], decay=lambda n, p: p.dim() >= 2)


def train(cfg: dict, weights: dict, batches, block_rows: int = 4,
          prec=plain.FP32) -> dict:
    """:func:`plain.train` of this model from ``weights`` (changed in
    place) on ``batches[step][rank]``."""
    with plain.full_fp32():
        return plain.train(
            weights, batches,
            lambda p, b: grads_of(p, b, cfg, block_rows, prec),
            optimizer(weights, cfg, len(batches[0])),
            clip=cfg["training"]["grad_clip"])
