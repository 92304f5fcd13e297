"""The port's GPT-2 training step for the ``gpt2_small`` cells, built as
a user's script builds it: ``horovod_tpu_torch``'s ``GPTLMHeadModel`` in
bf16 with the flash kernel, AdamW with nanoGPT's groups inside
``hvd.DistributedOptimizer``, the benchmark's weights copied in."""

import torch

from horovod_tpu_torch.models import gpt


class Program:
    clip = None

    def __init__(self, cfg: dict, weights: dict, device, hvd, dtype=None):
        port = cfg["port"]
        gcfg = gpt.GPTConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["n_embd"],
            num_layers=cfg["n_layer"], num_heads=cfg["n_head"],
            intermediate_size=cfg["n_inner"] or 4 * cfg["n_embd"],
            max_position_embeddings=cfg["n_positions"],
            dropout=cfg["training"]["dropout"],
            layer_norm_eps=cfg["layer_norm_epsilon"],
            dtype=dtype or getattr(torch, port["compute_dtype"]),
            attention_impl=port["attention_impl"])
        # Built on the meta device, so the port draws no weights of its
        # own; the benchmark's are copied in.
        with torch.device("meta"):
            model = gpt.GPTLMHeadModel(gcfg, device="meta")
        model.to_empty(device=device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name])
        self.model = model.train()
        t = cfg["training"]
        decay = [p for p in model.parameters() if p.dim() >= 2]
        no_decay = [p for p in model.parameters() if p.dim() < 2]
        inner = torch.optim.AdamW(
            [{"params": decay, "weight_decay": t["weight_decay"]},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"])
        self.opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters())
        self.params = dict(model.named_parameters())
        self.clip = t["grad_clip"]

    def loss(self, ids):
        return gpt.lm_loss(self.model(ids), ids)


def build(cfg: dict, traffic: dict, weights: dict, device, hvd, **kw):
    return Program(cfg, weights, device, hvd, **kw)
