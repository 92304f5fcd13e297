"""The port's LFM2-8B-A1B training step for the ``lfm2_8b_a1b`` cells,
built as a user's script builds it: ``horovod_tpu_torch``'s
``LFM2MoEForCausalLM`` in bf16 with the flash kernels, holding the
experts this chip holds of each expert layer, AdamW with nanoGPT's groups
inside ``hvd.DistributedOptimizer``, the benchmark's weights copied in
and the expert bias zero."""

import torch

from horovod_tpu_torch.models import gpt, lfm2


class Program:
    clip = None

    def __init__(self, cfg: dict, weights: dict, device, hvd, dtype=None):
        port, dep = cfg["port"], cfg["deployment"]
        lo, hi = dep["experts_held"]
        mcfg = lfm2.LFM2MoEConfig.from_dict(
            cfg, num_experts=dep["num_experts_published"],
            experts_held=range(lo, hi),
            initializer_range=cfg["initializer_range"],
            dtype=dtype or getattr(torch, port["compute_dtype"]),
            attention_impl=port["attention_impl"])
        # Built on the meta device, so the port draws no weights of its
        # own; the benchmark's are copied in.
        with torch.device("meta"):
            model = lfm2.LFM2MoEForCausalLM(mcfg, device="meta")
        model.to_empty(device=device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name])
            for b in model.buffers():
                b.zero_()
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
