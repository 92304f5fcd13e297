"""Adasum BERT pretraining on horovod_tpu_torch (reference:
examples/adasum/ and docs/adasum_user_guide.rst — Adasum combines the
ranks' updates with the scale-invariant pairwise rule instead of
averaging them, allowing larger effective learning rates at scale).
Counterpart of the JAX package's examples/adasum/adasum_bert_pretrain.py.

As upstream Horovod's torch binding does (reference
torch/optimizer.py:279), ``DistributedOptimizer(op=hvd.Adasum)`` takes
each rank's local AdamW step and then Adasum-merges the parameter
*deltas*; the JAX example wraps optax and merges the gradients before
AdamW.  AdamW's weight decay is optax's default, 1e-4 (torch's default
is 1e-2).  Adasum needs a power-of-two number of ranks.

Each rank trains on its card, the one ``hvd.init()`` picks; ``--device
cpu`` asks for the CPU.  ``--attention flash`` runs the port's flash
kernel (``BertConfig.attention_impl``).  ``--report DIR`` writes each
rank's step times, losses, peak memory and collective and kernel counts
to ``DIR/rank<r>.json`` and rank 0's final parameters to
``DIR/params.pt``.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
          python adasum_bert_pretrain.py --steps 3 --tiny
"""

import argparse
import json
import os
import time

import torch

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.bert import (BertForMaskedLM, bert_large_config,
                                           bert_tiny_config, mlm_loss)
from horovod_tpu_torch.ops import flash_attention, fusion_buffer
from horovod_tpu_torch.training import make_bert_batch


def counters() -> dict:
    """Flash (forward and backward) and fusion kernel launches, and
    collectives by op and backend (``hvd_collective_seconds``'s counts),
    so far."""
    hist = basics.metrics_snapshot()["histograms"].get(
        "hvd_collective_seconds", {})
    return {"flash": flash_attention.launches,
            "flash_bwd": flash_attention.bwd_launches,
            "fusion": dict(fusion_buffer.launches),
            "fusion_plain": dict(fusion_buffer.plain_calls),
            "collectives": {k: h.get("count", 0) for k, h in hist.items()}}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--attention", choices=("einsum", "flash"),
                        default="einsum")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: the "
                             "rank's card)")
    parser.add_argument("--report", default=None,
                        help="directory for each rank's measurements and "
                             "rank 0's final parameters")
    args = parser.parse_args()

    hvd.init()
    # hvd.init() made the rank's card the current device.
    device = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    make_config = bert_tiny_config if args.tiny else bert_large_config
    config = make_config(attention_impl=args.attention)
    model = BertForMaskedLM(config, device=device, seed=0)

    batch = make_bert_batch(args.batch_size,
                            min(args.seq_len,
                                config.max_position_embeddings),
                            config.vocab_size, seed=hvd.rank())
    batch = {k: v.to(device) for k, v in batch.items()}
    # Adasum needs no lr scaling by world size (reference
    # docs/adasum_user_guide.rst).
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=args.lr,
                          weight_decay=1e-4),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = counters()
    step_ms, losses = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        logits = model(batch["input_ids"], deterministic=True)
        loss = mlm_loss(logits, batch["labels"], batch["mask"])
        loss.backward()
        opt.step()
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if hvd.rank() == 0:
            print(f"step {step} loss {losses[-1]:.4f}", flush=True)

    if args.report:
        os.makedirs(args.report, exist_ok=True)
        report = {"rank": hvd.rank(), "size": hvd.size(),
                  "backend": basics._state().backend.name,
                  "step_ms": step_ms, "losses": losses,
                  "max_memory_allocated":
                  torch.cuda.max_memory_allocated()
                  if device.type == "cuda" else None,
                  "parameters": sum(p.numel() for p in model.parameters()),
                  "before": before, "after": counters()}
        with open(os.path.join(args.report,
                               f"rank{hvd.rank()}.json"), "w") as f:
            json.dump(report, f)
        if hvd.rank() == 0:
            torch.save({k: v.detach().cpu() for k, v in
                        model.state_dict().items()},
                       os.path.join(args.report, "params.pt"))


if __name__ == "__main__":
    main()
