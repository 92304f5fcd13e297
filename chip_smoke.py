"""On-card smoke test of horovod_tpu_torch: builds the CUDA kernels from
this checkout, holds each against its plain PyTorch version, checks the
GPT-2-small model at full width, and trains it through ``hvd.torch``.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``.  Each phase prints one JSON line; any failure raises and the
script exits non-zero.  The last lines are the card's name and power
limit as nvidia-smi reports them, the per-kernel summary, and
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is available")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch.nn.functional as F  # noqa: E402

import horovod_tpu_torch.torch as hvd  # noqa: E402
from horovod_tpu_torch import kernels  # noqa: E402
from horovod_tpu_torch.models import gpt  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
STEPS = 6
BATCH, SEQ = 8, 1024


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


CARD = card()


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def median_ms(fn, launches: int = 10, rounds: int = 5) -> float:
    """Per-launch device time: CUDA events around ``launches``
    back-to-back calls (so the host's launch cost hides behind the
    queue), divided by the count; the median over ``rounds``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def qkv(bh, sq, skv, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(bh, sq, d, device="cuda", generator=g).to(dtype),
            torch.randn(bh, skv, d, device="cuda", generator=g).to(dtype),
            torch.randn(bh, skv, d, device="cuda", generator=g).to(dtype))


def phase_build():
    t0 = time.perf_counter()
    kernels.load("flash_attn_fwd.cu")
    emit("build", source="horovod_tpu_torch/kernels/flash_attn_fwd.cu",
         nvcc_s=kernels.build_seconds["flash_attn_fwd.cu"],
         total_s=time.perf_counter() - t0)


def phase_kernels() -> dict:
    """The CUDA flash forward against its plain version (fp32 matmuls,
    no TF32), at the GPT-2-small training shape and two ragged ones."""
    torch.backends.cuda.matmul.allow_tf32 = False
    heads, hd = 12, 64
    cases = [("gpt2_small", BATCH * heads, SEQ, SEQ, hd, torch.bfloat16,
              True, 3e-2),
             ("fp32_ragged", 4, 1000, 1000, 64, torch.float32, False, 1e-4),
             ("fp32_causal_short", 3, 40, 72, 16, torch.float32, True,
              1e-4)]
    errors = {}
    for i, (name, bh, sq, skv, d, dtype, causal, tol) in enumerate(cases):
        q, k, v = qkv(bh, sq, skv, d, dtype, seed=i)
        got = fa.flash_attention_cuda(q, k, v, d ** -0.5, causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, d ** -0.5, causal)
        errors[name] = (got.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")

    bh, d = BATCH * heads, hd
    q, k, v = qkv(bh, SEQ, SEQ, d, torch.bfloat16, seed=0)
    scale = d ** -0.5
    q4, k4, v4 = (t.view(BATCH, heads, SEQ, d) for t in (q, k, v))
    ms = median_ms(lambda: fa.flash_attention_cuda(q, k, v, scale, True))
    plain_ms = median_ms(
        lambda: fa.flash_attention_reference(q, k, v, scale, True),
        launches=2, rounds=3)
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    # Least work: read q, k, v once, write o once; two products over
    # the S(S+1)/2 unmasked (q, k) pairs of every head.
    nbytes = 4 * bh * SEQ * d * q.element_size()
    flops = 4 * d * bh * SEQ * (SEQ + 1) // 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    row = {"name": "flash_attn_fwd", "route": "cuda",
           "source": "horovod_tpu_torch/kernels/flash_attn_fwd.cu",
           "replaces": "horovod_tpu/ops/pallas_attention.py:40",
           "launches": None, "max_abs_err": errors["gpt2_small"],
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    emit("kernels", max_abs_err=errors, shape=[BATCH, SEQ, heads, d],
         dtype="bfloat16", causal=True, ms=ms, plain_ms=plain_ms,
         sdpa_ms=library_ms, bytes=nbytes, flops=flops,
         bound_ms=row["bound_ms"], bound_by=row["bound_by"])
    return row


def phase_model_parity():
    """GPT-2 small at full width in fp32: flash logits against einsum."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt.gpt2_small_config(dtype=torch.float32, dropout=0.0)
    einsum = gpt.GPTLMHeadModel(cfg, seed=0).eval()
    flash = gpt.GPTLMHeadModel(
        dataclasses.replace(cfg, attention_impl="flash"), seed=0).eval()
    flash.load_state_dict(einsum.state_dict())
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, SEQ), device="cuda",
                        generator=g)
    with torch.no_grad():
        ref = einsum(ids)
        got = flash(ids)
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-3)
    emit("model_parity", config="gpt2_small fp32", batch=2, seq=SEQ,
         logits_shape=list(got.shape), max_abs_err=err)
    del einsum, flash, got, ref
    torch.cuda.empty_cache()


def phase_train() -> int:
    """The main path: a Horovod training script trains GPT-2 small with
    the flash kernel through hvd.torch.  Returns the kernel's launches."""
    hvd.init()
    assert hvd.size() == 1
    cfg = gpt.gpt2_small_config(attention_impl="flash", dropout=0.0)
    model = gpt.GPTLMHeadModel(cfg, seed=0).train()
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device="cuda",
                        generator=g)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = gpt.lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    grads = [p.grad for p in model.parameters()]
    reduced = hvd.grouped_allreduce(grads, op=hvd.Average)
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    hvd.shutdown()

    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    assert all(r.is_cuda and torch.equal(r, gr)
               for r, gr in zip(reduced, grads))
    assert launches >= cfg.num_layers * STEPS, launches
    median_step = statistics.median(step_ms[1:])
    emit("train", config="gpt2_small bf16 flash", batch=BATCH, seq=SEQ,
         steps=STEPS, losses=losses, step_ms=step_ms,
         median_step_ms=median_step,
         tokens_per_s=BATCH * SEQ / (median_step / 1e3),
         max_memory_allocated=peak, flash_launches=launches)
    return launches


def main():
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    phase_build()
    row = phase_kernels()
    phase_model_parity()
    row["launches"] = phase_train()
    print(CARD, flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
