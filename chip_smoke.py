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
import re
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
# What flash_attn_fwd.cu instantiates of the wgmma body, as kernel_label
# names it.
WGMMA_INSTANTIATIONS = sorted(f"wgmma<{t}, {d}>" for t in ("bf16", "fp16")
                              for d in (64, 128))


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


def kernel_label(mangled: str) -> str:
    """``wgmma<bf16, 64>`` from a mangled kernel name of flash_attn_fwd.cu."""
    body = re.search(r"flash_fwd_(fp32|mma|wgmma)_kernel", mangled)
    dim = re.search(r"Li(\d+)E", mangled)
    dtype = ("bf16" if "nv_bfloat16" in mangled else
             "fp16" if "__half" in mangled else "fp32")
    if not body:
        return mangled
    return f"{body.group(1)}<{dtype}, {dim.group(1) if dim else '?'}>"


def phase_build():
    """Builds the kernels from this checkout and reads what was built:
    per instantiation the HGMMA (wgmma), UTMALDG (TMA load) and SYNCS
    (mbarrier) instructions in its SASS, its registers and spill bytes
    from the ptxas log.  Any of the four wgmma instantiations missing,
    one without HGMMA or UTMALDG, one that spills, or a log that says
    setmaxnreg was ignored (C7508) fails the build."""
    t0 = time.perf_counter()
    kernels.load("flash_attn_fwd.cu")
    nvcc_s = kernels.build_seconds["flash_attn_fwd.cu"]
    report, warnings = kernels.build_report("flash_attn_fwd.cu")
    per_kernel = {kernel_label(name): info
                  for name, info in sorted(report.items())}
    faults = [w for w in warnings if "C7508" in w]
    found = sorted(label for label in per_kernel if label.startswith("wgmma"))
    if found != WGMMA_INSTANTIATIONS:
        faults.append(f"wgmma instantiations {found}, expected "
                      f"{WGMMA_INSTANTIATIONS}")
    for label in found:
        info = per_kernel[label]
        if not info.get("HGMMA") or not info.get("UTMALDG"):
            faults.append(f"{label}: no HGMMA or no UTMALDG in its SASS")
        if "spill_bytes" not in info:
            faults.append(f"{label}: no spill line in the ptxas log")
        elif info["spill_bytes"]:
            faults.append(f"{label}: spills {info['spill_bytes']} bytes")
    emit("build", source="horovod_tpu_torch/kernels/flash_attn_fwd.cu",
         nvcc_s=nvcc_s, total_s=time.perf_counter() - t0,
         kernels=per_kernel, ptxas_warnings=warnings)
    if faults:
        raise RuntimeError("build check failed: " + "; ".join(faults))


def host_us_per_call(fn, calls: int = 100) -> float:
    """Host time per call: the wall time of ``calls`` calls enqueued behind
    a sleep kernel that keeps the card busy, so that no call waits for
    the device and none of the device's time is in the reading."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s of device time
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def phase_kernels() -> dict:
    """The CUDA flash forward against its plain version (fp32 matmuls,
    no TF32): each body at the GPT-2-small training shape and at ragged
    ones.  Then the wgmma body, the mma.sync body and sdpa timed at the
    GPT shape in one call, in turns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    heads, hd = 12, 64
    bh_gpt = BATCH * heads
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    # (name, bh, sq, skv, d, dtype, causal, tolerance, body or None for
    # the wrapper's choice); 16-bit at 3e-2 because P is rounded to the
    # input type before P.V, fp32 at 1e-4.
    cases = [("gpt2_small", bh_gpt, SEQ, SEQ, hd, bf16, True, 3e-2, None),
             ("gpt2_small_mma", bh_gpt, SEQ, SEQ, hd, bf16, True, 3e-2,
              fa.BODY_MMA),
             ("wgmma_noncausal_1000", 4, 1000, 1000, 64, bf16, False, 3e-2,
              None),
             ("wgmma_fp16_d128_1000x777", 2, 1000, 777, 128, fp16, True,
              3e-2, None),
             ("wgmma_one_row_tail_129", 1, 129, 129, 64, bf16, True, 3e-2,
              None),
             ("wgmma_d128_64x300", 3, 64, 300, 128, bf16, False, 3e-2,
              None),
             ("mma_fp16_d32", 2, 130, 77, 32, fp16, False, 3e-2, None),
             ("fp32_ragged", 4, 1000, 1000, 64, fp32, False, 1e-4, None),
             ("fp32_causal_short", 3, 40, 72, 16, fp32, True, 1e-4, None)]
    errors, bodies = {}, {}
    for i, (name, bh, sq, skv, d, dtype, causal, tol, body) in \
            enumerate(cases):
        q, k, v = qkv(bh, sq, skv, d, dtype, seed=i)
        want = fa._body_for(dtype, d) if body is None else body
        before = dict(fa.launches_by_body)
        got = fa.flash_attention_cuda(q, k, v, d ** -0.5, causal, body=body)
        torch.cuda.synchronize()
        assert fa.launches_by_body[want] == before[want] + 1, name
        bodies[name] = fa.BODY_NAMES[want]
        ref = fa.flash_attention_reference(q, k, v, d ** -0.5, causal)
        errors[name] = (got.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")

    bh, d = bh_gpt, hd
    q, k, v = qkv(bh, SEQ, SEQ, d, bf16, seed=0)
    scale = d ** -0.5
    q4, k4, v4 = (t.view(BATCH, heads, SEQ, d) for t in (q, k, v))
    timed = {
        "wgmma": lambda: fa.flash_attention_cuda(q, k, v, scale, True),
        "mma": lambda: fa.flash_attention_cuda(q, k, v, scale, True,
                                               body=fa.BODY_MMA),
        "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       is_causal=True)}
    order = ["wgmma", "mma", "sdpa", "sdpa", "mma", "wgmma"]
    runs = {name: [] for name in timed}
    for name in order:
        runs[name].append(median_ms(timed[name], launches=20))
    ms, earlier_ms, library_ms = (statistics.mean(runs[n])
                                  for n in ("wgmma", "mma", "sdpa"))
    plain_ms = median_ms(
        lambda: fa.flash_attention_reference(q, k, v, scale, True),
        launches=2, rounds=3)
    host_us = {name: host_us_per_call(timed[name])
               for name in ("wgmma", "sdpa")}
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
           "ms": ms, "earlier_ms": earlier_ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    emit("kernels", max_abs_err=errors, body=bodies,
         shape=[BATCH, SEQ, heads, d], dtype="bfloat16", causal=True,
         order=order, runs_ms=runs, wgmma_ms=ms, mma_ms=earlier_ms,
         sdpa_ms=library_ms, plain_ms=plain_ms,
         host_us_per_call=host_us, bytes=nbytes, flops=flops,
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
    the flash kernel through hvd.torch.  Returns the wgmma body's
    launches."""
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
    fa.launches_by_body.update({body: 0 for body in fa.launches_by_body})
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
    launches = fa.launches_by_body[fa.BODY_WGMMA]
    by_body = dict(fa.launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    hvd.shutdown()

    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    assert all(r.is_cuda and torch.equal(r, gr)
               for r, gr in zip(reduced, grads))
    assert launches >= cfg.num_layers * STEPS, by_body
    median_step = statistics.median(step_ms[1:])
    emit("train", config="gpt2_small bf16 flash", batch=BATCH, seq=SEQ,
         steps=STEPS, losses=losses, step_ms=step_ms,
         median_step_ms=median_step,
         tokens_per_s=BATCH * SEQ / (median_step / 1e3),
         max_memory_allocated=peak, flash_launches=fa.launches,
         flash_launches_by_body={fa.BODY_NAMES[b]: n
                                 for b, n in by_body.items()})
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
