"""On-card smoke test of horovod_tpu_torch: builds the CUDA kernels from
this checkout, holds each against its plain PyTorch version, checks the
GPT-2-small model at full width, trains it through ``hvd.torch`` in a
world of one, runs the NCCL backend in a world of one (made and destroyed
three times, as an elastic reset does), trains it at two ranks sharing
the card, and trains it elastically at 2, 3 and 2 ranks.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``.  Each phase prints one JSON line; any failure raises and the
script exits non-zero.  The last lines are the card's name and power
limit as nvidia-smi reports them, the per-kernel summary, and
``{"ok": true, "device": {...}}``.

The two-rank phase starts two fresh worker processes of this script
(``--train-worker``) through the port's launcher,
``python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2``.
Both use the one card, so CUDA tensors cross ranks over gloo, staged
through host memory (NCCL refuses two ranks on one device).  Each worker
also reads its own ``/metrics`` endpoint, signed with the job secret and
unsigned, before it shuts down.

The elastic phase starts ``chip_smoke.py --elastic-worker`` through the
elastic launcher, ``python -m horovod_tpu_torch.runner.launch -np 2
--min-np 2 --max-np 3 --host-discovery-script <script>``, whose script
prints a hosts file the phase rewrites: ``127.0.0.1:1`` joins after three
steps at size 2, dies inside a backward after three steps at size 3, and
the survivors restore the last commit and train on at size 2.
"""

import ast
import concurrent.futures
import dataclasses
import hashlib
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# Wall clock at the start of this process, before torch is imported: a
# launched worker reports it, so that the phase can split its time to
# the first step into launcher, imports, init and model.
STARTED = time.time()

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import horovod_tpu_torch.torch as hvd  # noqa: E402
from horovod_tpu_torch import kernels  # noqa: E402
from horovod_tpu_torch.common import basics  # noqa: E402
from horovod_tpu_torch.common.fusion import fuse_responses  # noqa: E402
from horovod_tpu_torch.common.message import (  # noqa: E402
    DataType, Response, ResponseType)
from horovod_tpu_torch.models import gpt  # noqa: E402
from horovod_tpu_torch.ops import dist_ops  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402
from horovod_tpu_torch.ops import fusion_buffer as fb  # noqa: E402
from horovod_tpu_torch.runner import job_secret  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
STEPS = 6
STEPS_2RANK = 4
BATCH, SEQ = 8, 1024
SOURCES = ("flash_attn_fwd.cu", "fusion_buffer.cu")
FUSION_THRESHOLD = 64 * 1024 * 1024  # HOROVOD_FUSION_THRESHOLD's default
WORKER_TIMEOUT_S = 600
# What flash_attn_fwd.cu instantiates of the wgmma body, as kernel_label
# names it.
WGMMA_INSTANTIATIONS = sorted(f"wgmma<{t}, {d}>" for t in ("bf16", "fp16")
                              for d in (64, 128))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


CARD = None


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


def device_ms(fn, launches: int = 5, rounds: int = 5) -> float:
    """Per-call device time of a function whose host cost may exceed its
    device time: ``launches`` calls enqueued behind a sleep kernel that
    keeps the card busy while the host enqueues, CUDA events around the
    calls only, divided by the count; the median over ``rounds``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # about 0.1 s of device time
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


def fusion_label(mangled: str) -> str:
    """``scaled_copy<float>`` from a mangled kernel name of
    fusion_buffer.cu (Itanium type codes)."""
    codes = {"h": "uint8", "a": "int8", "t": "uint16", "s": "int16",
             "i": "int32", "x": "int64", "f": "float32", "d": "float64",
             "b": "bool", "6__half": "float16",
             "13__nv_bfloat16": "bfloat16"}
    m = re.search(r"scaled_copy_kernelI(\w+?)EEv", mangled)
    if not m:
        return mangled
    return f"scaled_copy<{codes.get(m.group(1), m.group(1))}>"


def phase_build():
    """Builds the kernels from this checkout, one nvcc per source, all
    started together, and reads what was built: per flash instantiation
    the HGMMA (wgmma), UTMALDG (TMA load) and SYNCS (mbarrier)
    instructions in its SASS, per kernel its registers and spill bytes
    from the ptxas log.  Any of the four wgmma instantiations missing,
    one without HGMMA or UTMALDG, any kernel that spills, a fusion
    dtype missing, or a log that says setmaxnreg was ignored (C7508)
    fails the build."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        for lib in pool.map(kernels.load, SOURCES):
            assert lib is not None
    nvcc_s = {src: kernels.build_seconds[src] for src in SOURCES}
    fusion, fusion_warnings = kernels.build_report("fusion_buffer.cu",
                                                   mnemonics=("LDG", "STG"))
    fusion = {fusion_label(name): info
              for name, info in sorted(fusion.items())}
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
    if len(fusion) != len(fb._DTYPE_CODES):
        faults.append(f"fusion_buffer.cu: {sorted(fusion)}, expected one "
                      f"instantiation per dtype of {len(fb._DTYPE_CODES)}")
    for label, info in fusion.items():
        if info.get("spill_bytes", 1):
            faults.append(f"{label}: spills {info.get('spill_bytes')} bytes")
    emit("build", sources=[f"horovod_tpu_torch/kernels/{src}"
                           for src in SOURCES],
         nvcc_s=nvcc_s, total_s=time.perf_counter() - t0,
         kernels=per_kernel, ptxas_warnings=warnings,
         fusion_kernels=fusion, fusion_ptxas_warnings=fusion_warnings)
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


def phase_train():
    """A Horovod training script trains GPT-2 small with the flash kernel
    through hvd.torch in a world of one."""
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


def gpt2_small_gradient_shapes():
    """(name, shape) of GPT-2 small's trainable tensors, in the order
    their gradients become ready in a backward pass (the reverse of
    registration)."""
    cfg = gpt.gpt2_small_config(dtype=torch.float32, dropout=0.0)
    model = gpt.GPTLMHeadModel(cfg, device="cpu", seed=0)
    shapes = [(name, tuple(p.shape)) for name, p in model.named_parameters()
              if p.requires_grad]
    del model
    return shapes[::-1]


def fused_responses(shapes, dtype):
    """Tensor-name lists of the responses ``fuse_responses`` makes of one
    step's gradients at the default fusion threshold."""
    wire = {torch.float32: DataType.FLOAT32, torch.bfloat16: DataType.BFLOAT16}
    resps = [Response(response_type=ResponseType.ALLREDUCE,
                      tensor_names=[name], tensor_type=wire[dtype])
             for name, _ in shapes]
    sizes = {(0, name): math.prod(shape) for name, shape in shapes}
    return [r.tensor_names for r in
            fuse_responses(resps, sizes, FUSION_THRESHOLD)]


def fusion_case(name, tensors, prescale, postscale, errors):
    """Pack and unpack by the kernel against the plain version on the same
    tensors: bit-equal (torch.equal) or it raises."""
    before = dict(fb.plain_calls)
    got = fb.pack(tensors, prescale)
    want = fb.pack_plain(tensors, prescale)
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    refs = [torch.empty_like(o) for o in outs]
    fb.unpack(got, outs, postscale)
    fb.unpack_plain(got, refs, postscale)
    torch.cuda.synchronize()
    assert fb.plain_calls == before, name
    if not torch.equal(got, want):
        raise AssertionError(f"fusion pack differs from its plain version: "
                             f"{name}")
    for o, r in zip(outs, refs):
        if not torch.equal(o, r):
            raise AssertionError(f"fusion unpack differs from its plain "
                                 f"version: {name}")
    if got.is_floating_point() and got.numel():
        errors[name] = max((got.float() - want.float()).abs().max().item(),
                           max((o.float() - r.float()).abs().max().item()
                               for o, r in zip(outs, refs) if o.numel()))
    else:
        errors[name] = 0.0


def phase_fusion_kernel() -> dict:
    """The fusion pack/unpack kernel against its plain version, bit-exact,
    on one training step's gradients of GPT-2 small cut into responses
    as the runtime cuts them, and on integer, misaligned, empty and 0-d
    cases; then a whole step's packs and unpacks timed beside the plain
    version and the one PyTorch call of the same copy."""
    shapes = gpt2_small_gradient_shapes()
    numel = sum(math.prod(shape) for _, shape in shapes)
    g = torch.Generator(device="cuda").manual_seed(5)
    grads = {name: torch.randn(shape, device="cuda", generator=g)
             for name, shape in shapes}
    responses = fused_responses(shapes, torch.float32)
    errors = {}
    for i, names in enumerate(responses):
        fusion_case(f"gpt2_fp32_response{i}", [grads[n] for n in names],
                    1.0, 0.5, errors)
    for i, names in enumerate(fused_responses(shapes, torch.bfloat16)):
        fusion_case(f"gpt2_bf16_response{i}",
                    [grads[n].to(torch.bfloat16) for n in names],
                    0.5, 1.0 / 3.0, errors)
    cpu = torch.Generator().manual_seed(6)
    for dtype, high in ((torch.int32, 1 << 20), (torch.uint8, 256)):
        ints = [torch.randint(0, high, (n,), generator=cpu).to(dtype).cuda()
                for n in (1, 15, 16, 17, 4099, 1 << 20)]
        for factor in (1.0, 3.0):
            fusion_case(f"{dtype}_x{factor:g}", ints, factor, factor, errors)
    base = torch.randn(1 << 20, device="cuda", generator=g)
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        b = base.to(dtype)
        views = [b[1:1 + 1000], b[3:3 + 77777].view(7, 11111), b[1:]]
        fusion_case(f"{dtype}_views_off_by_one", views, 0.5, 2.0, errors)
    edge = [torch.empty(0, device="cuda"), torch.tensor(3.5, device="cuda"),
            torch.empty(0, 5, device="cuda"), torch.randn(3, device="cuda")]
    fusion_case("empty_and_0d", edge, 0.5, 2.0, errors)
    fusion_case("only_empty", [torch.empty(0, device="cuda")], 0.5, 2.0,
                errors)

    # One step's packs (prescale 1) and unpacks (postscale 1/2, the
    # two-rank Average) through one persistent buffer, as the runtime
    # runs them, against the plain version and the PyTorch copy.
    bufs = fb.FusionBuffers()
    per_resp = [[grads[n] for n in names] for names in responses]
    total = max(fb.layout([t.numel() for t in ts], torch.float32)[1]
                for ts in per_resp)
    flat = bufs.get(torch.device("cuda"), torch.float32, total)
    outs = [[torch.empty_like(t) for t in ts] for ts in per_resp]
    views = []
    for ts, os_ in zip(per_resp, outs):
        offsets, n = fb.layout([t.numel() for t in ts], torch.float32)
        views.append(([t.view(-1) for t in ts], n,
                      [flat[o:o + t.numel()].view(t.shape)
                       for o, t in zip(offsets, ts)], os_))

    def step_pack():
        for ts in per_resp:
            fb.pack(ts, 1.0, out=flat)

    def step_unpack():
        for ts, os_ in zip(per_resp, outs):
            fb.unpack(flat, os_, 0.5)

    def plain_pack():
        for ts in per_resp:
            fb.pack_plain(ts, 1.0, out=flat)

    def plain_unpack():
        for ts, os_ in zip(per_resp, outs):
            fb.unpack_plain(flat, os_, 0.5)

    def library_pack():
        for flat_views, n, _, _ in views:
            torch.cat(flat_views, out=flat[:n])

    def library_unpack():
        for _, _, src, dst in views:
            torch._foreach_copy_(dst, src)

    # Device times behind a sleep kernel: the wrapper's host cost per
    # step (host_us) is larger than the kernel's device time, so events
    # around back-to-back calls would time the host.
    before = dict(fb.launches)
    ms = {"pack": device_ms(step_pack), "unpack": device_ms(step_unpack)}
    plain = {"pack": device_ms(plain_pack, launches=2, rounds=3),
             "unpack": device_ms(plain_unpack, launches=2, rounds=3)}
    library = {"pack": device_ms(library_pack),
               "unpack": device_ms(library_unpack)}
    host_us = {"pack": host_us_per_call(step_pack, calls=20),
               "unpack": host_us_per_call(step_unpack, calls=20),
               "library_pack": host_us_per_call(library_pack, calls=20),
               "library_unpack": host_us_per_call(library_unpack, calls=20)}
    # Least work of each: every gradient byte read once and written once.
    nbytes = 4 * numel
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    emit("fusion_kernel", cases=len(errors), bit_exact=True,
         max_abs_err=max(errors.values()), tensors=len(shapes),
         elements=numel, bytes_per_step=nbytes,
         responses=[len(names) for names in responses],
         response_bytes=[4 * sum(math.prod(dict(shapes)[n]) for n in names)
                         for names in responses],
         ms=ms, plain_ms=plain, library_ms=library,
         host_us_per_step=host_us,
         bound_ms={"pack": bound, "unpack": bound}, bound_by="bytes",
         timing_launches={k: fb.launches[k] - before[k] for k in before})
    del grads, outs, views, flat, bufs
    torch.cuda.empty_cache()
    return {"name": "fusion_buffer", "route": "cuda",
            "source": "horovod_tpu_torch/kernels/fusion_buffer.cu",
            "replaces": "no Pallas kernel: XLA fusion of the fused "
                        "response (horovod_tpu/ops/xla_ops.py:180); "
                        "reference batched_memcpy_k / scale_buffer_k",
            "launches": None, "max_abs_err": max(errors.values()),
            "ms": ms["pack"] + ms["unpack"], "pack_ms": ms["pack"],
            "unpack_ms": ms["unpack"],
            "plain_ms": plain["pack"] + plain["unpack"],
            "bound_ms": 2 * bound, "bound_by": "bytes",
            "library_ms": library["pack"] + library["unpack"]}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_nccl_world1():
    """The NCCL backend in a world of one rank on this card, made the way
    an elastic reset makes it: ``basics`` joins a one-rank group at a
    fresh store port (``_init_process_group``: the card kept, the
    transport agreed), every collective runs once on CUDA tensors against
    its expected result, and ``basics.shutdown()`` destroys the group;
    three incarnations.  One card cannot hold a two-rank NCCL
    communicator."""
    import torch.distributed as dist
    before = dict(fb.launches)
    incarnations = []
    for _ in range(3):
        port = free_port()
        os.environ["HOROVOD_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        t0 = time.perf_counter()
        basics.init()
        state = basics._state()
        try:
            state.process_group_owned = basics._init_process_group(state)
            state.backend = dist_ops.TorchDistBackend(state, state.transport)
            made_s = time.perf_counter() - t0
            checks = dist_ops.world1_checks(state.backend,
                                            torch.device("cuda"))
            backend = state.backend.name
            card_index = torch.cuda.current_device()
        finally:
            t0 = time.perf_counter()
            basics.shutdown()
            del os.environ["HOROVOD_TPU_COORDINATOR"]
        incarnations.append({
            "store_port": port, "backend": backend,
            "card": card_index, "checks": checks, "made_s": made_s,
            "destroyed_s": time.perf_counter() - t0,
            "group_left": dist.is_initialized()})
    emit("nccl_world1", incarnations=incarnations,
         nccl_version=".".join(map(str, torch.cuda.nccl.version())),
         fusion_launches={k: fb.launches[k] - before[k] for k in before})
    failed = [(i, name) for i, inc in enumerate(incarnations)
              for name, ok in inc["checks"].items() if not ok]
    if failed or any(inc["backend"] != "nccl" or inc["group_left"]
                     for inc in incarnations) or \
            len({inc["card"] for inc in incarnations}) != 1:
        raise AssertionError(f"nccl_world1: {failed} failed, or a group was "
                             f"left or moved: {incarnations}")


def eager_checks(rank: int, size: int, device) -> dict:
    """The eager collectives at two ranks on CUDA tensors, Adasum
    included, each against its expected value."""
    r = rank
    out = {}

    def ok(name, got, want, exact=True):
        assert got.device.type == torch.device(device).type, name
        out[name] = bool(torch.equal(got, want) if exact else
                         torch.allclose(got, want, rtol=1e-6, atol=1e-6))

    base = torch.arange(10, dtype=torch.float32, device=device)
    ok("allreduce_sum", hvd.allreduce(base * (r + 1), op=hvd.Sum,
                                      name="e.sum"), base * 3)
    ok("allreduce_average_scaled",
       hvd.allreduce(base * (r + 1), op=hvd.Average, prescale_factor=2.0,
                     postscale_factor=0.5, name="e.avg"), base * 1.5)
    got = hvd.grouped_allreduce([base, base[:3] * 2], op=hvd.Sum,
                                name="e.grp")
    ok("grouped_allreduce", torch.cat(got), torch.cat([base, base[:3] * 2]) * 2)
    ok("allgather_uneven",
       hvd.allgather(torch.full((r + 1, 3), float(r), device=device),
                     name="e.ag"),
       torch.tensor([[0.0] * 3, [1.0] * 3, [1.0] * 3], device=device))
    ok("broadcast", hvd.broadcast(base + r, root_rank=1, name="e.bc"),
       base + 1)
    a2a, splits = hvd.alltoall(base[:4] + 10 * r,
                               splits=[1, 3] if r == 0 else [2, 2],
                               name="e.a2a")
    want = torch.tensor([0.0, 10, 11] if r == 0 else [1.0, 2, 3, 12, 13],
                        device=device)
    ok("alltoall", a2a, want)
    ok("reducescatter", hvd.reducescatter(base[:5], op=hvd.Sum, name="e.rs"),
       (base[:5] * 2)[:3] if r == 0 else (base[:5] * 2)[3:])
    u8 = torch.tensor([200, 3] if r == 0 else [5, 250], dtype=torch.uint8,
                      device=device)
    ok("uint8_max", hvd.allreduce(u8, op=hvd.Max, name="e.u8"),
       torch.tensor([200, 250], dtype=torch.uint8, device=device))
    # Adasum of a = (1, 2, 0) and b = (2, 0, 1): a.b = 2, |a|^2 = |b|^2 = 5,
    # so the merge is 0.8 a + 0.8 b.
    va = torch.tensor([1.0, 2.0, 0.0], device=device)
    vb = torch.tensor([2.0, 0.0, 1.0], device=device)
    ok("adasum", hvd.allreduce(va if r == 0 else vb, op=hvd.Adasum,
                               name="e.adasum"), 0.8 * va + 0.8 * vb,
       exact=False)
    return out


def read_metrics(port: int, secret) -> tuple:
    """(HTTP status, body) of ``GET /metrics`` on this host's ``port``,
    signed with ``secret`` as the rendezvous client signs, or unsigned
    when ``secret`` is None."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics")
    if secret is not None:
        ts = repr(time.time())
        req.add_header(job_secret.TS_HEADER, ts)
        req.add_header(job_secret.HEADER, job_secret.sign(
            secret, "GET", "/metrics", b"", ts))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def train_2rank_worker():
    """One rank of the two-rank phase (``--train-worker``), started by the
    launcher: GPT-2 small at full width through
    ``hvd.torch.DistributedOptimizer`` (hooks on, bf16 compute, flash
    attention, AdamW), its own seeded tokens, then the eager collectives
    on CUDA tensors and its own ``/metrics`` (``HOROVOD_METRICS_PORT``),
    read signed and unsigned.  Prints one ``RESULT {...}`` line."""
    wall = {"started": STARTED, "init_begin": time.time()}
    hvd.init()
    wall["init_end"] = time.time()
    rank, size = hvd.rank(), hvd.size()
    backend = basics._state().backend
    cfg = gpt.gpt2_small_config(attention_impl="flash", dropout=0.0)
    # Each rank starts from other weights: the broadcast makes them one.
    model = gpt.GPTLMHeadModel(cfg, seed=rank).train()
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    g = torch.Generator(device="cuda").manual_seed(100 + rank)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device="cuda",
                        generator=g)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    fa.launches_by_body.update({body: 0 for body in fa.launches_by_body})
    fb.launches.update({k: 0 for k in fb.launches})
    fb.plain_calls.update({k: 0 for k in fb.plain_calls})
    backend.stats.update({k: 0 for k in backend.stats})

    def data_plane_seconds():
        """Host seconds the dispatch thread spent in fused allreduces
        (pack, staging, gloo, unpack), from the runtime's metrics."""
        hist = basics.metrics_snapshot()["histograms"].get(
            "hvd_collective_seconds", {}).get(
                f"backend={backend.name},op=ALLREDUCE", {})
        return hist.get("sum", 0.0)

    data_plane_s0 = data_plane_seconds()
    wall["model_ready"] = time.time()
    losses, step_ms = [], []
    for _ in range(STEPS_2RANK):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = gpt.lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        wall.setdefault("first_step_end", time.time())
    counts = {"flash": fa.launches_by_body[fa.BODY_WGMMA],
              "flash_all_bodies": fa.launches,
              "fusion": dict(fb.launches),
              "fusion_plain_calls": dict(fb.plain_calls),
              "backend": dict(backend.stats)}
    data_plane_s = data_plane_seconds() - data_plane_s0
    peak = torch.cuda.max_memory_allocated()
    digest = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        digest.update(name.encode())
        digest.update(p.detach().float().cpu().numpy().tobytes())
    checks = eager_checks(rank, size, torch.device("cuda"))
    transport = backend.name
    slot = {"rank": rank, "local_rank": hvd.local_rank(),
            "cross_rank": hvd.cross_rank(),
            "card": torch.cuda.current_device(),
            "transport": basics._state().transport}
    port = basics._state().metrics_server.port
    signed, text = read_metrics(port, os.environ[job_secret.ENV])
    unsigned, _ = read_metrics(port, None)
    hvd.shutdown()
    print("RESULT " + json.dumps({
        "rank": rank, "size": size, "backend": transport,
        "losses": losses, "step_ms": step_ms, "counts": counts,
        "data_plane_ms_per_step": data_plane_s / STEPS_2RANK * 1e3,
        "max_memory_allocated": peak, "params_sha256": digest.hexdigest(),
        "eager": checks, "slot": slot, "wall": wall,
        "rendezvous_port": int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"]),
        "metrics": {"signed": signed, "unsigned": unsigned,
                    "gloo_series": 'hvd_collective_seconds_count'
                                   '{backend="gloo"' in text}}),
          flush=True)


def process_tree(pid: int) -> list:
    """``pid`` and every process descended from it, read from /proc.  The
    launcher starts each worker in a session of its own, so a signal to
    the launcher's process group does not reach them."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    tree, todo = [], [pid]
    while todo:
        p = todo.pop()
        tree.append(p)
        todo += children.get(p, [])
    return tree


def kill_tree(pid: int):
    for p in process_tree(pid):
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


_PREFIX = re.compile(r"^\[(\d+)\]<(stdout|stderr)>:")


def result_lines(text: str) -> dict:
    """The workers' ``RESULT {...}`` lines by rank, with the launcher's
    ``[rank]<stdout>:`` prefix stripped."""
    results = {}
    for line in text.splitlines():
        m = _PREFIX.match(line)
        if m and m.group(2) == "stdout" and \
                line[m.end():].startswith("RESULT "):
            results[int(m.group(1))] = json.loads(line[m.end() + 7:])
    return results


def launch_2rank(log_dir: str) -> dict:
    """``python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2``
    of this script's ``--train-worker``, with ``HOROVOD_METRICS_PORT=0``;
    the launcher and its workers are killed past ``WORKER_TIMEOUT_S``.
    Returns the launcher's output, exit codes and host times."""
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_METRICS_PORT="0")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "-np", "2", "-H", "localhost:2", "--verbose",
           "--output-filename", log_dir, sys.executable,
           os.path.abspath(__file__), "--train-worker"]
    lines, first_result = [], []
    wall0, t0 = time.time(), time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)

    def pump():
        for line in proc.stdout:
            if not first_result and "<stdout>:RESULT " in line:
                first_result.append(time.perf_counter() - t0)
            lines.append(line)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        proc.wait(timeout=WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        kill_tree(proc.pid)
        proc.wait()
        reader.join(timeout=10)
        raise RuntimeError(f"train_2rank: the launch took more than "
                           f"{WORKER_TIMEOUT_S} s:\n"
                           f"{''.join(lines)[-6000:]}")
    reader.join(timeout=30)
    out = "".join(lines)
    finished = re.search(r"all workers finished in [\d.]+s: (\{.*\})", out)
    # The launcher's ``--verbose`` log stamps the moment it starts each
    # rank's command (logging's local-time asctime, to the millisecond).
    spawned = {}
    for m in re.finditer(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) \S+ "
                         r"INFO: launching rank (\d+) on ", out, re.M):
        spawned[int(m.group(3))] = time.mktime(time.strptime(
            m.group(1), "%Y-%m-%d %H:%M:%S")) + int(m.group(2)) / 1e3
    return {"cmd": cmd, "output": out, "returncode": proc.returncode,
            "rank_codes": ast.literal_eval(finished.group(1))
            if finished else None, "spawned": spawned,
            "seconds": time.perf_counter() - t0, "wall0": wall0,
            "first_result_s": first_result[0] if first_result else None}


def phase_train_2rank() -> dict:
    """The main path at two ranks, started by the port's launcher: two
    fresh worker processes, both on this card, so the data plane is gloo.
    Checks what the workers report, their ``/metrics`` under the job
    secret and the launcher's capture files, emits the ``launcher`` and
    ``train_2rank`` lines, and returns the workers' launch counts."""
    with tempfile.TemporaryDirectory() as log_dir:
        run = launch_2rank(log_dir)
        out = run["output"]
        if run["returncode"] != 0:
            raise RuntimeError(f"train_2rank: the launcher exited "
                               f"{run['returncode']}:\n{out[-6000:]}")
        by_rank = result_lines(out)
        if sorted(by_rank) != [0, 1]:
            raise RuntimeError(f"train_2rank: RESULT lines of ranks "
                               f"{sorted(by_rank)}:\n{out[-6000:]}")
        for rank in (0, 1):
            with open(os.path.join(log_dir, f"rank.{rank}", "stdout")) as f:
                captured = result_lines(f.read())
            assert captured == {rank: by_rank[rank]}, \
                f"--output-filename capture of rank {rank} differs"
    results = [by_rank[0], by_rank[1]]
    assert run["rank_codes"] == {0: 0, 1: 0}, run["rank_codes"]
    r0, r1 = results
    for r in results:
        assert r["backend"] == "gloo", r["backend"]
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        assert r["losses"][-1] < r["losses"][0], r["losses"]
        c = r["counts"]
        assert c["fusion"]["pack"] > 0 and c["fusion"]["unpack"] > 0, c
        assert c["fusion_plain_calls"] == {"pack": 0, "unpack": 0}, c
        assert c["flash"] >= 12 * STEPS_2RANK, c
        assert all(r["eager"].values()), r["eager"]
        m = r["metrics"]
        assert (m["signed"], m["unsigned"]) == (200, 403), m
        assert m["gloo_series"], m
        assert r["slot"]["transport"] == "gloo", r["slot"]
        assert r["rendezvous_port"] == r0["rendezvous_port"], r
    assert r0["params_sha256"] == r1["params_sha256"], \
        "parameters differ between the ranks"
    median = [statistics.median(r["step_ms"][1:]) for r in results]
    launched_by = " ".join(["python"] + run["cmd"][1:7])
    # Host seconds of each rank's way to its first step, from the wall
    # clock at the launch (one host, one clock).
    startup = {}
    for r in results:
        w = r["wall"]
        spawned = run["spawned"][r["rank"]]
        startup[r["rank"]] = {
            "launcher_s": spawned - run["wall0"],
            "worker_interpreter_s": w["started"] - spawned,
            "launch_to_worker_start_s": w["started"] - run["wall0"],
            "imports_s": w["init_begin"] - w["started"],
            "init_s": w["init_end"] - w["init_begin"],
            "model_and_broadcast_s": w["model_ready"] - w["init_end"],
            "first_step_s": w["first_step_end"] - w["model_ready"],
            "launch_to_first_step_s": w["first_step_end"] - run["wall0"]}
    emit("launcher", launched_by=launched_by,
         slot_plan=[r["slot"] for r in results],
         rendezvous_port=r0["rendezvous_port"],
         exit_codes={"launcher": run["returncode"],
                     "ranks": run["rank_codes"]},
         first_result_s=run["first_result_s"], launch_s=run["seconds"],
         startup=startup,
         metrics={r["rank"]: r["metrics"] for r in results})
    emit("train_2rank", config="gpt2_small bf16 flash, 2 ranks on one card",
         launched_by=launched_by,
         backend="gloo", batch_per_rank=BATCH, seq=SEQ, steps=STEPS_2RANK,
         losses={r["rank"]: r["losses"] for r in results},
         step_ms={r["rank"]: r["step_ms"] for r in results},
         median_step_ms=median,
         tokens_per_s_pair=2 * BATCH * SEQ / (max(median) / 1e3),
         fused_responses_per_step=r0["counts"]["backend"]["flat_allreduces"]
         / STEPS_2RANK,
         fused_bytes_per_step=r0["counts"]["backend"]["allreduce_bytes"]
         / STEPS_2RANK,
         data_plane_ms_per_step={r["rank"]: r["data_plane_ms_per_step"]
                                 for r in results},
         max_memory_allocated={r["rank"]: r["max_memory_allocated"]
                               for r in results},
         counts={r["rank"]: r["counts"] for r in results},
         params_identical=True, params_sha256=r0["params_sha256"],
         eager={r["rank"]: r["eager"] for r in results})
    return {"flash": sum(r["counts"]["flash"] for r in results),
            "fusion": sum(r["counts"]["fusion"]["pack"] +
                          r["counts"]["fusion"]["unpack"] for r in results)}


# ---------------------------------------------------------------------------
# elastic: GPT-2 small through the elastic launcher, 2 -> 3 -> 2 ranks
# ---------------------------------------------------------------------------
ELASTIC_STEPS = 3          # steps the phase waits for at each size
ELASTIC_SAMPLES = 512      # the seeded synthetic token set


def state_sha256(model, opt) -> tuple:
    """sha256 of the parameters and of the optimizer state, each read in
    name order as fp32 bytes on the host."""
    params, moments = hashlib.sha256(), hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        params.update(name.encode())
        params.update(t.detach().float().cpu().numpy().tobytes())
    for i, st in sorted(opt.state_dict()["state"].items()):
        for k, t in sorted(st.items()):
            moments.update(f"{i}.{k}".encode())
            moments.update(t.detach().float().cpu().numpy().tobytes())
    return params.hexdigest(), moments.hexdigest()


def elastic_worker():
    """One rank of the elastic phase (``--elastic-worker``), started by
    the elastic launcher: GPT-2 small at full width, bf16 compute, flash
    attention, AdamW through ``DistributedOptimizer``, an
    ``ElasticSampler`` over a seeded synthetic token set and a
    ``TorchState`` committed after every step, in ``torch.elastic.run``.
    The worker on host ``127.0.0.1`` dies (``os._exit(1)``) from a
    gradient hook inside the backward of its fourth step.  Prints one
    JSON line per sync (``SYNCED``), per step (``STEP``, with the kernel
    counts so far) and at the end (``RESULT``)."""
    from horovod_tpu_torch.runner.elastic.worker import current_epoch
    from horovod_tpu_torch.torch.elastic import (ElasticSampler, TorchState,
                                                 run)
    wall = {"started": STARTED, "init_begin": time.time()}
    hvd.init()
    wall["init_end"] = time.time()
    host = os.environ["HOROVOD_HOSTNAME"]
    doomed = host == "127.0.0.1"
    stop_file = os.environ["CHIP_ELASTIC_STOP"]
    cfg = gpt.gpt2_small_config(attention_impl="flash", dropout=0.0)
    model = gpt.GPTLMHeadModel(cfg, seed=0).train()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4),
        named_parameters=model.named_parameters())
    tokens = torch.randint(0, cfg.vocab_size, (ELASTIC_SAMPLES, SEQ),
                           generator=torch.Generator().manual_seed(7))
    sampler = ElasticSampler(tokens, shuffle=True, seed=0)
    state = TorchState(model, opt, sampler, step=0)
    joined = []
    # Host ms of the last commit (the snapshot on the card and the poll
    # of the driver's generation), reported with the next step.
    commit_ms = [None]

    def emit_line(tag, **fields):
        print(tag + " " + json.dumps(dict(fields, rank=hvd.rank(),
                                          size=hvd.size(), host=host,
                                          pid=os.getpid(),
                                          wall=time.time())), flush=True)

    if doomed:
        def die(_):
            if state.step >= joined[0] + ELASTIC_STEPS:
                emit_line("DYING", step=state.step)
                os._exit(1)
        model.layers[0].attention.query.weight \
            .register_post_accumulate_grad_hook(die)

    torch.cuda.synchronize()
    fa.launches = 0
    fa.launches_by_body.update({body: 0 for body in fa.launches_by_body})
    fb.launches.update({k: 0 for k in fb.launches})
    fb.plain_calls.update({k: 0 for k in fb.plain_calls})
    wall["model_ready"] = time.time()

    @run
    def train(state):
        synced = time.time()
        # Hashes only where the phase compares them: at the sync that
        # takes a joiner in (every rank of the grown world).
        sha = None
        if not joined or hvd.size() == 3:
            t0 = time.perf_counter()
            sha = state_sha256(model, opt)
            hash_s = time.perf_counter() - t0
        else:
            hash_s = 0.0
        joined.append(state.step)
        emit_line("SYNCED", step=state.step, epoch=current_epoch(),
                  local_rank=hvd.local_rank(), cross_rank=hvd.cross_rank(),
                  card=torch.cuda.current_device(),
                  transport=basics._state().transport, sha=sha,
                  synced_wall=synced, hash_s=hash_s)
        batch = 0
        while True:
            stop = hvd.allreduce(torch.tensor([float(os.path.exists(
                stop_file))]), op=hvd.Sum, name="elastic.stop")
            if stop.item() > 0:
                return state.step
            t0 = time.perf_counter()
            flash0 = fa.launches_by_body[fa.BODY_WGMMA]
            fusion0, plain0 = dict(fb.launches), dict(fb.plain_calls)
            idx = sampler.indices[batch * BATCH:(batch + 1) * BATCH]
            ids = tokens[idx].cuda()
            opt.zero_grad()
            loss = gpt.lm_loss(model(ids), ids)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            sampler.record_batch(batch, BATCH)
            batch += 1
            state.step += 1
            emit_line("STEP", step=state.step, loss=loss.item(),
                      step_ms=(time.perf_counter() - t0) * 1e3,
                      prev_commit_ms=commit_ms[0],
                      flash=fa.launches_by_body[fa.BODY_WGMMA] - flash0,
                      fusion={k: fb.launches[k] - fusion0[k] for k in fusion0},
                      plain={k: fb.plain_calls[k] - plain0[k] for k in plain0},
                      counts={"flash": fa.launches_by_body[fa.BODY_WGMMA],
                              "flash_all_bodies": fa.launches,
                              "fusion": dict(fb.launches),
                              "fusion_plain_calls": dict(fb.plain_calls)})
            t0 = time.perf_counter()
            try:
                state.commit()
            finally:
                commit_ms[0] = (time.perf_counter() - t0) * 1e3

    train(state)
    peak = torch.cuda.max_memory_allocated()
    sha = state_sha256(model, opt)
    hist = basics.metrics_snapshot()["histograms"].get(
        "hvd_recovery_seconds", {})
    emit_line("RESULT", step=state.step, sha=sha,
              max_memory_allocated=peak, wall=wall,
              recovery_seconds={k: {"count": v["count"], "sum": v["sum"]}
                                for k, v in hist.items()},
              counts={"flash": fa.launches_by_body[fa.BODY_WGMMA],
                      "flash_all_bodies": fa.launches,
                      "fusion": dict(fb.launches),
                      "fusion_plain_calls": dict(fb.plain_calls)})
    hvd.shutdown()


_TAGGED = re.compile(r"^\[(\d+)\]<stdout>:(SYNCED|STEP|DYING|RESULT) (\{.*\})$")


def phase_elastic() -> dict:
    """GPT-2 small through the port's elastic launcher on this card:
    ``-np 2 --min-np 2 --max-np 3 --host-discovery-script``.  Every rank
    shares the card, so the data plane is gloo.  The phase grows the
    world by adding ``127.0.0.1:1`` to the hosts file after three steps
    at size 2; the joiner dies inside its fourth backward at size 3; the
    phase stops the job after three steps at size 2 again.  Checks the
    sizes, the commit the survivors resume from, the hashes after the
    joiner's sync and at the end, the kernel counts and the exit codes;
    emits the ``elastic`` line and returns the kernel launches."""
    with tempfile.TemporaryDirectory() as tmp:
        hosts = os.path.join(tmp, "hosts")
        with open(hosts, "w") as f:
            f.write("localhost:2\n")
        script = os.path.join(tmp, "discover.sh")
        with open(script, "w") as f:
            f.write(f"#!/bin/sh\ncat {hosts}\n")
        os.chmod(script, 0o755)
        stop_file = os.path.join(tmp, "stop")
        env = dict(os.environ, PYTHONPATH=REPO, CHIP_ELASTIC_STOP=stop_file)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", "2", "--min-np", "2", "--max-np", "3",
               "--host-discovery-script", script, "--verbose",
               sys.executable, os.path.abspath(__file__), "--elastic-worker"]
        lines, events = [], []
        marks = {}
        wall0 = time.time()
        proc = subprocess.Popen(cmd, env=env, cwd=REPO,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)

        def pump():
            for line in proc.stdout:
                lines.append(line)
                m = _TAGGED.match(line.rstrip("\n"))
                if m:
                    events.append((m.group(2), json.loads(m.group(3))))

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()

        def steps(size, after=0.0):
            return [e for tag, e in list(events) if tag == "STEP" and
                    e["size"] == size and e["wall"] > after]

        def wait(cond, what):
            deadline = time.monotonic() + WORKER_TIMEOUT_S
            while not cond():
                if proc.poll() is not None or time.monotonic() > deadline:
                    kill_tree(proc.pid)
                    raise RuntimeError(f"elastic: {what} never happened:\n"
                                       f"{''.join(lines)[-6000:]}")
                time.sleep(0.2)

        try:
            wait(lambda: len(steps(2)) >= 2 * ELASTIC_STEPS,
                 "three steps at size 2")
            marks["hosts_changed"] = time.time()
            with open(hosts, "w") as f:
                f.write("localhost:2\n127.0.0.1:1\n")
            wait(lambda: any(tag == "DYING" for tag, _ in list(events)),
                 "the joiner's death")
            marks["death"] = next(e["wall"] for tag, e in events
                                  if tag == "DYING")
            wait(lambda: len(steps(2, marks["death"])) >= 2 * ELASTIC_STEPS,
                 "three steps at size 2 after the death")
            with open(stop_file, "w"):
                pass
            proc.wait(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            kill_tree(proc.pid)
            raise RuntimeError("elastic: the launcher did not finish:\n"
                               + "".join(lines)[-6000:])
        reader.join(timeout=30)
    out = "".join(lines)
    if proc.returncode != 0:
        raise RuntimeError(f"elastic: the launcher exited {proc.returncode}"
                           f":\n{out[-6000:]}")
    finished = re.search(r"all workers finished in [\d.]+s: (\{.*\})", out)
    codes = ast.literal_eval(finished.group(1)) if finished else None
    assert codes == {"localhost:0": 0, "localhost:1": 0,
                     "127.0.0.1:0": 1}, codes

    synced = [e for tag, e in events if tag == "SYNCED"]
    step_events = [e for tag, e in events if tag == "STEP"]
    results = {e["rank"]: e for tag, e in events if tag == "RESULT"}
    dying = next(e for tag, e in events if tag == "DYING")
    # The world sizes each process saw, in the order it saw them.
    sizes = {}
    for e in synced:
        sizes.setdefault(e["pid"], []).append(e["size"])
    originals = {e["pid"] for e in synced if e["epoch"] == 1}
    assert len(originals) == 2 and \
        all(sizes[pid] == [2, 3, 2] for pid in originals), sizes
    assert [sizes[pid] for pid in sizes if pid not in originals] == [[3]]
    # The joiner's state after sync() is rank 0's, bit for bit.
    at3 = [e for e in synced if e["size"] == 3]
    assert len(at3) == 3 and len({tuple(e["sha"]) for e in at3}) == 1, at3
    # The step that the death interrupted never committed: the survivors
    # resume from the last step every rank finished at size 3.
    last3 = max(e["step"] for e in step_events if e["size"] == 3)
    resumed = [e for e in synced if e["size"] == 2 and
               e["wall"] > dying["wall"]]
    assert [e["step"] for e in resumed] == [last3, last3], resumed
    assert dying["step"] == last3
    assert all(math.isfinite(e["loss"]) for e in step_events)
    assert sorted(results) == [0, 1], sorted(results)
    assert results[0]["sha"] == results[1]["sha"]
    # Every step launched both kernels and no plain version.  The plain
    # pack and unpack still run outside the steps, on the CPU tensors of
    # the stop flag and of the sync's pickled objects.
    for e in step_events:
        assert e["flash"] >= 12, e
        assert e["fusion"]["pack"] == e["fusion"]["unpack"] > 0, e
        assert e["plain"] == {"pack": 0, "unpack": 0}, e
        c = e["counts"]
        assert c["flash_all_bodies"] == c["flash"], c
    for e in synced:
        assert e["transport"] == "gloo" and e["card"] == 0, e

    commits = [e["prev_commit_ms"] for e in step_events
               if e["prev_commit_ms"] is not None]
    by_size = {}
    for e in step_events:
        by_size.setdefault(e["size"], {}).setdefault(e["rank"], []).append(
            e["step_ms"])
    first3 = min(e["wall"] for e in step_events if e["size"] == 3)
    first2 = {r: min(e["wall"] for e in step_events if e["rank"] == r and
                     e["size"] == 2 and e["wall"] > dying["wall"])
              for r in (0, 1)}
    joiner_sync = next(e for e in at3 if e["host"] == "127.0.0.1")
    epochs = {}
    for e in synced:
        epochs.setdefault(e["epoch"], []).append(
            {"host": e["host"], "local_rank": e["local_rank"],
             "rank": e["rank"], "size": e["size"], "card": e["card"],
             "transport": e["transport"]})
    # Kernel launches of the run: each process's last count (the dead
    # one's at the last step it finished).
    last = {}
    for e in step_events + list(results.values()):
        last[e["pid"]] = e["counts"]
    flash = sum(c["flash"] for c in last.values())
    fusion = sum(c["fusion"]["pack"] + c["fusion"]["unpack"]
                 for c in last.values())
    emit("elastic", config="gpt2_small bf16 flash AdamW, batch 8 x 1024 "
         "per rank, ranks sharing one card over gloo",
         launched_by=" ".join(["python"] + cmd[1:11]),
         exit_codes={"launcher": proc.returncode, "workers": codes},
         slot_plan_by_epoch={str(k): sorted(v, key=lambda s: s["rank"])
                             for k, v in sorted(epochs.items())},
         sizes_seen={f"{'original' if pid in originals else 'joiner'} "
                     f"pid {pid}": v for pid, v in sizes.items()},
         resumed_step=last3,
         steps_by_size={str(s): {str(r): len(v) for r, v in d.items()}
                        for s, d in sorted(by_size.items())},
         median_step_ms={str(s): {str(r): statistics.median(v)
                                  for r, v in d.items()}
                         for s, d in sorted(by_size.items())},
         median_commit_ms=statistics.median(commits),
         hosts_change_to_first_step_at_3_s=first3 - marks["hosts_changed"],
         joiner_hash_s=joiner_sync["hash_s"],
         death_to_first_step_at_2_s={str(r): t - dying["wall"]
                                     for r, t in first2.items()},
         death_to_resync_s={str(e["rank"]): e["synced_wall"] - dying["wall"]
                            for e in resumed},
         recovery_seconds={str(r): results[r]["recovery_seconds"]
                           for r in (0, 1)},
         max_memory_allocated={str(r): results[r]["max_memory_allocated"]
                               for r in (0, 1)},
         joiner_sha256=at3[0]["sha"], final_sha256=results[0]["sha"],
         launch_s=time.time() - wall0,
         counts={str(k): v for k, v in last.items()})
    return {"flash": flash, "fusion": fusion}


def main():
    global CARD
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is available")
    if sys.argv[1:] == ["--train-worker"]:
        train_2rank_worker()
        return
    if sys.argv[1:] == ["--elastic-worker"]:
        elastic_worker()
        return
    CARD = card()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    phase_build()
    flash_row = phase_kernels()
    fusion_row = phase_fusion_kernel()
    phase_model_parity()
    phase_train()
    phase_nccl_world1()
    launches = phase_train_2rank()
    elastic = phase_elastic()
    flash_row["launches"] = launches["flash"] + elastic["flash"]
    fusion_row["launches"] = launches["fusion"] + elastic["fusion"]
    print(CARD, flush=True)
    print(json.dumps({"kernels": [flash_row, fusion_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
