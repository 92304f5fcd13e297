"""On-card smoke test of horovod_tpu_torch: builds the CUDA kernels from
this checkout, holds each against its plain PyTorch version, checks the
GPT-2-small model at full width, trains it through ``hvd.torch`` in a
world of one, runs the NCCL backend in a world of one, and trains it at
two ranks sharing the card.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``.  Each phase prints one JSON line; any failure raises and the
script exits non-zero.  The last lines are the card's name and power
limit as nvidia-smi reports them, the per-kernel summary, and
``{"ok": true, "device": {...}}``.

The two-rank phase starts two fresh worker processes of this script
(``--train-worker``) with the launcher's env contract.  Both use the one
card, so CUDA tensors cross ranks over gloo, staged through host memory
(NCCL refuses two ranks on one device).
"""

import concurrent.futures
import dataclasses
import hashlib
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

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
    """The NCCL backend in a world of one rank on this card: every
    collective once on CUDA tensors, each against its expected result.
    One card cannot hold a two-rank NCCL communicator."""
    import torch.distributed as dist
    from horovod_tpu_torch.common.env import Knobs, RankInfo
    dist.init_process_group(dist_ops.process_group_backend("nccl"),
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        state = dataclasses.make_dataclass(
            "State", ["rank_info", "knobs"])(RankInfo(), Knobs())
        backend = dist_ops.TorchDistBackend(state, "nccl")
        before = dict(fb.launches)
        checks = dist_ops.world1_checks(backend, torch.device("cuda"))
    finally:
        dist.destroy_process_group()
    emit("nccl_world1", backend=backend.name, checks=checks,
         nccl_version=".".join(map(str, torch.cuda.nccl.version())),
         fusion_launches={k: fb.launches[k] - before[k] for k in before})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"nccl_world1: {failed} failed")


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


def train_2rank_worker():
    """One rank of the two-rank phase (``--train-worker``): GPT-2 small at
    full width through ``hvd.torch.DistributedOptimizer`` (hooks on,
    bf16 compute, flash attention, AdamW), its own seeded tokens, then
    the eager collectives on CUDA tensors.  Prints one ``RESULT {...}``
    line."""
    hvd.init()
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
    hvd.shutdown()
    print("RESULT " + json.dumps({
        "rank": rank, "size": size, "backend": transport,
        "losses": losses, "step_ms": step_ms, "counts": counts,
        "data_plane_ms_per_step": data_plane_s / STEPS_2RANK * 1e3,
        "max_memory_allocated": peak, "params_sha256": digest.hexdigest(),
        "eager": checks}), flush=True)


def phase_train_2rank() -> dict:
    """The main path at two ranks: two fresh worker processes with the
    launcher's env contract, both on this card, so the data plane is
    gloo.  Returns the workers' launch counts."""
    coord, ctrl = free_port(), free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update({
            "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": "2",
            "HOROVOD_LOCAL_RANK": str(rank), "HOROVOD_LOCAL_SIZE": "2",
            "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
            "HOROVOD_TPU_COORDINATOR": f"127.0.0.1:{coord}",
            "HOROVOD_CONTROLLER_ADDR": f"127.0.0.1:{ctrl}",
            "PYTHONPATH": REPO})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--train-worker"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    results, outputs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            raise RuntimeError(f"train_2rank: rank {rank} exited "
                               f"{p.returncode}:\n{out[-6000:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(lines[-1][len("RESULT "):]))
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
    assert r0["params_sha256"] == r1["params_sha256"], \
        "parameters differ between the ranks"
    median = [statistics.median(r["step_ms"][1:]) for r in results]
    emit("train_2rank", config="gpt2_small bf16 flash, 2 ranks on one card",
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


def main():
    global CARD
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is available")
    if sys.argv[1:] == ["--train-worker"]:
        train_2rank_worker()
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
    flash_row["launches"] = launches["flash"]
    fusion_row["launches"] = launches["fusion"]
    print(CARD, flush=True)
    print(json.dumps({"kernels": [flash_row, fusion_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
