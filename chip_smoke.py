"""On-card smoke test of horovod_tpu_torch: builds the CUDA kernels and
the native C++ coordinator from this checkout, holds each kernel against
its plain PyTorch version, checks the GPT-2-small model at full width,
trains it through ``hvd.torch`` in a world of one (its last step under
the device trace), takes many device traces in a row around one flash
call, each of which must hold the kernel, runs the NCCL backend in a world of one (made and
destroyed three times, as an elastic reset does), trains it at two ranks
sharing the card under the native coordinator and then under each
coordinator in turns, trains it elastically at 2, 3 and 2 ranks,
tunes it, preempts it and resumes it at two ranks, trains it and
BERT-base sharded over four ranks (fsdp x tp and dp x tp DTensor steps),
runs the reference's ResNet-50 synthetic benchmark in a world of one and
at two ranks, runs ring and Ulysses attention at GPT-2 small's
attention widths and the pipeline x expert-parallel step over four
ranks, trains DLRM-tiny at two ranks while a replica on the card
serves its durable commits over HTTP, fits the MNIST CNN at two
ranks through the Spark estimator API and resumes it from its Store,
launches the user's entry points: the Adasum BERT-large pretraining
example and the PyTorch synthetic benchmark from
``horovod_tpu_torch/examples/``, and an upstream Horovod script through
the port's ``horovod`` alias, and runs the operator tools of
``horovod_tpu_torch/tools/`` against live ranks on the card, and soaks
the port's control plane under seeded faults and rank, relay and
trainer deaths with the data plane on the card, and last runs the
port's static-analysis gate (``python -m
horovod_tpu_torch.tools.hvdlint --check all``) on this tree.

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
unsigned, before it shuts down.  In that launch each worker also
reduces GPT-2 small's 196 fp32 gradients on the card through Keras's
torch-backend reducer (``horovod_tpu_torch._keras._torch_grads_fn``) and
through ``grouped_allreduce`` with the same op and scales (``Average``,
``gradient_predivide_factor=2.0``, ``Compression.fp16``): bit-equal,
fp32 on ``cuda:0``, through the fusion kernel (the ``keras_reducer``
line; the ``packages`` line says whether Keras and TensorFlow are
installed, which this check does not need).  The launch pins
``HOROVOD_TPU_NATIVE=1`` and rank 0 must host the native coordinator;
the coordinator phase
repeats it with ``HOROVOD_TPU_NATIVE`` 0, 0, 1 and compares negotiation
under the two servers.  The elastic and tune_durable phases check that
rank 0 hosts the server the JAX package's rule gives for their
environment: native for the first, Python for the tuner.

The elastic phase starts ``chip_smoke.py --elastic-worker`` through the
elastic launcher, ``python -m horovod_tpu_torch.runner.launch -np 2
--min-np 2 --max-np 3 --host-discovery-script <script>``, whose script
prints a hosts file the phase rewrites: ``127.0.0.1:1`` joins after three
steps at size 2, dies inside a backward after three steps at size 3, and
the survivors restore the last commit and train on at size 2.

The tune_durable phase launches ``chip_smoke.py --durable-worker`` twice
with ``--tune --tune-profile`` and ``HOROVOD_CHECKPOINT_DIR``: launch A
searches, freezes, takes three more steps and commits durably every
second step, then a SIGTERM to the launcher
preempts it and the hook's final commit lands; launch B loads the
profile without a search and resumes from that commit.

The sharded_train phase launches ``chip_smoke.py --sharded-worker`` once
with ``-np 4 -H localhost:4``: GPT-2 small through
``training.make_gpt_train_step`` on ``{"fsdp": 2, "tp": 2}``, then
BERT-base through ``make_bert_pretrain_step`` on ``{"dp": 2, "tp": 2}``,
three steps each at full width with the flash kernel on each rank's
heads.  Each model's losses at steps 1 and 2 (before and after one
update) must equal those of the unsharded model on one rank, with the
same optimizer and batch (computed here first), within ``STEP1_RTOL``
and ``STEP2_RTOL``.

The resnet50 phase runs the reference's pytorch_synthetic_benchmark.py
on the port's ``ResNet50`` (224x224, 1000 classes, bf16, batch 32 per
rank, ``SGD(lr=0.01 x size)`` in ``hvd.DistributedOptimizer``) here in a
world of one, then launches ``chip_smoke.py --resnet-worker`` with ``-np
2 -H localhost:2``: each rank's step-1 and step-2 losses must equal a
one-rank computation of its half (``resnet_oracle``), and the launch
also holds ``hvd.SyncBatchNorm`` against ``nn.BatchNorm2d``.  The
context_parallel phase launches ``chip_smoke.py --cp-worker`` with ``-np
4 -H localhost:4``: ring and Ulysses attention on ``{"sp": 4}`` with
``[1, 2048, 12, 64]`` per rank, against ``reference_attention`` on the
whole 8192 tokens, then ``training``'s ring-attention and pipeline-MoE
dry runs at full width.

The dlrm_serve phase launches ``chip_smoke.py --dlrm-worker`` with ``-np
2 -H localhost:2``: DLRM-tiny (two 65536 x 16 tables, mean bags) for 24
steps of 32 examples per rank, the tables row-sharded on the card and
exchanged by alltoall, the dense gradients averaged by ``hvd.allreduce``,
a durable commit every 5 steps (a base, then deltas) through
``KVCommitCoordinator`` on the launcher's KV.  Meanwhile this process
serves the commits (``horovod_tpu_torch.serve.start``, tables on the
card, HTTP under a job secret) at 50 queries/s of Zipf lookups and bags.
Each rank's losses and final parameters and shards must equal a
one-process oracle's exactly, every answer the committed rows at its
stamped step, and the replica must end on the last commit.

The spark_estimator phase fits the port's ``MnistCNN`` with
``spark.torch.TorchEstimator`` to 8192 synthetic rows (a pandas
DataFrame, one-hot labels of a random linear teacher) in a
``FilesystemStore``, at two ranks on ``LocalBackend`` (two workers of
``python -c``, both on this card over gloo), for two epochs, then
resumes a copy with ``epochs=3`` from the Store's checkpoint.  Each
per-epoch loss of both ranks and the parameters after each fit must
equal a replay of both ranks' batches in this process, the fitted
model's predictions on 256 held-out rows its forward, and each rank's
gradients must go through the fusion kernel.

The examples phase launches, from a temporary directory and with this
checkout on ``PYTHONPATH``, ``python -m horovod_tpu_torch.runner.launch
-np 2 -H localhost:2`` of three scripts: ``adasum/adasum_bert_pretrain.py``
at BERT-large's published widths with the flash kernel (seq 128, batch
8 per rank, 3 steps), whose rank 0's final parameters must equal a
one-process oracle's (each rank's local AdamW step, the deltas merged by
the plain Adasum formula) within ``ADASUM_PARAM_ATOL``;
``pytorch/pytorch_synthetic_benchmark.py`` (batch 32, its stand-in CNN);
and an upstream-style ``import horovod.torch as hvd`` script, which
must get the port, load no JAX and reduce a CUDA tensor exactly.

The tools phase runs ``python -m horovod_tpu_torch.tools.<name>`` as a
user runs it: ``measure_torch_staging`` at two ranks (1, 16 and 64 MB,
every sum exact), with ``hvdtop --once`` (signed, and unsigned, which
the job secret refuses) and ``flame`` against the ranks' live
``/status`` and ``/profile`` while it measures; ``measure_elastic
--paths torch --runs 1`` with the flight recorder armed in the workers,
then ``blackbox_merge`` of their dumps, which must name the dead rank,
and ``validate_trace --merged`` of the merge; ``profile_resnet`` at
batch 128 with a device trace that ``validate_trace`` must accept; and
``tune_report``, plain and ``--diff``, on the profile the tune_durable
phase froze.

The chaos phase runs ``python -m horovod_tpu_torch.tools.chaos_soak
--ranks 8 --schedules 3 --seed 0``: 8 thread ranks, each with its own
runtime over the real coordinator and its own data-plane stream on this
card, under the baseline and two seeded fault schedules, then the
mid_epoch, mid_write and mid_delta checkpoint drills.  Then, in this
process on ``cuda:0``, the replay-kill, MTTR kill-at-idle, relay
kill-mid-negotiation and serve drills with the JAX tier-1 tests'
arguments.  Every drill must be ok with no hang and no incorrect result,
every collective's result must sit on ``cuda:0`` in its input's dtype,
each postmortem must name the victim, and the phase must end within
150 s.  It launches neither kernel (the ``kernels`` line's
``launches_by_path`` shows 0 for it).
"""

import ast
import concurrent.futures
import dataclasses
import hashlib
import importlib.util
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
from horovod_tpu_torch import kernels, native, profile_step  # noqa: E402
from horovod_tpu_torch.checkpoint import (  # noqa: E402
    committed_steps, preemption, read_manifest, step_dir)
from horovod_tpu_torch.common import basics  # noqa: E402
from horovod_tpu_torch.common import failpoints, straggler  # noqa: E402
from horovod_tpu_torch.common import timeline  # noqa: E402
from horovod_tpu_torch.common.timeline import (  # noqa: E402
    start_xla_trace, stop_xla_trace)
from horovod_tpu_torch.common.fusion import fuse_responses  # noqa: E402
from horovod_tpu_torch.common.message import (  # noqa: E402
    DataType, Response, ResponseType)
from horovod_tpu_torch.models import gpt  # noqa: E402
from horovod_tpu_torch.ops import dist_ops  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402
from horovod_tpu_torch.ops import fusion_buffer as fb  # noqa: E402
from horovod_tpu_torch.runner import job_secret  # noqa: E402
from horovod_tpu_torch.runner import safe_shell_exec  # noqa: E402
from horovod_tpu_torch.spark import LocalBackend  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
STEPS = 6
STEPS_2RANK = 4
KERAS_REDUCER_SEED = 200  # keras_reducer's gradients: seed + rank
BATCH, SEQ = 8, 1024
TRACE_REPEATS = 100  # trace_repeat's traces of each kind
BERT_BATCH, BERT_SEQ = 16, 512    # sharded_train's BERT-base batch
ADASUM_BATCH, ADASUM_SEQ = 8, 128  # the examples phase's BERT-large batch
BERT_LARGE_BH = ADASUM_BATCH * 16  # its attention calls: 16 heads a row
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


def build_coordinator() -> dict:
    """g++ of the native coordinator (``native.ensure_built``); its
    seconds, and whether the library was there already."""
    cached = os.path.exists(native.library_path())
    t0 = time.perf_counter()
    built = native.ensure_built()
    return {"built": built, "gxx_s": time.perf_counter() - t0,
            "cached": cached}


def phase_build():
    """Builds the kernels from this checkout, one nvcc per source, and
    the native coordinator with g++, all started together, before any
    launch (rank 0's init would otherwise time a compile), and reads what
    was built: per flash instantiation
    the HGMMA (wgmma), UTMALDG (TMA load) and SYNCS (mbarrier)
    instructions in its SASS, per kernel its registers and spill bytes
    from the ptxas log.  Any of the four wgmma instantiations missing,
    one without HGMMA or UTMALDG, any kernel that spills, a fusion
    dtype missing, or a log that says setmaxnreg was ignored (C7508)
    fails the build."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        coordinator = pool.submit(build_coordinator)
        for lib in pool.map(kernels.load, SOURCES):
            assert lib is not None
        coordinator = coordinator.result()
    nvcc_s = {src: kernels.build_seconds[src] for src in SOURCES}
    if not coordinator["built"] or not native.available():
        raise RuntimeError("build check failed: the native coordinator: "
                           + native.unavailable_reason())
    coordinator.update(
        source="horovod_tpu_torch/native/coordinator.cc",
        library=os.path.relpath(native.library_path(), REPO),
        gxx=subprocess.run(["g++", "--version"], capture_output=True,
                           text=True).stdout.splitlines()[0])
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
         fusion_kernels=fusion, fusion_ptxas_warnings=fusion_warnings,
         coordinator=coordinator)
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
    no TF32): each body at the GPT-2-small training shape, the wrapper's
    choice at the per-rank shapes of the sharded steps, and ragged
    shapes.  Then the wgmma body, the mma.sync body and sdpa timed at the
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
             # sharded_train's per-rank calls: half the batch (fsdp 2 or
             # dp 2) and half the heads (tp 2).
             ("gpt2_small_sharded", BATCH // 2 * heads // 2, SEQ, SEQ, hd,
              bf16, True, 3e-2, None),
             ("bert_base_sharded", BERT_BATCH // 2 * heads // 2, BERT_SEQ,
              BERT_SEQ, hd, bf16, False, 3e-2, None),
             # The examples phase's BERT-large: 8 x 16 heads per layer.
             ("bert_large", BERT_LARGE_BH, ADASUM_SEQ, ADASUM_SEQ, hd, bf16,
              False, 3e-2, None),
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
    main_path = {n: errors[n] for n in ("gpt2_small", "gpt2_small_sharded",
                                        "bert_base_sharded", "bert_large")}
    bert_large = bert_large_timing()
    row = {"name": "flash_attn_fwd", "route": "cuda",
           "source": "horovod_tpu_torch/kernels/flash_attn_fwd.cu",
           "replaces": "horovod_tpu/ops/pallas_attention.py:40",
           "launches": None, "max_abs_err": max(main_path.values()),
           "max_abs_err_by_shape": main_path,
           "ms": ms, "earlier_ms": earlier_ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "bert_large": bert_large}
    emit("kernels", max_abs_err=errors, body=bodies,
         shape=[BATCH, SEQ, heads, d], dtype="bfloat16", causal=True,
         order=order, runs_ms=runs, wgmma_ms=ms, mma_ms=earlier_ms,
         sdpa_ms=library_ms, plain_ms=plain_ms,
         host_us_per_call=host_us, bytes=nbytes, flops=flops,
         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
         bert_large=bert_large)
    return row


def bert_large_timing() -> dict:
    """The wrapper (wgmma body), sdpa and the plain version at
    BERT-large's per-layer shape in the examples phase, ``[8 x 16, 128,
    64]`` bf16, non-causal, timed in turns; the bound as for the GPT
    shape (every (q, k) pair unmasked)."""
    bh, sq, d = BERT_LARGE_BH, ADASUM_SEQ, 64
    q, k, v = qkv(bh, sq, sq, d, torch.bfloat16, seed=21)
    scale = d ** -0.5
    q4, k4, v4 = (t.view(ADASUM_BATCH, bh // ADASUM_BATCH, sq, d)
                  for t in (q, k, v))
    timed = {
        "wgmma": lambda: fa.flash_attention_cuda(q, k, v, scale, False),
        "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4)}
    order = ["wgmma", "sdpa", "sdpa", "wgmma"]
    runs = {name: [] for name in timed}
    for name in order:
        runs[name].append(median_ms(timed[name], launches=20))
    got = fa.flash_attention_cuda(q, k, v, scale, False)
    ref = fa.flash_attention_reference(q, k, v, scale, False)
    plain_ms = median_ms(
        lambda: fa.flash_attention_reference(q, k, v, scale, False),
        launches=2, rounds=3)
    nbytes = 4 * bh * sq * d * q.element_size()
    flops = 4 * d * bh * sq * sq
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    return {"shape": [bh, sq, d], "dtype": "bfloat16", "causal": False,
            "max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "order": order, "runs_ms": runs,
            "ms": statistics.mean(runs["wgmma"]),
            "library_ms": statistics.mean(runs["sdpa"]),
            "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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
    through hvd.torch in a world of one.  The last step runs under
    ``start_xla_trace``/``stop_xla_trace``: its Chrome trace must name
    the wgmma flash kernel, and its device time is read by kernel and
    category (``profile_step``'s reader); the step medians leave the
    traced step out."""
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
    with tempfile.TemporaryDirectory() as trace_dir:
        for i in range(STEPS):
            traced = i == STEPS - 1
            if traced:
                start_xla_trace(trace_dir)
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = gpt.lm_loss(model(ids), ids)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if traced:
                trace_path = stop_xla_trace()
                with open(trace_path) as f:
                    trace_events = len(json.load(f)["traceEvents"])
                trace_bytes = os.path.getsize(trace_path)
                by_name = profile_step.device_ms_by_name(trace_path)
            losses.append(loss.item())
    flash_traced = {n[:90]: ms for n, ms in by_name.items()
                    if "flash_fwd" in n}
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
    assert flash_traced and all("flash_fwd_wgmma_kernel" in n
                                for n in flash_traced), sorted(by_name)
    median_step = statistics.median(step_ms[1:-1])
    emit("train", config="gpt2_small bf16 flash", batch=BATCH, seq=SEQ,
         steps=STEPS, losses=losses, step_ms=step_ms,
         median_step_ms=median_step, median_of_steps=[2, STEPS - 1],
         tokens_per_s=BATCH * SEQ / (median_step / 1e3),
         max_memory_allocated=peak, flash_launches=fa.launches,
         flash_launches_by_body={fa.BODY_NAMES[b]: n
                                 for b, n in by_body.items()},
         device_trace={"step": STEPS, "trace_bytes": trace_bytes,
                       "events": trace_events,
                       "device_busy_ms": sum(by_name.values()),
                       "device_ms_by_category":
                       profile_step.ms_by_category(by_name),
                       "flash_kernel_ms": flash_traced})


def phase_trace_repeat():
    """The device trace keeps what ran on the card every time:
    ``TRACE_REPEATS`` traces in a row, each ``start_xla_trace`` /
    ``stop_xla_trace`` around one flash call at GPT-2 small's attention
    shape, must each hold the wgmma kernel's device event.  In turn with
    them, ten of each kind at a time, run as many traces with the
    window's margins at 0 (the trace as it was before them; not gated),
    so the line gives what the margins cost: each kind's misses and the
    host seconds of its starts and stops.  These launches belong to no
    main path."""
    q, k, v = qkv(BATCH * 12, SEQ, SEQ, 64, torch.bfloat16, seed=5)
    fa.flash_attention_cuda(q, k, v, 0.125, True)
    torch.cuda.synchronize()
    margin = timeline.DEVICE_WINDOW_MARGIN_S
    runs = {"margin": [], "no_margin": []}
    with tempfile.TemporaryDirectory() as trace_dir:
        try:
            for i in range(2 * TRACE_REPEATS):
                # Blocks of ten of each kind: a start's cost may depend
                # on the stop before it, so the later-start figures
                # below take only starts that follow their own kind.
                off = (i // 10) % 2
                kind = "no_margin" if off else "margin"
                timeline.DEVICE_WINDOW_MARGIN_S = 0.0 if off else margin
                t0 = time.perf_counter()
                start_xla_trace(os.path.join(trace_dir, str(i)))
                t1 = time.perf_counter()
                fa.flash_attention_cuda(q, k, v, 0.125, True)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                path = stop_xla_trace()
                t3 = time.perf_counter()
                events = sum(1 for n in profile_step.device_ms_by_name(path)
                             if "flash_fwd_wgmma_kernel" in n)
                os.remove(path)
                runs[kind].append((events, t1 - t0, t3 - t2, i % 10))
        finally:
            timeline.DEVICE_WINDOW_MARGIN_S = margin
    report = {}
    for kind, rows in runs.items():
        starts = sorted(r[1] for r in rows if r[3])
        stops = sorted(r[2] for r in rows)
        report[kind] = {
            "traces": len(rows),
            "misses": [i for i, r in enumerate(rows) if r[0] != 1],
            "later_start_s": {"median": statistics.median(starts),
                              "p90": starts[int(0.9 * len(starts))],
                              "max": starts[-1]},
            "stop_s": {"median": statistics.median(stops),
                       "p90": stops[int(0.9 * len(stops))],
                       "max": stops[-1]}}
    emit("trace_repeat", shape=[BATCH * 12, SEQ, 64], dtype="bf16",
         margin_s=margin, **report)
    assert report["margin"]["misses"] == [], report["margin"]


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
    # ResNet-50's 161 fp32 gradients (resnet50's two-rank path).
    rshapes = resnet50_gradient_shapes()
    rgrads = {name: torch.randn(shape, device="cuda", generator=g)
              for name, shape in rshapes}
    rresponses = fused_responses(rshapes, torch.float32)
    for i, names in enumerate(rresponses):
        fusion_case(f"resnet50_fp32_response{i}", [rgrads[n] for n in names],
                    1.0, 0.5, errors)
    del rgrads
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
         resnet50={"tensors": len(rshapes),
                   "responses": [len(names) for names in rresponses]},
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


def expected_server() -> str:
    """The server class rank 0 hosts in this process's world by the JAX
    package's rule (``_make_server`` of horovod_tpu/common/
    controller_net.py, the port's the same): the Python coordinator when
    a timeline, a tuner, metrics aggregation, failpoints, liveness,
    reconnect grace, a relay tree or the straggler observatory is on, or
    ``HOROVOD_TPU_NATIVE`` turns native off; else the native one (the
    build phase built it)."""
    st = basics._state()
    k = st.knobs
    python_only = (st.timeline is not None or k.tune or k.autotune or
                   k.metrics_agg_interval_s > 0 or failpoints.ENABLED or
                   k.liveness_interval_s > 0 or k.reconnect_grace_s > 0 or
                   k.coord_fanout > 0 or straggler.ENABLED)
    off = os.environ.get("HOROVOD_TPU_NATIVE", "1").strip().lower() in \
        ("0", "false", "off", "no")
    return "CoordinatorServer" if python_only or off else \
        "NativeCoordinatorServer"


def server_of_rank0() -> str:
    """The class of the server rank 0 hosts, on every rank (rank 0
    broadcasts it)."""
    server = basics._state().runtime.controller.server
    return hvd.broadcast_object(
        type(server).__name__ if hvd.rank() == 0 else None, root_rank=0)


def cache_rounds() -> list:
    """Rank 0's response-cache rounds so far, [fast, full], from either
    server; None on the other ranks."""
    server = basics._state().runtime.controller.server
    if server is None:
        return None
    if isinstance(server, native.NativeCoordinatorServer):
        return list(server.cache_stats())
    return [server.stats["fast_rounds"], server.stats["full_rounds"]]


def uplink_frames() -> int:
    """Negotiation frames this rank sent so far: full requests (RQ) and
    cache-bit frames (CH)."""
    stats = basics._state().runtime.controller.stats
    return stats["rq_frames"] + stats["ch_frames"]


def collective_seconds() -> float:
    """Host seconds in collectives so far, every op and backend:
    ``hvd_collective_seconds``'s sum."""
    hist = basics.metrics_snapshot()["histograms"].get(
        "hvd_collective_seconds", {})
    return sum(h.get("sum", 0.0) for h in hist.values())


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


def train_2rank_worker(keras_reducer: bool = False):
    """One rank of the two-rank phase (``--train-worker``), started by the
    launcher: GPT-2 small at full width through
    ``hvd.torch.DistributedOptimizer`` (hooks on, bf16 compute, flash
    attention, AdamW), its own seeded tokens, then the eager collectives
    on CUDA tensors, with ``keras_reducer`` (``--keras-reducer``) the
    Keras reducer check, and its own ``/metrics``
    (``HOROVOD_METRICS_PORT``), read signed and unsigned.  Reports rank
    0's server class, its cache rounds, this rank's uplink frames and
    collective seconds over the steps.  Prints one ``RESULT {...}``
    line."""
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
    rounds0, frames0 = cache_rounds(), uplink_frames()
    collective_s0 = collective_seconds()
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
    collective_s = collective_seconds() - collective_s0
    frames = uplink_frames() - frames0
    rounds = cache_rounds()
    if rounds is not None:
        rounds = {"steps": [a - b for a, b in zip(rounds, rounds0)],
                  "total": rounds}
    server = server_of_rank0()
    peak = torch.cuda.max_memory_allocated()
    digest = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        digest.update(name.encode())
        digest.update(p.detach().float().cpu().numpy().tobytes())
    checks = eager_checks(rank, size, torch.device("cuda"))
    # The gradients' shapes in backward order, as
    # gpt2_small_gradient_shapes() gives them, without a second model.
    reducer = keras_reducer_check(rank, size, [
        (name, tuple(p.shape)) for name, p in model.named_parameters()
        if p.requires_grad][::-1]) if keras_reducer else None
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
        "collective_ms_per_step": collective_s / STEPS_2RANK * 1e3,
        "uplink_frames_per_step": frames / STEPS_2RANK,
        "server": server, "expected_server": expected_server(),
        "cache_rounds": rounds,
        "max_memory_allocated": peak, "params_sha256": digest.hexdigest(),
        "eager": checks, "keras_reducer": reducer, "slot": slot,
        "wall": wall,
        "rendezvous_port": int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"]),
        "metrics": {"signed": signed, "unsigned": unsigned,
                    "gloo_series": 'hvd_collective_seconds_count'
                                   '{backend="gloo"' in text}}),
          flush=True)


def keras_reducer_check(rank: int, size: int, shapes) -> dict:
    """Keras's torch-backend reducer on the card: GPT-2 small's 196 fp32
    gradients (``shapes``, in backward order; seeded per rank, on
    ``cuda:0``, as Keras's torch trainer hands them to ``apply``)
    through ``horovod_tpu_torch._keras._torch_grads_fn`` and through the
    torch binding's ``grouped_allreduce`` with the same op and scales,
    for ``Average``, ``Average`` with ``gradient_predivide_factor=2.0``
    and ``Compression.fp16``.  Needs no Keras: the reducer takes torch
    tensors.  Returns, per case, bit-equality and every output's device
    and dtype; the fusion kernel's packs and unpacks against the plain
    version's (from zero, over the whole check); and the host ms per
    call of each route on the ``Average`` case, timed in ABBA order (its
    first call of each route is the case's check)."""
    from horovod_tpu_torch import _keras
    from horovod_tpu_torch.ops.compression import Compression
    g = torch.Generator(device="cuda").manual_seed(KERAS_REDUCER_SEED + rank)
    grads = [torch.randn(shape, device="cuda", generator=g)
             for _, shape in shapes]
    cases = {"average": (Compression.none, 1.0),
             "predivide_2": (Compression.none, 2.0),
             "fp16": (Compression.fp16, 1.0)}

    def keras_route(comp, pre):
        return _keras._torch_grads_fn(comp, hvd.Average, pre,
                                      hvd.global_process_set)(grads)

    def binding_route(comp, pre):
        packed = [comp.compress(t) for t in grads]
        out = hvd.grouped_allreduce([c for c, _ in packed], op=hvd.Sum,
                                    prescale_factor=1.0 / pre,
                                    postscale_factor=pre / size)
        return [comp.decompress(o, ctx) for o, (_, ctx) in zip(out, packed)]

    def check(got, want):
        torch.cuda.synchronize()
        return {"bit_equal": len(got) == len(want) and all(
                    torch.equal(a, b) for a, b in zip(got, want)),
                "devices": sorted({str(t.device) for t in got}),
                "dtypes": sorted({str(t.dtype) for t in got})}

    torch.cuda.synchronize()
    fb.launches.update({k: 0 for k in fb.launches})
    fb.plain_calls.update({k: 0 for k in fb.plain_calls})
    routes = {"keras": keras_route, "binding": binding_route}
    order = ["keras", "binding", "binding", "keras"]
    ms, first = {k: [] for k in routes}, {}
    for route in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = routes[route](*cases["average"])
        torch.cuda.synchronize()
        ms[route].append((time.perf_counter() - t0) * 1e3)
        first.setdefault(route, out)
        del out
    checked = {"average": check(first.pop("keras"), first.pop("binding"))}
    for name in ("predivide_2", "fp16"):
        checked[name] = check(keras_route(*cases[name]),
                              binding_route(*cases[name]))
    return {"tensors": len(grads), "elements": sum(t.numel() for t in grads),
            "cases": checked, "fusion": dict(fb.launches),
            "fusion_plain_calls": dict(fb.plain_calls), "order": order,
            "host_ms_by_call": ms,
            "host_ms_per_call": {k: statistics.mean(v) for k, v in ms.items()}}


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


def spawned_walls(out: str) -> dict:
    """Wall clock at which the launcher started each rank's command, from
    its ``--verbose`` log (logging's local-time asctime, to the ms)."""
    spawned = {}
    for m in re.finditer(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) \S+ "
                         r"INFO: launching rank (\d+) on ", out, re.M):
        spawned[int(m.group(3))] = time.mktime(time.strptime(
            m.group(1), "%Y-%m-%d %H:%M:%S")) + int(m.group(2)) / 1e3
    return spawned


def launch_2rank(log_dir: str, native_flag: str,
                 keras_reducer: bool = False) -> dict:
    """``python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2``
    of this script's ``--train-worker``, with ``HOROVOD_METRICS_PORT=0``
    and ``HOROVOD_TPU_NATIVE=native_flag`` (``1``: a library that does
    not load fails the launch instead of falling back); the launcher and
    its workers are killed past ``WORKER_TIMEOUT_S``.  Returns the
    launcher's output, exit codes and host times."""
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_METRICS_PORT="0",
               HOROVOD_TPU_NATIVE=native_flag)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "-np", "2", "-H", "localhost:2", "--verbose",
           "--output-filename", log_dir, sys.executable,
           os.path.abspath(__file__), "--train-worker"] + \
        (["--keras-reducer"] if keras_reducer else [])
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
    return {"cmd": cmd, "output": out, "returncode": proc.returncode,
            "rank_codes": ast.literal_eval(finished.group(1))
            if finished else None, "spawned": spawned_walls(out),
            "seconds": time.perf_counter() - t0, "wall0": wall0,
            "first_result_s": first_result[0] if first_result else None}


def run_2rank(native_flag: str, keras_reducer: bool = False) -> tuple:
    """One launch of the two-rank main path with ``HOROVOD_TPU_NATIVE``
    pinned to ``native_flag`` (and with ``keras_reducer``, the workers'
    Keras reducer check); checks what the workers report, their
    ``/metrics`` under the job secret, the launcher's capture files and
    that rank 0 hosted the server the JAX package's rule gives.  Returns
    the launch and the workers' results, by rank."""
    with tempfile.TemporaryDirectory() as log_dir:
        run = launch_2rank(log_dir, native_flag, keras_reducer)
        out = run["output"]
        if run["returncode"] != 0:
            raise RuntimeError(f"2-rank launch (HOROVOD_TPU_NATIVE="
                               f"{native_flag}): the launcher exited "
                               f"{run['returncode']}:\n{out[-6000:]}")
        by_rank = result_lines(out)
        if sorted(by_rank) != [0, 1]:
            raise RuntimeError(f"2-rank launch: RESULT lines of ranks "
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
        assert r["server"] == r["expected_server"] == (
            "NativeCoordinatorServer" if native_flag == "1"
            else "CoordinatorServer"), (native_flag, r["server"],
                                        r["expected_server"])
    assert r0["params_sha256"] == r1["params_sha256"], \
        "parameters differ between the ranks"
    return run, results


def launch_counts(results) -> dict:
    """The launch's kernel counts: training and, where it ran, the Keras
    reducer check."""
    fusion = 0
    for r in results:
        for counted in (r["counts"], r["keras_reducer"]):
            if counted is not None:
                fusion += counted["fusion"]["pack"] + \
                    counted["fusion"]["unpack"]
    return {"flash": sum(r["counts"]["flash"] for r in results),
            "fusion": fusion}


def emit_keras_reducer(results):
    """The ``keras_reducer`` line, and its gates: every case bit-equal,
    every output fp32 on ``cuda:0``, the fusion kernel's packs and
    unpacks above 0 and the plain version's at 0, on both ranks."""
    by_rank = {r["rank"]: r["keras_reducer"] for r in results}
    emit("keras_reducer",
         config="gpt2_small's fp32 gradients on cuda:0, 2 ranks sharing "
                "one card over gloo; _keras._torch_grads_fn against "
                "torch.grouped_allreduce, same op and scales",
         **{k: by_rank[0][k] for k in ("tensors", "elements", "order")},
         cases={rank: c["cases"] for rank, c in by_rank.items()},
         fusion={rank: c["fusion"] for rank, c in by_rank.items()},
         fusion_plain_calls={rank: c["fusion_plain_calls"]
                             for rank, c in by_rank.items()},
         host_ms_per_call={rank: c["host_ms_per_call"]
                           for rank, c in by_rank.items()},
         host_ms_by_call={rank: c["host_ms_by_call"]
                          for rank, c in by_rank.items()})
    for rank, c in by_rank.items():
        assert c["tensors"] == 196 and c["elements"] == 124439808, c
        for name, case in c["cases"].items():
            assert case["bit_equal"], (rank, name, case)
            assert case["devices"] == ["cuda:0"], (rank, name, case)
            assert case["dtypes"] == ["torch.float32"], (rank, name, case)
        assert c["fusion"]["pack"] > 0 and c["fusion"]["unpack"] > 0, c
        assert c["fusion_plain_calls"] == {"pack": 0, "unpack": 0}, c


def coordinator_summary(native_flag: str, run: dict, results) -> dict:
    """One launch's negotiation numbers for the ``coordinator`` line."""
    r0 = results[0]
    return {
        "HOROVOD_TPU_NATIVE": native_flag, "server": r0["server"],
        "fused_responses_per_step":
        r0["counts"]["backend"]["flat_allreduces"] / STEPS_2RANK,
        "uplink_frames_per_step": {r["rank"]: r["uplink_frames_per_step"]
                                   for r in results},
        "cache_rounds_fast_full": r0["cache_rounds"],
        "median_step_ms_rank0": statistics.median(r0["step_ms"][1:]),
        "step_ms": {r["rank"]: r["step_ms"] for r in results},
        "data_plane_ms_per_step": {r["rank"]: r["data_plane_ms_per_step"]
                                   for r in results},
        "collective_ms_per_step": {r["rank"]: r["collective_ms_per_step"]
                                   for r in results},
        "params_sha256": r0["params_sha256"], "launch_s": run["seconds"]}


def phase_train_2rank() -> tuple:
    """The main path at two ranks, started by the port's launcher: two
    fresh worker processes, both on this card, so the data plane is gloo,
    with ``HOROVOD_TPU_NATIVE=1``: rank 0 must host the native
    coordinator.  The workers also run the Keras reducer check.  Emits
    the ``keras_reducer``, ``launcher`` and ``train_2rank`` lines and
    returns the workers' launch counts and the run's ``coordinator``
    summary."""
    run, results = run_2rank("1", keras_reducer=True)
    emit_keras_reducer(results)
    r0 = results[0]
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
         eager={r["rank"]: r["eager"] for r in results},
         coordinator_server={r["rank"]: r["server"] for r in results},
         cache_rounds_fast_full=r0["cache_rounds"],
         uplink_frames_per_step={r["rank"]: r["uplink_frames_per_step"]
                                 for r in results})
    return launch_counts(results), coordinator_summary("1", run, results)


def phase_coordinator(first_native: dict) -> dict:
    """The two-rank launch of ``train_2rank`` under each coordinator, in
    turns: native (``train_2rank``'s own launch), Python, Python, native
    (``HOROVOD_TPU_NATIVE`` 1, 0, 0, 1), so that a drift of the host's
    speed over the call weighs on both servers alike (two-rank step
    times rose launch after launch in one call).  Every run must end
    with one parameter hash: a two-rank fp32 sum with postscale 1/2 is
    exact whatever the fusion grouping.  Emits the ``coordinator`` line
    and returns the three launches' kernel counts."""
    runs, counts = [first_native], {"flash": 0, "fusion": 0}
    for flag in ("0", "0", "1"):
        run, results = run_2rank(flag)
        runs.append(coordinator_summary(flag, run, results))
        for k, v in launch_counts(results).items():
            counts[k] += v
    by_server = {}
    for r in runs:
        by_server.setdefault(r["server"], []).append(r)
    emit("coordinator", config="gpt2_small bf16 flash AdamW, batch 8 x "
         "1024 per rank, 2 ranks sharing one card over gloo",
         order=[r["server"] for r in runs], runs=runs,
         median_step_ms_rank0={k: [r["median_step_ms_rank0"] for r in v]
                               for k, v in by_server.items()},
         fused_responses_per_step={
             k: [r["fused_responses_per_step"] for r in v]
             for k, v in by_server.items()},
         params_sha256=runs[0]["params_sha256"])
    assert [r["server"] for r in runs] == [
        "NativeCoordinatorServer", "CoordinatorServer", "CoordinatorServer",
        "NativeCoordinatorServer"], runs
    hashes = {r["params_sha256"] for r in runs}
    assert len(hashes) == 1, f"parameter hashes differ: {hashes}"
    return counts


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
        server = basics._state().runtime.controller.server
        emit_line("SYNCED", step=state.step, epoch=current_epoch(),
                  local_rank=hvd.local_rank(), cross_rank=hvd.cross_rank(),
                  card=torch.cuda.current_device(),
                  transport=basics._state().transport, sha=sha,
                  synced_wall=synced, hash_s=hash_s,
                  server=type(server).__name__ if server else None,
                  expected_server=expected_server())
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
    # Rank 0 of every world hosted the server the JAX package's rule
    # gives for its environment (the launcher sets no Python-only knob).
    servers = {}
    for e in synced:
        if e["rank"] == 0:
            assert e["server"] == e["expected_server"], e
            servers.setdefault(f"epoch {e['epoch']} size {e['size']}",
                               e["server"])

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
         counts={str(k): v for k, v in last.items()},
         rank0_server=servers)
    return {"flash": flash, "fusion": fusion}


# ---------------------------------------------------------------------------
# tune_durable: GPT-2 small tuned, preempted by SIGTERM and resumed, at two
# ranks through the launcher
# ---------------------------------------------------------------------------
DURABLE_AFTER_FREEZE = 3   # launch A's steps after the session froze
DURABLE_FREEZE_BY = 8      # launch A fails unless frozen by this step
DURABLE_RESUME_STEPS = 2   # launch B's steps after its restore
DURABLE_HOLD_S = 300       # launch A waits this long for the SIGTERM


def durable_worker():
    """One rank of the tune_durable phase (``--durable-worker``), started
    by the launcher with ``--tune --tune-profile`` and
    ``HOROVOD_CHECKPOINT_DIR``: GPT-2 small at full width through
    ``DistributedOptimizer`` (bf16 compute, flash attention, AdamW) in a
    ``TorchState``, a ``durable_checkpointer(state, every_n_commits=2,
    keep=2)`` and the preemption hook, after ``broadcast_parameters``.

    Launch A (cold start) trains until every rank sees the session
    frozen, then ``DURABLE_AFTER_FREEZE`` more steps (it fails unless
    frozen by step ``DURABLE_FREEZE_BY``), waits for its last durable
    commit, hashes the committed state and
    sleeps until the phase's SIGTERM; the hook's final commit reports its
    step id.  Launch B restores, hashes what it restored and trains
    ``DURABLE_RESUME_STEPS`` steps.  Each rank appends JSON lines to
    ``$CHIP_DURABLE_DIR/<launch>.rank<r>.jsonl``: the launcher's output
    pipe may be gone by the time the final commit lands."""
    import horovod_tpu_torch
    from horovod_tpu_torch.checkpoint import install_preemption_hook
    from horovod_tpu_torch.torch.elastic import (TorchState,
                                                 durable_checkpointer)
    wall = {"started": STARTED, "init_begin": time.time()}
    hvd.init()
    wall["init_end"] = time.time()
    rank = hvd.rank()
    launch = os.environ["CHIP_DURABLE_LAUNCH"]
    path = os.path.join(os.environ["CHIP_DURABLE_DIR"],
                        f"{launch}.rank{rank}.jsonl")

    def report(event, **fields):
        with open(path, "a") as f:
            f.write(json.dumps(dict(fields, event=event, rank=rank,
                                    wall=time.time())) + "\n")

    st = basics._state()
    rt, backend = st.runtime, st.backend
    cfg = gpt.gpt2_small_config(attention_impl="flash", dropout=0.0)
    model = gpt.GPTLMHeadModel(cfg, seed=0).train()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    d2h_ms = []

    class State(TorchState):
        # Times the copy of the committed snapshot to host numpy.
        def durable_state_dict(self):
            t0 = time.perf_counter()
            items = super().durable_state_dict()
            d2h_ms.append((time.perf_counter() - t0) * 1e3)
            return items

    state = State(model, opt, step=0)
    ckpt = durable_checkpointer(state, every_n_commits=2, keep=2)
    t0 = time.perf_counter()
    restored = ckpt.maybe_restore()
    restore_s = time.perf_counter() - t0
    server = rt.controller.server
    report("start", restored=restored, step=state.step,
           server=type(server).__name__ if server else None,
           expected_server=expected_server(),
           restore_s=restore_s, launcher_wall=wall,
           sha=state_sha256(model, opt) if restored is not None else None,
           tune=horovod_tpu_torch.tune_status(),
           profile_loaded=st.knobs.tune_profile_loaded,
           hold=rt.replay.stats()["tuning_hold"],
           cycles_per_sample=st.knobs.tune_cycles_per_sample)
    committed_sha = [None]

    class Final:
        """The hook's checkpointer: the final commit, then its report."""

        def finalize(self, timeout=None, reason="shutdown"):
            began, t0 = time.time(), time.perf_counter()
            n = len(d2h_ms)
            sid = ckpt.finalize(timeout=timeout, reason=reason)
            report("final", id=sid, sha=committed_sha[0], began=began,
                   seconds=time.perf_counter() - t0, d2h_ms=d2h_ms[n:],
                   save_seconds=basics.metrics_snapshot()["histograms"]
                   .get("hvd_ckpt_save_seconds", {}))
            return sid

    install_preemption_hook(Final())
    g = torch.Generator(device="cuda").manual_seed(100 + rank)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device="cuda",
                        generator=g)
    torch.cuda.synchronize()
    fa.launches = 0
    fa.launches_by_body.update({body: 0 for body in fa.launches_by_body})
    fb.launches.update({k: 0 for k in fb.launches})
    fb.plain_calls.update({k: 0 for k in fb.plain_calls})
    backend.stats.update({k: 0 for k in backend.stats})
    report("ready", wall_steps=time.time())
    steps = DURABLE_RESUME_STEPS if restored is not None \
        else DURABLE_FREEZE_BY + DURABLE_AFTER_FREEZE
    frozen_at = None
    for i in range(steps):
        flash0, flash_all0 = fa.launches_by_body[fa.BODY_WGMMA], fa.launches
        fusion0, plain0 = dict(fb.launches), dict(fb.plain_calls)
        stats0, ctrl0 = dict(backend.stats), dict(rt.controller.stats)
        phase_before = horovod_tpu_torch.tune_status()["phase"]
        replay_before = rt.replay.stats()["active"]
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = gpt.lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = {
            "flash": fa.launches_by_body[fa.BODY_WGMMA] - flash0,
            "flash_all_bodies": fa.launches - flash_all0,
            "fusion": {k: fb.launches[k] - fusion0[k] for k in fusion0},
            "plain": {k: fb.plain_calls[k] - plain0[k] for k in plain0},
            "responses": sum(backend.stats[k] - stats0[k] for k in
                             ("flat_allreduces", "hierarchical_allreduces")),
            "bytes": backend.stats["allreduce_bytes"] -
            stats0["allreduce_bytes"],
            "uplink_frames": sum(rt.controller.stats[k] - ctrl0[k]
                                 for k in ("rq_frames", "ch_frames"))}
        tune = horovod_tpu_torch.tune_status()
        replay_after = rt.replay.stats()["active"]
        # Every rank stops at the same step: the freeze is agreed.
        frozen = hvd.allreduce(torch.tensor(
            [float(tune["phase"] == "frozen")]), op=hvd.Min,
            name="durable.frozen").item() > 0
        state.step += 1
        t0 = time.perf_counter()
        state.commit()
        commit_ms = (time.perf_counter() - t0) * 1e3
        n = len(d2h_ms)
        t0 = time.perf_counter()
        sid = ckpt.commit()
        durable_ms = (time.perf_counter() - t0) * 1e3
        report("step", step=state.step, loss=loss.item(), step_ms=step_ms,
               phase=[phase_before, tune["phase"]],
               replay=[replay_before, replay_after], frozen=frozen,
               commit_ms=commit_ms, durable_id=sid,
               durable_call_ms=durable_ms, d2h_ms=d2h_ms[n:],
               tune=tune if rank == 0 else None,
               cycle_time_ms=st.knobs.cycle_time_ms, **counts)
        if restored is not None:
            continue
        if frozen_at is None and frozen:
            frozen_at = i
        if frozen_at is None and i + 1 >= DURABLE_FREEZE_BY:
            raise RuntimeError(f"tune_durable: the session did not freeze "
                               f"in {DURABLE_FREEZE_BY} steps")
        if frozen_at is not None and i - frozen_at >= DURABLE_AFTER_FREEZE:
            break
    ckpt.wait()
    if restored is not None:
        report("done", step=state.step,
               tune=horovod_tpu_torch.tune_status())
        hvd.shutdown()
        return
    committed_sha[0] = state_sha256(model, opt)
    report("held", step=state.step, sha=committed_sha[0],
           frozen_at=frozen_at, max_memory_allocated=
           torch.cuda.max_memory_allocated(),
           save_seconds=basics.metrics_snapshot()["histograms"]
           .get("hvd_ckpt_save_seconds", {}))
    time.sleep(DURABLE_HOLD_S)
    raise RuntimeError("tune_durable: no SIGTERM came")


def read_reports(directory: str, launch: str) -> dict:
    out = {}
    for rank in (0, 1):
        p = os.path.join(directory, f"{launch}.rank{rank}.jsonl")
        out[rank] = [json.loads(line) for line in open(p)] \
            if os.path.exists(p) else []
    return out


def events(reports: dict, event: str) -> dict:
    return {r: [e for e in evs if e["event"] == event]
            for r, evs in reports.items()}


def start_launcher(cmd, env, cwd: str = REPO):
    lines = []
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)

    def pump():
        for line in proc.stdout:
            lines.append(line)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    return proc, lines, reader


# The profile launch A froze, as its file held it (phase_tools).
TUNED_PROFILE = []


def phase_tune_durable() -> dict:
    """GPT-2 small at two ranks on this card, twice through the launcher
    (``-np 2 -H localhost:2 --tune --tune-profile``, with
    ``HOROVOD_CHECKPOINT_DIR``).  Launch A searches, freezes and takes
    three more steps, then the phase sends SIGTERM to the launcher, which
    passes it on to its workers while it serves their final commit.  Launch B must load
    the profile without a search and restore A's final commit with the
    same hashes on both ranks.  Emits the ``tune_durable`` line and
    returns the kernel launches of both launches' steps."""
    with tempfile.TemporaryDirectory() as d:
        ckpt_dir, profile = os.path.join(d, "ckpt"), \
            os.path.join(d, "profile.json")
        env = dict(os.environ, PYTHONPATH=REPO, CHIP_DURABLE_DIR=d,
                   HOROVOD_CHECKPOINT_DIR=ckpt_dir)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", "2", "-H", "localhost:2", "--verbose", "--tune",
               "--tune-profile", profile, sys.executable,
               os.path.abspath(__file__), "--durable-worker"]
        runs = {}
        for launch in ("A", "B"):
            wall0 = time.time()
            proc, lines, reader = start_launcher(
                cmd, dict(env, CHIP_DURABLE_LAUNCH=launch))
            deadline = time.monotonic() + WORKER_TIMEOUT_S
            sigterm = None
            try:
                if launch == "A":
                    while not all(events(read_reports(d, "A"), "held")
                                  .values()):
                        if proc.poll() is not None or \
                                time.monotonic() > deadline:
                            raise RuntimeError(
                                "tune_durable: launch A ended before its "
                                "ranks held:\n" + "".join(lines)[-6000:])
                        time.sleep(0.2)
                    sigterm = time.time()
                    proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"tune_durable: launch {launch} did not "
                                   "end:\n" + "".join(lines)[-6000:])
            finally:
                kill_tree(proc.pid)
            reader.join(timeout=30)
            out = "".join(lines)
            want_rc = -signal.SIGTERM if launch == "A" else 0
            if proc.returncode != want_rc:
                raise RuntimeError(f"tune_durable: launch {launch} exited "
                                   f"{proc.returncode}, not {want_rc}:\n"
                                   f"{out[-6000:]}")
            runs[launch] = {"reports": read_reports(d, launch),
                            "wall0": wall0, "sigterm": sigterm,
                            "spawned": spawned_walls(out)}
        with open(profile) as f:
            TUNED_PROFILE.append(f.read())  # the tools phase reports it
        frozen_profile = json.loads(TUNED_PROFILE[-1])
        manifests = {step: sum(sh["nbytes"] for sh in read_manifest(
            step_dir(ckpt_dir, step)).shards)
            for step in committed_steps(ckpt_dir)}
    a, b = runs["A"]["reports"], runs["B"]["reports"]
    steps_a, steps_b = events(a, "step"), events(b, "step")
    finals, helds = events(a, "final"), events(a, "held")
    starts_b = events(b, "start")
    # Every step and both launches' ends, before anything is checked.
    emit("tune_durable_steps", columns=[
        "step", "phase before/after", "replay before/after", "responses",
        "uplink frames", "step ms", "durable id", "d2h ms"],
        steps={launch: {str(r): [
            [e["step"], e["phase"], e["replay"], e["responses"],
             e["uplink_frames"], round(e["step_ms"], 2), e["durable_id"],
             [round(ms, 2) for ms in e["d2h_ms"]]]
            for e in events(runs[launch]["reports"], "step")[r]]
            for r in (0, 1)} for launch in ("A", "B")},
        ends={launch: {str(r): [
            {k: v for k, v in e.items() if k not in ("save_seconds",)}
            for e in evs if e["event"] in ("start", "held", "final",
                                           "done")]
            for r, evs in runs[launch]["reports"].items()}
            for launch in ("A", "B")})
    # --- launch A: search, freeze, replay, durable commits, final commit
    # The tuner pins the Python coordinator, in both packages.
    for launch_reports in (a, b):
        s0 = events(launch_reports, "start")[0][0]
        assert s0["server"] == s0["expected_server"] == \
            "CoordinatorServer", s0
    for r in (0, 1):
        assert len(finals[r]) == 1 and len(helds[r]) == 1, (finals, helds)
        assert all(math.isfinite(e["loss"]) for e in steps_a[r])
        assert events(a, "start")[r][0]["restored"] is None
        assert events(a, "start")[r][0]["hold"], "A must start searching"
    frozen_at = helds[0][0]["frozen_at"]
    assert frozen_at is not None and frozen_at == helds[1][0]["frozen_at"]
    final_id = finals[0][0]["id"]
    assert final_id is not None and finals[1][0]["id"] == final_id, finals
    durable_ids = [e["durable_id"] for e in steps_a[0]
                   if e["durable_id"] is not None]
    assert durable_ids and final_id == durable_ids[-1] + 1, \
        (durable_ids, final_id)
    # --- launch B: the profile without a search, A's final commit back
    for r in (0, 1):
        s0 = starts_b[r][0]
        assert s0["restored"] == final_id, (s0, final_id)
        assert s0["sha"] == finals[r][0]["sha"] == finals[0][0]["sha"], \
            (s0["sha"], finals)
        assert s0["profile_loaded"] and not s0["hold"], s0
        assert s0["tune"]["phase"] == "frozen", s0["tune"]
        assert len(steps_b[r]) == DURABLE_RESUME_STEPS, steps_b[r]
        for e in steps_b[r]:
            assert math.isfinite(e["loss"]) and \
                e["phase"] == ["frozen", "frozen"], e
        assert events(b, "done")[r][0]["tune"]["phase"] == "frozen"
    assert starts_b[1][0]["tune"]["profile_loaded"], starts_b[1][0]["tune"]
    assert all(c["samples"] == 0 for c in
               starts_b[0][0]["tune"]["classes"].values()), starts_b[0][0]
    # --- kernels: every step ran both kernels and no plain version
    for e in steps_a[0] + steps_a[1] + steps_b[0] + steps_b[1]:
        assert e["flash"] >= 12 and e["flash_all_bodies"] == e["flash"], e
        assert e["fusion"]["pack"] == e["fusion"]["unpack"] > 0, e
        assert e["plain"] == {"pack": 0, "unpack": 0}, e

    def split(evs):
        """The first step (cold: allocations, the first pinned copies) on
        its own, then the steps that began searching, began frozen
        without replay, and replayed from start to end."""
        groups = {"first": evs[:1], "search": [], "frozen": [],
                  "replay": []}
        for e in evs[1:]:
            key = "search" if e["phase"][0] != "frozen" else \
                "replay" if all(e["replay"]) else "frozen"
            groups[key].append(e)
        return {k: {"steps": len(v),
                    "responses_per_step": [x["responses"] for x in v],
                    "uplink_frames_per_step": [x["uplink_frames"]
                                               for x in v],
                    "median_step_ms": statistics.median(
                        [x["step_ms"] for x in v]) if v else None}
                for k, v in groups.items()}

    first_step = {launch: {r: min(e["wall"] for e in runs[launch]
                                  ["reports"][r] if e["event"] == "step")
                           - runs[launch]["wall0"] for r in (0, 1)}
                  for launch in ("A", "B")}
    tune0 = [e["tune"] for e in steps_a[0]]
    frozen_tune = tune0[frozen_at]
    launched_by = " ".join(["python"] + cmd[1:11])
    row = {
        "config": "gpt2_small bf16 flash AdamW, batch 8 x 1024 per rank, "
                  "2 ranks sharing one card over gloo",
        "launched_by": launched_by,
        "rounds_per_window": events(a, "start")[0][0]["cycles_per_sample"],
        "steps_to_freeze": frozen_at + 1,
        "rounds_to_freeze": {c: v["rounds"] for c, v in
                             frozen_tune["classes"].items()},
        "samples_to_freeze": {c: v["samples"] for c, v in
                              frozen_tune["classes"].items()},
        "frozen_knobs": {c: v["knobs"] for c, v in
                         frozen_profile["classes"].items()},
        "frozen_worker_knobs": frozen_profile["worker"],
        "per_rank": {str(r): split(steps_a[r]) for r in (0, 1)},
        "durable_commits": len(durable_ids),
        "durable_ids": durable_ids,
        "d2h_ms_per_commit": {str(r): [ms for e in steps_a[r]
                                       for ms in e["d2h_ms"]]
                              for r in (0, 1)},
        "save_seconds": {str(r): {
            k: {x: v[x] for x in ("count", "sum", "min", "max")}
            for k, v in finals[r][0]["save_seconds"].items()}
            for r in (0, 1)},
        "bytes_per_checkpoint": manifests,
        "final_commit": {
            "id": final_id,
            "seconds_from_sigterm": {str(r): finals[r][0]["wall"] -
                                     runs["A"]["sigterm"] for r in (0, 1)},
            "finalize_seconds": {str(r): finals[r][0]["seconds"]
                                 for r in (0, 1)},
            "final_d2h_ms": {str(r): finals[r][0]["d2h_ms"]
                             for r in (0, 1)},
            "launcher_grace_s":
            safe_shell_exec.PREEMPTION_TERMINATION_TIME_S,
            "hook_grace_s": preemption.DEFAULT_GRACE_S},
        "restore_seconds": {str(r): starts_b[r][0]["restore_s"]
                            for r in (0, 1)},
        "resumed_step": starts_b[0][0]["step"],
        "launch_to_first_step_s": {k: {str(r): t for r, t in v.items()}
                                   for k, v in first_step.items()},
        "launcher_s": {launch: {str(r): t - runs[launch]["wall0"]
                                for r, t in runs[launch]["spawned"].items()}
                       for launch in ("A", "B")},
        "losses_b": {str(r): [e["loss"] for e in steps_b[r]]
                     for r in (0, 1)},
        "flash_per_step": sorted({e["flash"] for r in (0, 1)
                                  for e in steps_a[r] + steps_b[r]}),
        "packs_equal_unpacks_no_plain": True,
        "max_memory_allocated": {str(r): helds[r][0]["max_memory_allocated"]
                                 for r in (0, 1)},
        "sha256": finals[0][0]["sha"],
        "rank0_server": events(a, "start")[0][0]["server"],
    }
    emit("tune_durable", **row)
    every = [e for r in (0, 1) for e in steps_a[r] + steps_b[r]]
    return {"flash": sum(e["flash"] for e in every),
            "fusion": sum(e["fusion"]["pack"] + e["fusion"]["unpack"]
                          for e in every)}


SHARDED_SEED = 3          # weights and tokens of the sharded phase
SHARDED_STEPS = 3
SHARDED_TIMEOUT_S = 600
GPT_LR, BERT_LR = 1e-2, 1e-4  # the steps' defaults (optax's in JAX)
# Losses against the unsharded model on one rank, relative: step 1
# before any update (the sharded forward; bf16 reduction order), step 2
# after one (the sharded gradients through Adam's first step, about
# lr x sign(g), which turns the rounding of near-zero gradients into
# whole steps), by model; each below the gap an update from half the
# batch gives (unsharded_losses).  GPT's step 2 with the weights of
# seed 3: 1.30e-3, the reordered update 1.09e-3, the half batch 1.80e-2
# (PERF.md section 6).
STEP1_RTOL = 1e-3
STEP2_RTOL = {"gpt": 2e-3, "bert": 5e-4}


def sharded_ids(vocab_size: int) -> torch.Tensor:
    """The sharded phase's global GPT batch, BATCH x SEQ tokens."""
    g = torch.Generator().manual_seed(SHARDED_SEED)
    return torch.randint(0, vocab_size, (BATCH, SEQ), generator=g)


def gathered_sha256(model) -> str:
    """sha256 of every parameter gathered whole (name order)."""
    from torch.distributed.tensor import DTensor
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        full = p.full_tensor() if isinstance(p, DTensor) else p
        h.update(name.encode())
        h.update(full.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def flash_kernels_in(trace_path: str) -> int:
    """Flash-kernel launches in a ``stop_xla_trace`` Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("ph") == "X" and
               e.get("cat") == "kernel" and "flash_fwd" in e["name"])


def sharded_run(step, model, tokens: int) -> dict:
    """``SHARDED_STEPS`` calls of ``step()`` (each returns the loss);
    step 1 runs under ``count_collectives`` and the device trace, whose
    kernels are counted and summed by category."""
    from horovod_tpu_torch.parallel import collectives as pc
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, flash = [], [], []
    with tempfile.TemporaryDirectory() as trace_dir:
        for i in range(SHARDED_STEPS):
            fa.launches = 0
            route0 = pc.route_bytes
            t0 = time.perf_counter()
            if i == 0:
                start_xla_trace(trace_dir)
                with pc.count_collectives() as counted:
                    loss = step()
                torch.cuda.synchronize()
                trace_path = stop_xla_trace()
                traced_flash = flash_kernels_in(trace_path)
                by_name = profile_step.device_ms_by_name(trace_path)
            else:
                loss = step()
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                route = pc.route_bytes - route0
            flash.append(fa.launches)
            losses.append(float(loss))
    median = statistics.median(step_ms[1:])
    size = hvd.size()
    return {"losses": losses, "step_ms": step_ms, "median_step_ms": median,
            "median_of_steps": [2, SHARDED_STEPS],
            "tokens_per_s": tokens / (median / 1e3),
            "tokens_per_s_per_rank": tokens / size / (median / 1e3),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "collective_bytes_step1": counted.bytes,
            "collective_calls_step1": counted.calls,
            "host_route_all_gather_bytes_step1": route,
            "flash_launches_per_step": flash,
            "flash_kernels_in_step1_trace": traced_flash,
            "device_busy_ms_step1": sum(by_name.values()),
            "device_ms_by_category_step1":
            profile_step.ms_by_category(by_name),
            "sha256": gathered_sha256(model)}


def placements_of(model, *names) -> dict:
    params = dict(model.named_parameters())
    return {n: [repr(p) for p in params[n].placements] for n in names}


def sharded_worker():
    """One rank of the sharded_train phase (``--sharded-worker``): GPT-2
    small through ``make_gpt_train_step`` on ``{"fsdp": 2, "tp": 2}``,
    then BERT-base through ``make_bert_pretrain_step`` on ``{"dp": 2,
    "tp": 2}``, both at full width, bf16, flash; prints one RESULT line."""
    import gc
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.parallel import build_mesh
    hvd.init()
    out = {"rank": hvd.rank(), "backend": basics._state().backend.name}

    cfg = gpt.gpt2_small_config(dropout=0.0, attention_impl="flash")
    mesh = build_mesh({"fsdp": 2, "tp": 2})
    init_fn, step_fn, _ = training.make_gpt_train_step(
        cfg, mesh, learning_rate=GPT_LR, fsdp="fsdp")
    t0 = time.perf_counter()
    model, opt = init_fn(SHARDED_SEED)
    build_s = time.perf_counter() - t0
    ids = sharded_ids(cfg.vocab_size)

    def gpt_step():
        nonlocal model, opt
        model, opt, loss = step_fn(model, opt, ids)
        return loss

    out["gpt"] = dict(sharded_run(gpt_step, model, BATCH * SEQ),
                      build_s=build_s, mesh={"fsdp": 2, "tp": 2},
                      placements=placements_of(
                          model, "word_embeddings.weight",
                          "layers.0.attention.query.weight"))
    del model, opt, gpt_step
    gc.collect()
    torch.cuda.empty_cache()

    bcfg = bert.bert_base_config(hidden_dropout=0.0, attention_dropout=0.0,
                                 attention_impl="flash")
    mesh = build_mesh({"dp": 2, "tp": 2})
    make_step, _ = training.make_bert_pretrain_step(
        bcfg, mesh, learning_rate=BERT_LR)
    batch = training.make_bert_batch(BERT_BATCH, BERT_SEQ, bcfg.vocab_size,
                                     seed=SHARDED_SEED)
    init_fn, bert_step_fn = make_step(batch)
    t0 = time.perf_counter()
    state = init_fn(SHARDED_SEED, batch)
    build_s = time.perf_counter() - t0

    def bert_step():
        nonlocal state
        state, loss = bert_step_fn(state, batch)
        return loss

    out["bert"] = dict(sharded_run(bert_step, state.model,
                                   BERT_BATCH * BERT_SEQ),
                       build_s=build_s, mesh={"dp": 2, "tp": 2},
                       placements=placements_of(
                           state.model, "encoder.word_embeddings.weight",
                           "encoder.layers.0.attention.query.weight"))
    hvd.shutdown()
    print("RESULT " + json.dumps(out), flush=True)


def unsharded_losses() -> dict:
    """Each sharded model unsharded on this one rank, from the same seed
    and batch, with the optimizer its sharded step uses: the loss at
    step 1 (before any update) and at step 2 (after one update).  Two
    more step-2 losses bracket the gate: after an update from the first
    half of the batch alone (what a step that drops the gradient's
    reduction over the batch axis takes), and after an update from the
    whole batch's gradient summed over its two halves (the same
    gradient in another order: the rounding a correct sharded step may
    show)."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import bert
    gcfg = gpt.gpt2_small_config(dropout=0.0, attention_impl="flash")
    ids = sharded_ids(gcfg.vocab_size).cuda()
    bcfg = bert.bert_base_config(hidden_dropout=0.0, attention_dropout=0.0,
                                 attention_impl="flash")
    batch = {k: v.cuda() for k, v in training.make_bert_batch(
        BERT_BATCH, BERT_SEQ, bcfg.vocab_size, seed=SHARDED_SEED).items()}

    def gpt_loss(model, rows):
        return gpt.lm_loss(model(ids[rows]), ids[rows])

    def bert_loss(model, rows):
        return bert.mlm_loss(
            model(batch["input_ids"][rows], deterministic=True),
            batch["labels"][rows], batch["mask"][rows])

    # (name, model, optimizer, loss, batch rows, a half's share of the
    # whole batch's loss: of its tokens, or of its masked tokens)
    runs = (("gpt",
             lambda: gpt.GPTLMHeadModel(gcfg, seed=SHARDED_SEED).eval(),
             lambda ps: torch.optim.Adam(ps, lr=GPT_LR), gpt_loss, BATCH,
             lambda rows: 0.5),
            ("bert", lambda: bert.BertForMaskedLM(bcfg, seed=SHARDED_SEED),
             lambda ps: torch.optim.AdamW(ps, lr=BERT_LR, weight_decay=0.01),
             bert_loss, BERT_BATCH,
             lambda rows: (batch["mask"][rows].sum() /
                           batch["mask"].sum()).item()))
    every = slice(None)
    out = {}
    for name, build, optimizer, loss_of, n, share in runs:
        first, second = slice(n // 2), slice(n // 2, None)
        row = {}
        for prefix, parts in (("", [(every, 1.0)]),
                              ("half_batch_", [(first, 1.0)]),
                              ("reordered_", [(first, share(first)),
                                              (second, share(second))])):
            model = build()
            opt = optimizer(model.parameters())
            for rows, weight in parts:
                loss = loss_of(model, rows)
                (loss * weight).backward()
            opt.step()
            if not prefix:
                row["step1_loss"] = loss.item()
            with torch.no_grad():
                row[prefix + "step2_loss"] = loss_of(model, every).item()
            del model, opt, loss
            torch.cuda.empty_cache()
        out[name] = row
    return out


def phase_sharded_train() -> dict:
    """GPT-2 small (fsdp x tp) and BERT-base (dp x tp) sharded over four
    ranks on this card: one launch, ``-np 4 -H localhost:4``, of this
    script's ``--sharded-worker``; the ranks share the card, so CUDA
    tensors cross over gloo.  Fails unless every rank exits 0, the
    losses are finite and fall, the gathered parameters hash alike on
    every rank, the flash kernel ran on every layer, GPT's embedding is
    replicated over tp and BERT's sharded, and each model's losses at
    steps 1 and 2 equal the unsharded model's (:func:`unsharded_losses`)
    within ``STEP1_RTOL`` and ``STEP2_RTOL``."""
    t0 = time.perf_counter()
    reference = unsharded_losses()
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "-np", "4", "-H", "localhost:4", sys.executable,
           os.path.abspath(__file__), "--sharded-worker"]
    proc, lines, reader = start_launcher(cmd, env)
    try:
        proc.wait(timeout=SHARDED_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        kill_tree(proc.pid)
        proc.wait()
    reader.join(timeout=30)
    out = "".join(lines)
    results = result_lines(out)
    if proc.returncode != 0 or sorted(results) != [0, 1, 2, 3]:
        print(out[-20000:], flush=True)
        raise RuntimeError(f"sharded_train: the launcher exited "
                           f"{proc.returncode} with RESULT lines of ranks "
                           f"{sorted(results)}")
    rows = {m: [results[r][m] for r in range(4)] for m in ("gpt", "bert")}
    gaps = {}
    for model_name, ref in reference.items():
        got = rows[model_name][0]["losses"]
        gaps[model_name] = {
            "step1_rel_diff": abs(got[0] - ref["step1_loss"]) /
            abs(ref["step1_loss"]),
            "step2_rel_diff": abs(got[1] - ref["step2_loss"]) /
            abs(ref["step2_loss"]),
            **{f"{k}_step2_rel_diff":
               abs(ref[f"{k}_step2_loss"] - ref["step2_loss"]) /
               abs(ref["step2_loss"]) for k in ("half_batch", "reordered")}}
    for model_name, label in (("gpt", "gpt2_small fsdp2 x tp2"),
                              ("bert", "bert_base dp2 x tp2")):
        per_rank = rows[model_name]
        r0 = per_rank[0]
        emit("sharded_train", model=label, ranks=4,
             backend=results[0]["backend"],
             batch=BATCH if model_name == "gpt" else BERT_BATCH,
             seq=SEQ if model_name == "gpt" else BERT_SEQ,
             steps=SHARDED_STEPS, losses=r0["losses"],
             median_step_ms={str(i): r["median_step_ms"]
                             for i, r in enumerate(per_rank)},
             step_ms_rank0=r0["step_ms"],
             median_of_steps=r0["median_of_steps"],
             tokens_per_s_rank0=r0["tokens_per_s"],
             tokens_per_s_per_rank=r0["tokens_per_s_per_rank"],
             max_memory_allocated={str(i): r["max_memory_allocated"]
                                   for i, r in enumerate(per_rank)},
             placements=r0["placements"],
             collective_bytes_per_step=r0["collective_bytes_step1"],
             collective_calls_per_step=r0["collective_calls_step1"],
             host_route_all_gather_bytes_per_step=r0[
                 "host_route_all_gather_bytes_step1"],
             flash_launches_per_step_per_rank=r0["flash_launches_per_step"],
             flash_kernels_in_trace=r0["flash_kernels_in_step1_trace"],
             traced_step1={"wall_ms": r0["step_ms"][0],
                           "device_busy_ms": r0["device_busy_ms_step1"],
                           "device_ms_by_category":
                           r0["device_ms_by_category_step1"]},
             build_s={str(i): r["build_s"] for i, r in enumerate(per_rank)},
             sha256=r0["sha256"],
             unsharded=reference[model_name], **gaps[model_name])
    for model_name, per_rank in rows.items():
        for r in per_rank:
            assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
            assert r["losses"][-1] < r["losses"][0], r["losses"]
            assert all(n == 12 for n in r["flash_launches_per_step"]), \
                r["flash_launches_per_step"]
            assert r["flash_kernels_in_step1_trace"] == 12, r
        hashes = {r["sha256"] for r in per_rank}
        assert len(hashes) == 1, f"{model_name}: parameters differ {hashes}"
        assert len({tuple(r["losses"]) for r in per_rank}) == 1, per_rank
    gpt_emb = rows["gpt"][0]["placements"]["word_embeddings.weight"]
    bert_emb = rows["bert"][0]["placements"][
        "encoder.word_embeddings.weight"]
    assert gpt_emb[1] == "Replicate()", gpt_emb
    assert bert_emb[1] == "Shard(dim=0)", bert_emb
    for model_name, gap in gaps.items():
        assert gap["step1_rel_diff"] <= STEP1_RTOL, (model_name, gap)
        assert gap["step2_rel_diff"] <= STEP2_RTOL[model_name], \
            (model_name, gap)
        # The gate would see a dropped batch-axis reduction.
        assert gap["half_batch_step2_rel_diff"] > STEP2_RTOL[model_name], \
            (model_name, gap)
    emit("sharded_train_phase", seconds=time.perf_counter() - t0)
    return {"flash": sum(sum(r["flash_launches_per_step"])
                         for rows_ in rows.values() for r in rows_),
            "fusion": 0}


# ---------------------------------------------------------------------------
# resnet50: the reference's synthetic benchmark
# ---------------------------------------------------------------------------

RESNET_SEED = 7            # weights (rank 0's) and images of the phase
RESNET_BATCH = 32          # images per rank, 224x224, 1000 classes
RESNET_WARMUP = 2          # warm-up batches, then iterations of batches
RESNET_ITERS, RESNET_BATCHES = 3, 5
RESNET_LR = 0.01           # times the world size, as the reference scales
RESNET_TIMEOUT_S = 600
# Step-1 losses against the one-rank computation of each rank's half
# (relative): the same weights and images, so only the convolution
# algorithms' order of summation can differ.
RESNET_STEP1_RTOL = 1e-3
# Step-2 losses, after one averaged SGD update, against the one-rank
# oracle: above the reordered gradient's gap, below the gap of an update
# that missed a rank's half (resnet_oracle).
RESNET_STEP2_RTOL = 1e-3
SYNC_BN_SHAPE = (RESNET_BATCH, 64, 112, 112)  # ResNet-50's first BN input
# SyncBatchNorm against nn.BatchNorm2d on the two halves concatenated,
# fp32, each error relative to the largest value compared: float64
# moments against cuDNN's fp32 sums over 802,816 values per channel.
SYNC_BN_RTOL = 1e-4


def resnet50_model(seed: int):
    from horovod_tpu_torch.models import resnet
    return resnet.ResNet50(num_classes=1000, seed=seed).train()


def resnet_batch(rank: int) -> tuple:
    """Rank ``rank``'s synthetic batch, as the reference makes it (random
    images, random labels), drawn on the card from a seed."""
    g = torch.Generator(device="cuda").manual_seed(RESNET_SEED * 100 + rank)
    data = torch.randn(RESNET_BATCH, 3, 224, 224, device="cuda", generator=g)
    target = torch.randint(0, 1000, (RESNET_BATCH,), device="cuda",
                           generator=g)
    return data, target


def resnet50_gradient_shapes():
    """(name, shape) of ResNet-50's 161 trainable tensors, in the order
    their gradients become ready (the reverse of registration)."""
    from horovod_tpu_torch.models import resnet
    model = resnet.ResNet50(num_classes=1000, device="meta")
    return [(name, tuple(p.shape))
            for name, p in model.named_parameters()][::-1]


def params_sha256(model) -> str:
    digest = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        digest.update(name.encode())
        digest.update(p.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def resnet_benchmark() -> dict:
    """The reference's pytorch_synthetic_benchmark.py on the port's
    ResNet50 in this process's world (``hvd.init()`` already called):
    bf16 compute, ``SGD(lr=0.01 x size)`` inside
    ``hvd.DistributedOptimizer``, ``broadcast_parameters`` of the state
    dict from rank 0 (each rank starts from its own seed), the same
    batch every step; ``RESNET_WARMUP`` batches, then ``RESNET_ITERS``
    iterations of ``RESNET_BATCHES``.  img/s of an iteration is
    ``batch x batches / its time`` (each step ends in a synchronize)."""
    rank, size = hvd.rank(), hvd.size()
    model = resnet50_model(RESNET_SEED + rank)
    opt = torch.optim.SGD(model.parameters(), lr=RESNET_LR * size)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    data, target = resnet_batch(rank)
    backend = basics._state().backend
    stats = getattr(backend, "stats", {})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.launches.update({k: 0 for k in fb.launches})
    fb.plain_calls.update({k: 0 for k in fb.plain_calls})
    stats.update({k: 0 for k in stats})
    collective_s0 = collective_seconds()
    losses, step_ms = [], []
    for _ in range(RESNET_WARMUP + RESNET_ITERS * RESNET_BATCHES):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    steps = len(step_ms)
    timed = step_ms[RESNET_WARMUP:]
    img_s = [RESNET_BATCH * RESNET_BATCHES /
             (sum(timed[i:i + RESNET_BATCHES]) / 1e3)
             for i in range(0, len(timed), RESNET_BATCHES)]
    return {"rank": rank, "size": size, "backend": backend.name,
            "losses": losses, "step_ms": step_ms,
            "median_step_ms": statistics.median(timed),
            "img_s_per_iter": img_s,
            "img_s": statistics.mean(img_s),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "fused_responses_per_step":
            stats.get("flat_allreduces", 0) / steps,
            "fused_bytes_per_step": stats.get("allreduce_bytes", 0) / steps,
            "collective_ms_per_step":
            (collective_seconds() - collective_s0) / steps * 1e3,
            "fusion": dict(fb.launches),
            "fusion_plain_calls": dict(fb.plain_calls),
            "params_sha256": params_sha256(model)}


def sync_bn_check() -> dict:
    """``hvd.SyncBatchNorm(64)`` on this rank's fp32 half of a
    ``[2 x 32, 64, 112, 112]`` batch against ``nn.BatchNorm2d`` on the
    whole batch, on this rank: output and input gradient (this rank's
    half), weight and bias gradients (summed over the ranks), running
    mean and variance; the errors relative to the largest reference
    value."""
    size, rank = hvd.size(), hvd.rank()
    halves = []
    for r in range(size):
        g = torch.Generator(device="cuda").manual_seed(300 + r)
        halves.append((torch.randn(SYNC_BN_SHAPE, device="cuda",
                                   generator=g) * (r + 1) + r,
                       torch.randn(SYNC_BN_SHAPE, device="cuda",
                                   generator=g)))
    c = SYNC_BN_SHAPE[1]
    sync = hvd.SyncBatchNorm(c).cuda()
    ref = torch.nn.BatchNorm2d(c).cuda()
    for bn in (sync, ref):
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, c))
            bn.bias.copy_(torch.linspace(-1.0, 1.0, c))
    x = halves[rank][0].clone().requires_grad_()
    y = sync(x)
    y.backward(halves[rank][1])
    dw = hvd.allreduce(sync.weight.grad, op=hvd.Sum, name="sync_bn.dw")
    db = hvd.allreduce(sync.bias.grad, op=hvd.Sum, name="sync_bn.db")
    xr = torch.cat([h[0] for h in halves]).requires_grad_()
    yr = ref(xr)
    yr.backward(torch.cat([h[1] for h in halves]))
    rows = slice(rank * SYNC_BN_SHAPE[0], (rank + 1) * SYNC_BN_SHAPE[0])

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errors = {"output": rel(y, yr[rows]),
              "input_grad": rel(x.grad, xr.grad[rows]),
              "weight_grad": rel(dw, ref.weight.grad),
              "bias_grad": rel(db, ref.bias.grad),
              "running_mean": rel(sync.running_mean, ref.running_mean),
              "running_var": rel(sync.running_var, ref.running_var)}
    del halves, x, y, xr, yr
    torch.cuda.empty_cache()
    return errors


def resnet_worker():
    """One rank of the resnet50 phase (``--resnet-worker``), started by
    the launcher: the benchmark, then the SyncBatchNorm check; prints one
    RESULT line."""
    hvd.init()
    out = resnet_benchmark()
    out["server"] = server_of_rank0()
    out["sync_bn"] = sync_bn_check()
    hvd.shutdown()
    print("RESULT " + json.dumps(out), flush=True)


def resnet_oracle() -> dict:
    """Each rank's step-1 and step-2 losses computed on one rank: the
    step-1 loss of each half on rank 0's initial weights, and the step-2
    loss of each half after one SGD step (lr 0.01 x 2) on the two halves'
    gradients averaged.  Two more step-2 losses bracket the gate: after
    the same average of gradients computed again, in the other order
    (the rounding a correct two-rank step may show: cuDNN's backward
    does not fix its order of summation), and after an update from rank
    0's half alone (what a step whose allreduce drops a rank gives)."""
    model = resnet50_model(RESNET_SEED)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [resnet_batch(r) for r in range(2)]

    def loss_of(r):
        return F.cross_entropy(model(batches[r][0]), batches[r][1])

    def grads_of(order):
        out = {}
        for r in order:
            model.zero_grad()
            loss = loss_of(r)
            loss.backward()
            out[r] = ([p.grad.clone() for p in model.parameters()],
                      loss.item())
        return out

    def step2_losses(update):
        model.load_state_dict(start)
        with torch.no_grad():
            for p, u in zip(model.parameters(), update):
                p.sub_(RESNET_LR * 2 * u)
            return [loss_of(r).item() for r in range(2)]

    first = grads_of((0, 1))
    again = grads_of((1, 0))
    avg = [(a + b) * 0.5 for a, b in zip(first[0][0], first[1][0])]
    reordered = [b * 0.5 + a * 0.5 for a, b in zip(again[0][0],
                                                     again[1][0])]
    out = {"step1": [first[r][1] for r in range(2)],
           "step2": step2_losses(avg),
           "reordered_step2": step2_losses(reordered),
           "half_step2": step2_losses(first[0][0])}
    del model, start, batches, first, again, avg, reordered
    torch.cuda.empty_cache()
    return out


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def phase_resnet50() -> dict:
    """ResNet-50 on synthetic 224x224 images (the reference's headline
    benchmark): a world of one in this process, then two ranks on this
    card launched by the port's launcher (``-np 2 -H localhost:2``,
    gloo, ``HOROVOD_TPU_NATIVE=1``), each with its own 32 images.  The
    two-rank losses at step 1 and step 2 are held against
    :func:`resnet_oracle`; the ranks' parameters hash alike; every
    fused response is packed and unpacked by the fusion kernel; the
    launch also holds ``SyncBatchNorm`` against ``nn.BatchNorm2d``."""
    t0 = time.perf_counter()
    oracle = resnet_oracle()
    hvd.init()
    one = resnet_benchmark()
    hvd.shutdown()
    emit("resnet50_world1", model="ResNet50 bf16, 224x224, 1000 classes",
         batch=RESNET_BATCH, **{k: v for k, v in one.items()
                                if k not in ("fusion", "fusion_plain_calls")})
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_TPU_NATIVE="1")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "-np", "2", "-H", "localhost:2", sys.executable,
           os.path.abspath(__file__), "--resnet-worker"]
    results = launch_results(cmd, env, 2, RESNET_TIMEOUT_S, "resnet50")
    gaps = {
        "step1": [rel_gap(r["losses"][0], oracle["step1"][r["rank"]])
                  for r in results],
        "step2": [rel_gap(r["losses"][1], oracle["step2"][r["rank"]])
                  for r in results],
        "reordered_step2": [rel_gap(oracle["reordered_step2"][r],
                                    oracle["step2"][r]) for r in range(2)],
        "half_step2": [rel_gap(oracle["half_step2"][r],
                               oracle["step2"][r]) for r in range(2)]}
    emit("resnet50", model="ResNet50 bf16, 224x224, 1000 classes",
         ranks=2, backend=results[0]["backend"],
         server=results[0]["server"], batch_per_rank=RESNET_BATCH,
         warmup=RESNET_WARMUP, iterations=RESNET_ITERS,
         batches_per_iteration=RESNET_BATCHES,
         img_s_per_rank=[r["img_s"] for r in results],
         img_s_total=sum(r["img_s"] for r in results),
         img_s_per_iter={r["rank"]: r["img_s_per_iter"] for r in results},
         img_s_world1=one["img_s"],
         median_step_ms=[r["median_step_ms"] for r in results],
         median_step_ms_world1=one["median_step_ms"],
         max_memory_allocated=[r["max_memory_allocated"] for r in results],
         max_memory_allocated_world1=one["max_memory_allocated"],
         fused_responses_per_step=results[0]["fused_responses_per_step"],
         fused_bytes_per_step=results[0]["fused_bytes_per_step"],
         collective_ms_per_step=[r["collective_ms_per_step"]
                                 for r in results],
         fusion_launches={r["rank"]: r["fusion"] for r in results},
         losses={r["rank"]: r["losses"] for r in results},
         oracle=oracle, rel_gaps=gaps, step2_rtol=RESNET_STEP2_RTOL,
         params_sha256=[r["params_sha256"] for r in results],
         sync_bn={r["rank"]: r["sync_bn"] for r in results},
         sync_bn_rtol=SYNC_BN_RTOL, seconds=time.perf_counter() - t0)
    assert one["size"] == 1 and all(math.isfinite(x) for x in one["losses"])
    for r in results:
        assert r["backend"] == "gloo", r["backend"]
        assert r["server"] == "NativeCoordinatorServer", r["server"]
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        assert r["fusion"]["pack"] > 0 and r["fusion"]["unpack"] > 0, r
        assert r["fusion_plain_calls"] == {"pack": 0, "unpack": 0}, r
        assert all(e <= SYNC_BN_RTOL for e in r["sync_bn"].values()), \
            r["sync_bn"]
    assert all(g <= RESNET_STEP1_RTOL for g in gaps["step1"]), gaps
    assert all(g <= RESNET_STEP2_RTOL for g in gaps["step2"]), gaps
    # The gate would see an update that missed a rank's gradient.
    assert all(g > RESNET_STEP2_RTOL for g in gaps["half_step2"]), gaps
    assert len({r["params_sha256"] for r in results}) == 1, \
        "parameters differ between the ranks"
    return {"flash": 0, "fusion": sum(r["fusion"]["pack"] +
                                      r["fusion"]["unpack"]
                                      for r in results)}


def launch_results(cmd, env, ranks: int, timeout: float, phase: str
                   ) -> list:
    """Run a launcher command to its end (killed past ``timeout``) and
    return its workers' RESULT lines in rank order; raises unless it
    exits 0 with one line per rank."""
    proc, lines, reader = start_launcher(cmd, env)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        kill_tree(proc.pid)
        proc.wait()
    reader.join(timeout=30)
    out = "".join(lines)
    results = result_lines(out)
    if proc.returncode != 0 or sorted(results) != list(range(ranks)):
        print(out[-20000:], flush=True)
        raise RuntimeError(f"{phase}: the launcher exited "
                           f"{proc.returncode} with RESULT lines of ranks "
                           f"{sorted(results)}")
    return [results[r] for r in range(ranks)]


# ---------------------------------------------------------------------------
# context_parallel: ring and Ulysses attention, the two dry runs
# ---------------------------------------------------------------------------

CP_SEQ, CP_HEADS, CP_DIM = 2048, 12, 64   # per rank: GPT-2 small's heads
CP_RANKS = 4
CP_REPS = 3                 # fwd+bwd calls per case; the median of 2..3
CP_TIMEOUT_S = 600
# Outputs and q/k/v gradients against reference_attention on the whole
# sequence, each error relative to the largest reference value: fp32
# (scores, softmax and products in another order), bf16 (one rounding of
# the output or gradient to bf16 apart).
CP_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}
PMOE_MICROBATCHES, PMOE_TOKENS, PMOE_DIM = 4, 1024, 768
# The pipeline-MoE step's fp32 loss and gradients against the sequential
# model on one rank in fp64, relative to the largest value: above the
# same model's own fp32 error (its gradients sum thousands of terms of
# both signs), below a step that drops the experts' cotangents from the
# ep peer (pmoe_oracle).
PMOE_RTOL = 1e-3


def cp_inputs(dtype):
    """Whole q, k, v and the output cotangent, [1, 4 x 2048, 12, 64], on
    the card from a seed (the same on every rank)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    shape = (1, CP_RANKS * CP_SEQ, CP_HEADS, CP_DIM)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
               for _ in range(3))
    return q, k, v, torch.randn(shape, device="cuda", generator=g)


def attention_fwd_bwd(fn, q, k, v, c):
    """``fn(q, k, v)`` and the gradients of ``sum(out * c)``."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    (out.float() * c).sum().backward()
    return out.detach(), q.grad, k.grad, v.grad


def pmoe_oracle(Ws, gate_w, expert_W, x, dtype):
    """The pipeline-MoE step on one rank in ``dtype``: the stages composed
    in order; each ep rank routes its own tokens (here the same ones)
    through its own copy of the stage and gate kernels with
    ``top1_dispatch`` at the step's capacity, the experts shared.
    Returns the loss, autograd's gradients of the copies' summed losses
    (those of copy 0 for the kernels), and the experts' gradient of copy
    0's loss alone: what a step whose all-to-all backward dropped the
    peers' cotangents would give."""
    from horovod_tpu_torch.parallel.moe import top1_dispatch
    Ws, gate_w, expert_W, x = (t.to(dtype) for t in (Ws, gate_w, expert_W,
                                                     x))
    S, E = gate_w.shape[0], gate_w.shape[-1]
    capacity = max(1, int(4.0 * x.shape[1] / E))
    copies = [(Ws.clone().requires_grad_(), gate_w.clone().requires_grad_())
              for _ in range(E)]
    experts = expert_W.clone().requires_grad_()
    losses = []
    for W_e, g_e in copies:
        h = x
        for s in range(S):
            h = torch.tanh(h @ W_e[s])
            ys = []
            for m in range(h.shape[0]):
                d, comb, _ = top1_dispatch(h[m] @ g_e[s], capacity)
                buckets = torch.einsum("tec,td->ecd", d.to(dtype), h[m])
                out = torch.stack([torch.tanh(buckets[j] @ experts[s, j])
                                   for j in range(E)])
                ys.append(torch.einsum("tec,ecd->td", comb.to(dtype), out))
            h = h + torch.stack(ys)
        losses.append(torch.mean(h ** 2))
    grads = torch.autograd.grad(sum(losses), (copies[0][0], copies[0][1],
                                              experts), retain_graph=True)
    one_copy = torch.autograd.grad(losses[0], experts)[0]
    return (sum(losses) / E).detach(), grads, one_copy


def cp_worker():
    """One rank of the context_parallel phase (``--cp-worker``): ring and
    Ulysses attention on ``{"sp": 4}``, causal and not, fp32 and bf16,
    forward and backward through ``shard_map``, rank 0 holding each
    against ``reference_attention`` on the whole sequence; then the two
    dry runs at full width, rank 0 holding the pipeline-MoE step against
    its sequential oracle in fp64.  Prints one RESULT line."""
    import torch.distributed as dist
    from horovod_tpu_torch import training
    from horovod_tpu_torch.parallel import (build_mesh, collectives,
                                            reference_attention,
                                            ring_attention, shard_map,
                                            ulysses_attention)
    from horovod_tpu_torch.parallel.mesh import P
    hvd.init()
    rank = hvd.rank()
    out = {"rank": rank, "backend": basics._state().backend.name,
           "cases": {}}
    mesh = build_mesh({"sp": CP_RANKS})
    torch.cuda.reset_peak_memory_stats()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for causal in (False, True):
            q, k, v, c = cp_inputs(dtype)
            got = {}
            for fn in (ring_attention, ulysses_attention):
                name = f"{fn.__name__}_{dname}_" + \
                    ("causal" if causal else "full")
                run = shard_map(
                    lambda a, b, cc, fn=fn: fn(a, b, cc, axis_name="sp",
                                               causal=causal),
                    mesh, P(None, "sp"), P(None, "sp"))
                ms = []
                for i in range(CP_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if i == 0:
                        with collectives.count_collectives() as counted:
                            res = attention_fwd_bwd(run, q, k, v, c)
                    else:
                        res = attention_fwd_bwd(run, q, k, v, c)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                got[name] = res
                out["cases"][name] = {
                    "step_ms": ms, "median_ms": statistics.median(ms[1:]),
                    "collective_bytes": counted.bytes,
                    "collective_calls": counted.calls}
            if rank == 0:
                want = attention_fwd_bwd(
                    lambda a, b, cc: reference_attention(a, b, cc,
                                                         causal=causal),
                    q, k, v, c)
                for name, res in got.items():
                    out["cases"][name]["rel_err"] = {
                        part: ((g.float() - w.float()).abs().max() /
                               w.float().abs().max()).item()
                        for part, g, w in zip(("out", "dq", "dk", "dv"),
                                              res, want)}
                del want
            del got, res, q, k, v, c
            torch.cuda.empty_cache()
            dist.barrier()
    out["attention_max_memory_allocated"] = torch.cuda.max_memory_allocated()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    training.run_ring_attention_dry_run(CP_RANKS, seq_per_dev=CP_SEQ,
                                        heads=CP_HEADS, dim=CP_DIM)
    torch.cuda.synchronize()
    out["ring_dry_run_ms"] = (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, pmesh = training.run_pipeline_moe_dry_run(
        CP_RANKS, microbatches=PMOE_MICROBATCHES, tokens=PMOE_TOKENS,
        dim=PMOE_DIM)
    torch.cuda.synchronize()
    out["pmoe_dry_run_ms"] = (time.perf_counter() - t0) * 1e3
    out["pmoe_mesh"] = dict(zip(pmesh.mesh_dim_names, pmesh.mesh.shape))
    axes = training.factor_mesh_axes(CP_RANKS, names=("pp", "ep", "dp"))
    args = [torch.from_numpy(a).cuda() for a in training.pipeline_moe_inputs(
        axes, PMOE_MICROBATCHES, PMOE_TOKENS, PMOE_DIM)]
    step = training.make_pipeline_moe_step(pmesh)
    with collectives.count_collectives() as counted:
        step_loss, grads = step(*args)
    torch.cuda.synchronize()
    out["pmoe_loss"] = loss
    out["pmoe_step_loss"] = step_loss.item()
    out["pmoe_collective_bytes"] = counted.bytes
    out["pmoe_collective_calls"] = counted.calls
    out["pmoe_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        def rel(a, b):
            return ((a.double() - b).abs().max() / b.abs().max()).item()

        names = ("dWs", "dgate", "dexpert")
        want_loss, want, one_copy = pmoe_oracle(*args, torch.float64)
        fp32_loss, fp32, _ = pmoe_oracle(*args, torch.float32)
        out["pmoe_oracle_loss"] = want_loss.item()
        out["pmoe_rel_err"] = {n: rel(g, w)
                               for n, g, w in zip(names, grads, want)}
        out["pmoe_rel_err"]["loss"] = rel_gap(loss, want_loss.item())
        # The floor: the same model in fp32 on one rank, against fp64.
        out["pmoe_fp32_oracle_rel_err"] = {
            n: rel(g, w) for n, g, w in zip(names, fp32, want)}
        out["pmoe_fp32_oracle_rel_err"]["loss"] = rel_gap(
            fp32_loss.item(), want_loss.item())
        out["pmoe_fault_rel_err"] = rel(one_copy, want[2])
    hvd.shutdown()
    print("RESULT " + json.dumps(out), flush=True)


def phase_context_parallel() -> dict:
    """Ring and Ulysses attention at GPT-2 small's attention widths (12
    heads of 64) over four ranks on this card, one launch (``-np 4 -H
    localhost:4``, gloo) of this script's ``--cp-worker``: q, k and v of
    ``[1, 2048, 12, 64]`` per rank (8192 tokens in all), causal and not,
    fp32 and bf16, outputs and q/k/v gradients held against
    ``reference_attention`` on the whole sequence within ``CP_RTOL``;
    ``run_ring_attention_dry_run`` at that width NaN-free;
    ``run_pipeline_moe_dry_run(4, 4, 1024, 768)`` on ``{pp: 2, ep: 2,
    dp: 1}`` held against its sequential oracle (fp64) within
    ``PMOE_RTOL``."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "-np", str(CP_RANKS), "-H", f"localhost:{CP_RANKS}",
           sys.executable, os.path.abspath(__file__), "--cp-worker"]
    results = launch_results(cmd, env, CP_RANKS, CP_TIMEOUT_S,
                             "context_parallel")
    r0 = results[0]
    emit("context_parallel", ranks=CP_RANKS, backend=r0["backend"],
         per_rank_shape=[1, CP_SEQ, CP_HEADS, CP_DIM],
         global_seq=CP_RANKS * CP_SEQ,
         cases={name: {**case, "median_ms_by_rank":
                       [r["cases"][name]["median_ms"] for r in results]}
                for name, case in r0["cases"].items()},
         rtol=CP_RTOL,
         attention_max_memory_allocated=[
             r["attention_max_memory_allocated"] for r in results],
         ring_dry_run_ms=[r["ring_dry_run_ms"] for r in results],
         pipeline_moe={
             "mesh": r0["pmoe_mesh"], "microbatches": PMOE_MICROBATCHES,
             "tokens": PMOE_TOKENS, "dim": PMOE_DIM,
             "loss": r0["pmoe_loss"], "oracle_loss": r0["pmoe_oracle_loss"],
             "rel_err": r0["pmoe_rel_err"], "rtol": PMOE_RTOL,
             "fp32_oracle_rel_err": r0["pmoe_fp32_oracle_rel_err"],
             "fault_rel_err": r0["pmoe_fault_rel_err"],
             "dry_run_ms": [r["pmoe_dry_run_ms"] for r in results],
             "collective_bytes": r0["pmoe_collective_bytes"],
             "collective_calls": r0["pmoe_collective_calls"],
             "max_memory_allocated": [r["pmoe_max_memory_allocated"]
                                      for r in results]},
         seconds=time.perf_counter() - t0)
    for name, case in r0["cases"].items():
        tol = CP_RTOL[name.split("_")[2]]
        assert all(e <= tol for e in case["rel_err"].values()), (name, case)
    assert r0["pmoe_mesh"] == {"pp": 2, "ep": 2, "dp": 1}, r0["pmoe_mesh"]
    assert all(e <= PMOE_RTOL for e in r0["pmoe_rel_err"].values()), \
        r0["pmoe_rel_err"]
    # The gate would see the experts' gradient of one ep rank alone.
    assert r0["pmoe_fault_rel_err"] > PMOE_RTOL, r0["pmoe_fault_rel_err"]
    for r in results:
        assert r["backend"] == "gloo", r["backend"]
        assert math.isfinite(r["pmoe_loss"]) and \
            r["pmoe_loss"] == r0["pmoe_loss"] == r["pmoe_step_loss"], r
    return {"flash": 0, "fusion": 0}


# ---------------------------------------------------------------------------
# dlrm_serve: DLRM-tiny trained at two ranks while a replica serves its
# commits
# ---------------------------------------------------------------------------

DLRM_SEED = 11            # the dense weights (both ranks and the oracle)
DLRM_BATCH = 32           # examples per rank and step (bench.py's lanes)
DLRM_STEPS = 24
DLRM_CKPT_EVERY = 5       # a durable commit every 5 steps: base, deltas
DLRM_LR = 0.05            # SGD on the dense part and the tables
DLRM_QPS = 50.0           # HOROVOD_BENCH_SERVE_QPS's default (bench.py)
DLRM_QUERY_IDS = 16       # Zipf ids per query, as bench.py's serve lane
DLRM_TIMEOUT_S = 600


def dlrm_setup(rank: int, size: int):
    """DLRM-tiny at its published config: the dense part (on the card,
    the same weights from ``DLRM_SEED`` on every rank) and its two
    65536 x 16 tables, row-sharded over ``size`` ranks on the card, each
    pooled by a mean bag."""
    from horovod_tpu_torch.models import dlrm
    from horovod_tpu_torch.sparse import EmbeddingBag, ShardedEmbedding
    cfg = dlrm.dlrm_tiny_config()
    model = dlrm.DLRMDense(cfg, seed=DLRM_SEED)
    tables = [ShardedEmbedding("dlrm.t%d" % i, rows, cfg.embed_dim,
                               rank=rank, size=size, seed=7 + i)
              for i, rows in enumerate(cfg.table_rows)]
    return cfg, model, tables, [EmbeddingBag(t, mode="mean")
                                for t in tables]


def dlrm_draws() -> dict:
    """sha256 (hex) of each seeded draw of the phase, made on the host as
    the phase makes it: rank 0's first batch (numpy's ``zipf`` ids, then
    the rest of the batch), the dense part's truncated-normal init
    (``models/gpt.py:_init_rng``, numpy's legacy ``RandomState``) and
    the splitmix64 rows of rank 0's shard of
    table 0.  ``tests/test_torch_port_dlrm.py`` holds each against the
    same draw on the CPU."""
    import numpy as np
    from horovod_tpu_torch.models import dlrm
    from horovod_tpu_torch.sparse import ShardedEmbedding
    cfg = dlrm.dlrm_tiny_config()
    dense, ids, offsets, labels = dlrm.synthetic_click_batch(
        np.random.default_rng([0, 1]), DLRM_BATCH, cfg)
    model = dlrm.DLRMDense(cfg, device="cpu", seed=DLRM_SEED)
    table = ShardedEmbedding("dlrm.t0", cfg.table_rows[0], cfg.embed_dim,
                             rank=0, size=2, seed=7, device="cpu")

    def sha(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    return {"zipf_ids": sha(*ids), "batch_rest": sha(dense, offsets, labels),
            "trunc_normal_init": sha(*(v.numpy() for v in
                                       model.state_dict().values())),
            "splitmix64_rows": sha(table.local.numpy()),
            "numpy": np.__version__, "torch": torch.__version__}


def dlrm_forward(cfg, model, bags, rank: int, step: int):
    """Rank ``rank``'s batch of ``step`` (bench.py's seeding): pooled
    embeddings, loss, and the gradients of the dense parameters (one flat
    fp32 tensor) and of the pooled embeddings."""
    import numpy as np
    from horovod_tpu_torch.models import dlrm
    dense, ids, offsets, labels = dlrm.synthetic_click_batch(
        np.random.default_rng([rank, step]), DLRM_BATCH, cfg)
    emb = torch.cat([bag.forward(ids[i], offsets)
                     for i, bag in enumerate(bags)], dim=1)
    emb.requires_grad_()
    model.zero_grad()
    loss = dlrm.bce_logits_loss(
        model(torch.from_numpy(dense).cuda(), emb),
        torch.from_numpy(labels).cuda())
    loss.backward()
    flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    return loss.detach(), flat, emb.grad, (ids, offsets)


def dlrm_dense_update(model, flat_grad):
    with torch.no_grad():
        for p, g in zip(model.parameters(), flat_grad.split(
                [p.numel() for p in model.parameters()])):
            p -= DLRM_LR * g.view_as(p)


def dlrm_sparse_update(cfg, bags, emb_grad):
    """SGD on the tables through the bags' backward (the gradient
    exchange of their last lookups)."""
    for i, bag in enumerate(bags):
        bag.backward(emb_grad[:, i * cfg.embed_dim:(i + 1) * cfg.embed_dim],
                     lr=DLRM_LR)


def sparse_bytes() -> dict:
    from horovod_tpu_torch.common import metrics
    c = metrics.snapshot()["counters"].get(
        "hvd_sparse_alltoall_bytes_total", {})
    return {s: c.get("stage=" + s, 0.0) for s in ("ids", "rows", "grads")}


def dlrm_worker():
    """One rank of the dlrm_serve phase (``--dlrm-worker``), started by
    the launcher: ``DLRM_STEPS`` steps of DLRM-tiny, the dense gradients
    averaged by ``hvd.allreduce(..., op=Average, name="dlrm.densegrad")``
    (packed by the fusion kernel), the tables updated through the
    alltoall exchange; every ``DLRM_CKPT_EVERY`` steps a durable commit
    (a base, then touched-row deltas) through ``CheckpointManager`` and
    ``KVCommitCoordinator`` on the launcher's KV.  Saves its final
    parameters, shards and losses to ``DLRM_OUT/rank<r>.pt`` and prints
    one RESULT line."""
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.runner.elastic.worker import \
        kv_commit_coordinator
    hvd.init()
    rank, size = hvd.rank(), hvd.size()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, tables, bags = dlrm_setup(rank, size)
    coord = kv_commit_coordinator()
    mgr = CheckpointManager(os.environ["DLRM_CKPT_DIR"], rank=rank,
                            world_size=size, coordinator=coord, keep=None)
    fb.launches.update({k: 0 for k in fb.launches})
    fb.plain_calls.update({k: 0 for k in fb.plain_calls})
    bytes0 = sparse_bytes()
    losses, step_ms, save_ms, commits = [], [], [], []
    for step in range(1, DLRM_STEPS + 1):
        t0 = time.perf_counter()
        loss, flat, emb_grad, _ = dlrm_forward(cfg, model, bags, rank, step)
        dlrm_dense_update(model, hvd.allreduce(flat, op=hvd.Average,
                                               name="dlrm.densegrad"))
        dlrm_sparse_update(cfg, bags, emb_grad)
        losses.append(loss.item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step % DLRM_CKPT_EVERY:
            continue
        plan = mgr.delta_plan()
        local, snaps = {}, []
        for t in tables:
            snaps.append(t.snapshot_touched())
            local.update(t.durable_items(full=plan is None))
        dense = {"dense/" + k: v.cpu().numpy()
                 for k, v in model.state_dict().items()}
        t0 = time.perf_counter()
        mgr.save(step, dense, local_items=local, delta_of=plan)
        deadline = time.monotonic() + 120
        while (coord.committed_step() or -1) < step:
            if time.monotonic() > deadline:
                raise RuntimeError(f"step {step}: commit not visible")
            time.sleep(0.01)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        for t, snap in zip(tables, snaps):
            t.clear_touched(None if plan is None else snap)
        commits.append({"step": step, "t": time.time(),
                        "kind": "base" if plan is None else "delta"})
    mgr.close()
    moved = sparse_bytes()
    fusion, plain = dict(fb.launches), dict(fb.plain_calls)
    torch.save({"losses": losses,
                "dense": {k: v.cpu() for k, v in model.state_dict().items()},
                "tables": {t.name: t.local.cpu() for t in tables}},
               os.path.join(os.environ["DLRM_OUT"], f"rank{rank}.pt"))
    out = {"rank": rank, "backend": basics._state().backend.name,
           "server": server_of_rank0(), "losses": losses,
           "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "steps_per_s": 1e3 / statistics.median(step_ms),
           "alltoall_bytes_per_step": {
               s: (moved[s] - bytes0[s]) / DLRM_STEPS for s in moved},
           "save_ms": save_ms, "commits": commits,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "fusion": fusion, "fusion_plain_calls": plain}
    hvd.shutdown()
    print("RESULT " + json.dumps(out), flush=True)


def dlrm_oracle(fault: bool = False) -> dict:
    """The two-rank run in one process on this card: each rank's half
    computed on its own, the dense gradients averaged as the allreduce
    averages them (the sum of the two, times 0.5), the tables (unsharded)
    updated by rank 0's, then rank 1's gradients, the owners' order.
    With ``fault``, rank 1's dense gradient is dropped (a half-batch
    step): what the gate must tell apart."""
    cfg, model, tables, bags = dlrm_setup(0, 1)
    losses = {0: [], 1: []}
    for step in range(1, DLRM_STEPS + 1):
        halves = [dlrm_forward(cfg, model, bags, r, step) for r in (0, 1)]
        for r, (loss, *_) in enumerate(halves):
            losses[r].append(loss.item())
        dlrm_dense_update(model, halves[0][1] if fault else
                          (halves[0][1] + halves[1][1]) * 0.5)
        for _, _, emb_grad, (ids, offsets) in halves:
            for i, bag in enumerate(bags):
                bag.forward(ids[i], offsets)     # the backward's routing
            dlrm_sparse_update(cfg, bags, emb_grad)
    return {"losses": losses,
            "dense": {k: v.cpu() for k, v in model.state_dict().items()},
            "tables": {t.name: t.local.cpu() for t in tables}}


def max_abs_gap(got: dict, want: dict) -> float:
    return max((got[k].float() - want[k].float()).abs().max().item()
               for k in want)


def signed_post(url: str, path: str, payload: dict, secret: str):
    body = json.dumps(payload).encode()
    ts = repr(time.time())
    req = urllib.request.Request(url + path, data=body, headers={
        job_secret.TS_HEADER: ts,
        job_secret.HEADER: job_secret.sign(secret, "POST", path, body, ts)})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read().decode())


def serve_queries(plane, proc, secret: str) -> list:
    """Zipf lookup and mean-bag queries at ``DLRM_QPS`` over the plane's
    signed HTTP endpoint, alternating ops and tables, until the trainer
    (``proc``) exits.  Returns one record per answered query."""
    import numpy as np
    from horovod_tpu_torch.common import metrics
    url = f"http://127.0.0.1:{plane.port}"
    rng = np.random.default_rng(17)
    records = []
    period = 1.0 / DLRM_QPS
    begin = time.perf_counter()
    while proc.poll() is None:
        now = time.perf_counter()
        due = begin + len(records) * period
        if now < due:
            time.sleep(due - now)
        n = len(records)
        table = "dlrm.t%d" % (n // 2 % 2)
        ids = ((rng.zipf(1.3, size=DLRM_QUERY_IDS) - 1) % 65536).tolist()
        query = {"table": table, "ids": ids}
        if n % 2:
            query.update(offsets=list(range(0, DLRM_QUERY_IDS, 2)),
                         mode="mean")
        t0 = time.perf_counter()
        got = signed_post(url, "/lookup", query, secret)
        ms = (time.perf_counter() - t0) * 1e3
        # Behind by steps (the newest commit the tail has seen less the
        # served one) and by seconds (since the tail first saw it behind).
        served, latest = plane.replica.freshness()
        lag_s = metrics.snapshot()["gauges"].get(
            "hvd_serve_freshness_seconds")
        records.append({"op": "bag" if n % 2 else "lookup", "ms": ms,
                        "t": time.perf_counter() - begin, "query": query,
                        "step": got["step"], "rows": got["rows"],
                        "lag_steps": max((latest or served) - served, 0),
                        "lag_s": float(lag_s or 0.0)})
    return records


def served_mismatches(cdir: str, records: list) -> int:
    """How many answers differ from the committed rows at their stamped
    step, read back from the checkpoint directory (a bag pooled as
    ``np.add.at`` pools, in float32)."""
    import numpy as np
    from horovod_tpu_torch.checkpoint import CheckpointManager, assemble_table
    ro = CheckpointManager(cdir, rank=0, world_size=1, keep=None)
    tables, bad = {}, 0
    for rec in records:
        q = rec["query"]
        key = (rec["step"], q["table"])
        if key not in tables:
            tables[key] = assemble_table(ro.restore(rec["step"]),
                                         "sparse/%s/rows" % q["table"])
        rows = tables[key][np.asarray(q["ids"])]
        if "offsets" in q:
            offsets = np.asarray(q["offsets"])
            sizes = np.diff(np.concatenate([offsets, [len(q["ids"])]]))
            pooled = np.zeros((len(offsets), rows.shape[1]), np.float32)
            np.add.at(pooled, np.repeat(np.arange(len(offsets)), sizes),
                      rows)
            pooled /= np.maximum(sizes, 1)[:, None]
            rows = pooled
        bad += not np.array_equal(np.asarray(rec["rows"], np.float32), rows)
    ro.close()
    return bad


def percentiles(xs) -> dict:
    import numpy as np
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))} if xs else None


def phase_dlrm_serve() -> dict:
    """DLRM-tiny (two 65536 x 16 tables, published widths, nothing cut)
    trained at two ranks on this card, launched by the port's launcher
    (``-np 2 -H localhost:2`` of ``--dlrm-worker``, gloo, native
    coordinator) with a durable commit every ``DLRM_CKPT_EVERY`` steps,
    while this process serves the commits: ``serve.start`` on the card
    (tail thread, HTTP under a job secret) answering Zipf lookup and bag
    queries at ``DLRM_QPS``.  Gates: each rank's losses and its final
    dense parameters and table shards equal :func:`dlrm_oracle`'s
    exactly; every answer equals the committed rows at its stamped step;
    the replica ends on the last commit after one bootstrap and one delta
    flip per later commit."""
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.checkpoint import CheckpointNotFoundError
    from horovod_tpu_torch.common import metrics
    t0 = time.perf_counter()
    oracle = dlrm_oracle()
    fault = dlrm_oracle(fault=True)
    fault_gap = max_abs_gap(fault["dense"], oracle["dense"])
    secret = job_secret.make_secret_key()
    poll0 = os.environ.get("HOROVOD_SERVE_POLL_SECONDS")
    # Tail often: the phase measures freshness, not the poll period.
    os.environ["HOROVOD_SERVE_POLL_SECONDS"] = "0.05"
    flips = metrics.REGISTRY.counter("hvd_serve_snapshot_flips_total")
    flips0 = {k: flips.value(kind=k) for k in ("bootstrap", "delta",
                                               "rebase")}
    plane = None
    with tempfile.TemporaryDirectory() as d:
        cdir = os.path.join(d, "ckpt")
        env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_TPU_NATIVE="1",
                   DLRM_CKPT_DIR=cdir, DLRM_OUT=d)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", "2", "-H", "localhost:2", sys.executable,
               os.path.abspath(__file__), "--dlrm-worker"]
        proc, lines, reader = start_launcher(cmd, env)
        try:
            torch.cuda.reset_peak_memory_stats()
            allocated0 = torch.cuda.memory_allocated()
            deadline = time.monotonic() + DLRM_TIMEOUT_S
            while plane is None:
                try:
                    plane = serve.start(cdir, secret=secret)
                except CheckpointNotFoundError:
                    if proc.poll() is not None or \
                            time.monotonic() > deadline:
                        reader.join(timeout=30)
                        print("".join(lines)[-20000:], flush=True)
                        raise
                    time.sleep(0.05)
            bootstrap_step = plane.replica.freshness()[0]
            t_serve = time.perf_counter()
            records = serve_queries(plane, proc, secret)
            serve_s = time.perf_counter() - t_serve
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            reader.join(timeout=30)
            out = "".join(lines)
            results = result_lines(out)
            if proc.returncode != 0 or sorted(results) != [0, 1]:
                print(out[-20000:], flush=True)
                raise RuntimeError(f"dlrm_serve: the launcher exited "
                                   f"{proc.returncode} with RESULT lines "
                                   f"of ranks {sorted(results)}")
            results = [results[r] for r in (0, 1)]
            last = results[0]["commits"][-1]["step"]
            end = time.monotonic() + 30
            while plane.replica.freshness()[0] < last and \
                    time.monotonic() < end:
                time.sleep(0.01)
            final_step = plane.replica.freshness()[0]
            replica_memory = torch.cuda.max_memory_allocated() - allocated0
        finally:
            if plane is not None:
                plane.stop()
            if proc.poll() is None:
                kill_tree(proc.pid)
                proc.wait()
            if poll0 is None:
                os.environ.pop("HOROVOD_SERVE_POLL_SECONDS", None)
            else:
                os.environ["HOROVOD_SERVE_POLL_SECONDS"] = poll0
        mismatches = served_mismatches(cdir, records)
        nbytes = {c["step"]: sum(int(e["nbytes"]) for e in read_manifest(
            step_dir(cdir, c["step"])).shards) for c in results[0]["commits"]}
        final = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in (0, 1)]
    flipped = {k: flips.value(kind=k) - flips0[k] for k in flips0}
    commits = results[0]["commits"]
    later = [c for c in commits if c["step"] > bootstrap_step]
    gaps = {r: {"losses": max(abs(a - b) for a, b in zip(
        final[r]["losses"], oracle["losses"][r])),
        "dense": max_abs_gap(final[r]["dense"], oracle["dense"]),
        "tables": max((final[r]["tables"][n] - oracle["tables"][n][r::2])
                      .abs().max().item() for n in oracle["tables"])}
        for r in (0, 1)}
    emit("dlrm_serve", model="DLRM-tiny: 2 tables of 65536 x 16 fp32, "
         "2 ids per table, mean bags, bottom (32, 16), top (32, 16, 1)",
         ranks=2, backend=results[0]["backend"],
         server=results[0]["server"], batch_per_rank=DLRM_BATCH,
         steps=DLRM_STEPS, lr=DLRM_LR,
         median_step_ms=[r["median_step_ms"] for r in results],
         steps_per_s=[r["steps_per_s"] for r in results],
         alltoall_bytes_per_step=[r["alltoall_bytes_per_step"]
                                  for r in results],
         save_ms={r["rank"]: r["save_ms"] for r in results},
         commits=[{"step": c["step"], "kind": c["kind"],
                   "bytes": nbytes[c["step"]]} for c in commits],
         queries=len(records), target_qps=DLRM_QPS,
         achieved_qps=len(records) / serve_s if serve_s else 0.0,
         read_ms={op: percentiles([q["ms"] for q in records
                                   if q["op"] == op])
                  for op in ("lookup", "bag")},
         freshness_steps=percentiles([q["lag_steps"] for q in records]),
         freshness_seconds=percentiles([q["lag_s"] for q in records]),
         served_steps=sorted({q["step"] for q in records}),
         served_mismatches=mismatches, bootstrap_step=bootstrap_step,
         final_step=final_step, flips=flipped,
         max_memory_allocated=[r["max_memory_allocated"] for r in results],
         replica_max_memory_allocated=replica_memory,
         fusion_launches={r["rank"]: r["fusion"] for r in results},
         losses={r["rank"]: r["losses"] for r in results},
         oracle_gaps=gaps, half_batch_fault_gap=fault_gap,
         draws=dlrm_draws(), seconds=time.perf_counter() - t0)
    for r in results:
        assert r["backend"] == "gloo", r["backend"]
        assert r["server"] == "NativeCoordinatorServer", r["server"]
        assert r["fusion"]["pack"] > 0 and r["fusion"]["unpack"] > 0, r
        assert r["fusion_plain_calls"] == {"pack": 0, "unpack": 0}, r
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
    # Gate 1: the two-rank run is the oracle's, bit for bit; the fault
    # shows what the gate would see.
    assert all(v == 0.0 for g in gaps.values() for v in g.values()), gaps
    assert fault_gap > 0.0, fault_gap
    # Gate 2: every answer is the committed value at its stamped step.
    assert records and mismatches == 0, (mismatches, len(records))
    # Gate 3: no torn or skipped flip; the replica ends on the last commit.
    assert final_step == last, (final_step, last)
    assert flipped == {"bootstrap": 1, "delta": len(later), "rebase": 0}, \
        (flipped, bootstrap_step, commits)
    assert [c["kind"] for c in commits] == \
        ["base"] + ["delta"] * (len(commits) - 1), commits
    return {"flash": 0, "fusion": sum(r["fusion"]["pack"] +
                                      r["fusion"]["unpack"]
                                      for r in results)}


SPARK_SEED = 0             # rows, teacher, model and the estimator's seed
SPARK_ROWS = 8192          # training rows (images [1, 28, 28] fp32)
SPARK_HELDOUT = 256        # rows for the fitted model's predictions
SPARK_BATCH = 128          # rows per rank and step
SPARK_LR, SPARK_MOMENTUM = 0.05, 0.9
SPARK_PARTS = 4            # partitions per process
SPARK_EPOCHS = (2, 3)      # fit, then resume to
SPARK_TIMEOUT_S = 600
# Gates: each between the rounding floor of a replay on one card (the
# convolutions' reductions run in another order) and the fault of
# rank 1's batch left out of the average (PERF.md section 6).
SPARK_LOSS_ATOL = 1e-4
SPARK_PARAM_ATOL = 1e-4
SPARK_PRED_ATOL = 1e-3
# The loss must fall: epoch 2's mean loss at least this far below epoch
# 0's on each rank, between a net that never steps (its drop is the
# batches' spread) and the measured fit (PERF.md section 6).
SPARK_LOSS_DROP = 0.01


class CountedTrainer:
    """Runs an estimator's trainer on one rank and reports, beside its
    result, where the net's parameters ended up, the fusion kernel's
    launches and plain calls in this process, and its peak device
    memory."""

    def __init__(self, trainer):
        self.trainer = trainer

    def __call__(self, *args):
        result = self.trainer(*args)
        return result, {
            "device": str(next(self.trainer.model.parameters()).device),
            "fusion": dict(fb.launches),
            "fusion_plain_calls": dict(fb.plain_calls),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


class CountingBackend(LocalBackend):
    """A ``LocalBackend`` that runs each trainer inside ``CountedTrainer``
    and keeps every rank's result and report."""

    def run(self, fn, args=(), extra_env=None):
        self.started = time.perf_counter()
        out = super().run(CountedTrainer(fn), args, extra_env)
        self.results = [r for r, _ in out]
        self.reports = [rep for _, rep in out]
        return self.results


def spark_data():
    """Synthetic rows of the reference's MNIST estimator example: images
    ``[1, 28, 28]`` in [0, 1) and one-hot labels of a fixed random linear
    teacher, the first ``SPARK_ROWS`` to train on, the rest held out."""
    import numpy as np
    rng = np.random.RandomState(SPARK_SEED)
    n = SPARK_ROWS + SPARK_HELDOUT
    images = rng.rand(n, 1, 28, 28).astype(np.float32)
    teacher = rng.standard_normal((28 * 28, 10)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[
        ((images.reshape(n, -1) - 0.5) @ teacher).argmax(1)]
    return images, labels


def spark_oracle(init_state, store, meta, fault: bool = False,
                 lr: float = SPARK_LR) -> dict:
    """The two-rank fit replayed in this process on the card, for all
    ``SPARK_EPOCHS[-1]`` epochs without a break: each step takes both
    ranks' batches as ``util.stream_batches`` gives them to the ranks,
    averages the two gradients (their sum times 0.5) and steps the same
    optimizer.  With ``fault``, rank 1's gradient is left out; with
    ``lr=0`` the net never moves."""
    import itertools
    from horovod_tpu_torch.models.mnist import MnistCNN
    from horovod_tpu_torch.spark import util
    net = MnistCNN(device="cuda", seed=SPARK_SEED)
    net.load_state_dict(init_state)
    opt = torch.optim.SGD(net.parameters(), lr=lr,
                          momentum=SPARK_MOMENTUM)
    loss_fn = torch.nn.CrossEntropyLoss()
    steps = util.sync_steps_per_epoch(meta, "train", 2, SPARK_BATCH,
                                      ceil=True, store=store, col="image")
    losses, states = {0: [], 1: []}, []
    for epoch in range(SPARK_EPOCHS[-1]):
        batches = [itertools.islice(util.stream_batches(
            store, "train", r, 2, ["image", "label"], SPARK_BATCH,
            seed=SPARK_SEED + epoch, drop_remainder=False), steps)
            for r in (0, 1)]
        sums = [0.0, 0.0]
        for pair in zip(*batches):
            grads = []
            for r, (x, y) in enumerate(pair):
                net.zero_grad()
                loss = loss_fn(net(torch.as_tensor(x).cuda()).squeeze(-1),
                               torch.as_tensor(y).cuda())
                loss.backward()
                sums[r] += float(loss.detach())
                grads.append([p.grad.clone() for p in net.parameters()])
            for p, g0, g1 in zip(net.parameters(), *grads):
                p.grad = g0 if fault else (g0 + g1) * 0.5
            opt.step()
        for r in (0, 1):
            losses[r].append(sums[r] / steps)
        states.append({k: v.cpu().clone()
                       for k, v in net.state_dict().items()})
    return {"losses": losses, "states": states, "net": net}


def phase_spark_estimator() -> dict:
    """The Estimator API on the card: ``TorchEstimator`` fits the port's
    ``MnistCNN`` (full widths) to ``SPARK_ROWS`` synthetic rows in a
    ``FilesystemStore`` at two ranks on ``LocalBackend`` (both on this
    card, gloo), ``SGD(0.05, momentum 0.9)``, batch 128 per rank, for two
    epochs; a copy with ``epochs=3`` resumes from the Store's checkpoint.
    Gates: both ranks trained on the card, the resume starts at epoch 2,
    every per-epoch loss and the parameters after each fit equal
    :func:`spark_oracle`'s within ``SPARK_LOSS_ATOL``/``SPARK_PARAM_ATOL``
    (the fault lies far outside), each rank's loss falls by
    ``SPARK_LOSS_DROP`` from epoch 0 to 2 (a net that never steps does
    not), the fitted model's predictions on the
    card equal the oracle's forward, and each rank's gradients went
    through the fusion kernel, as many packs as unpacks, no plain call."""
    import copy
    import numpy as np
    from horovod_tpu_torch.models.mnist import MnistCNN
    from horovod_tpu_torch.spark import FilesystemStore, util
    from horovod_tpu_torch.spark.estimator import checkpoint_epoch
    from horovod_tpu_torch.spark.torch import TorchEstimator
    t0 = time.perf_counter()
    import pandas
    images, labels = spark_data()
    frame = pandas.DataFrame({"image": list(images[:SPARK_ROWS]),
                              "label": list(labels[:SPARK_ROWS])})
    net = MnistCNN(device="cpu", seed=SPARK_SEED)
    init_state = copy.deepcopy(net.state_dict())
    backend = CountingBackend(2, verbose=1, timeout=SPARK_TIMEOUT_S)
    fits = []
    with tempfile.TemporaryDirectory() as d:
        store = FilesystemStore(os.path.join(d, "store"))
        est = TorchEstimator(
            model=net, optimizer=torch.optim.SGD(
                net.parameters(), lr=SPARK_LR, momentum=SPARK_MOMENTUM),
            loss=torch.nn.CrossEntropyLoss(), feature_cols=["image"],
            label_cols=["label"], store=store, backend=backend,
            epochs=SPARK_EPOCHS[0], batch_size=SPARK_BATCH,
            partitions_per_process=SPARK_PARTS, run_id="spark_estimator",
            seed=SPARK_SEED, verbose=1)
        for epochs in SPARK_EPOCHS:
            t = time.perf_counter()
            if not fits:
                model = est.fit(frame)
                prepare_s = backend.started - t
            else:
                model = est.copy({"epochs": epochs}).fit_on_prepared_data()
            fits.append({"seconds": time.perf_counter() - t,
                         "model": model, "results": backend.results,
                         # The driver's net, which the next fit reloads.
                         "state": {k: v.cpu().clone() for k, v in
                                   model.getModel().state_dict().items()},
                         "reports": backend.reports,
                         "checkpoint_epoch": checkpoint_epoch(
                             store, "spark_estimator")})
        store_bytes = sum(
            os.path.getsize(os.path.join(root, f))
            for root, _, files in os.walk(store.get_train_data_path())
            for f in files)
        meta = util.read_metadata(store)
        steps = util.sync_steps_per_epoch(meta, "train", 2, SPARK_BATCH,
                                          ceil=True)
        oracle = spark_oracle(init_state, store, meta)
        fault = spark_oracle(init_state, store, meta, fault=True)
        frozen = spark_oracle(init_state, store, meta, lr=0.0)
    fitted = fits[-1]["model"]
    held = images[SPARK_ROWS:]
    out = fitted.transform(pandas.DataFrame({"image": list(held)}))
    pred = np.asarray(out["label__output"].tolist())
    with torch.no_grad():
        want = oracle["net"](torch.from_numpy(held).cuda()).cpu().numpy()
    pred_gap = float(np.abs(pred - want).max())
    accuracy = float((pred.argmax(1) ==
                      labels[SPARK_ROWS:].argmax(1)).mean())
    histories = {r: fits[0]["results"][r]["history"] +
                 fits[1]["results"][r]["history"] for r in (0, 1)}
    gaps = {"losses": max(abs(a - b) for r in (0, 1) for a, b in zip(
        histories[r], oracle["losses"][r])),
        "params_fit": max_abs_gap(fits[0]["state"],
                                  oracle["states"][SPARK_EPOCHS[0] - 1]),
        "params_resumed": max_abs_gap(fits[1]["state"],
                                      oracle["states"][-1])}
    fault_gap = max_abs_gap(fault["states"][-1], oracle["states"][-1])
    drops = {"fit": min(h[0] - h[-1] for h in histories.values()),
             "frozen_net": max(abs(h[0] - h[-1])
                               for h in frozen["losses"].values())}
    emit("spark_estimator",
         model="MnistCNN: conv 32, conv 64, pool, dense 128, dense 10, "
         "fp32", rows=SPARK_ROWS, ranks=2, backend="LocalBackend",
         batch_per_rank=SPARK_BATCH, partitions=2 * SPARK_PARTS,
         prepare_s=prepare_s, store_bytes=store_bytes,
         fit_seconds=[f["seconds"] for f in fits],
         start_epochs=[f["model"].start_epoch for f in fits],
         checkpoint_epochs=[f["checkpoint_epoch"] for f in fits],
         steps_per_epoch=steps, losses=histories,
         oracle_losses=oracle["losses"],
         devices=[[rep["device"] for rep in f["reports"]] for f in fits],
         fusion_launches=[[rep["fusion"] for rep in f["reports"]]
                          for f in fits],
         fusion_plain_calls=[[rep["fusion_plain_calls"]
                              for rep in f["reports"]] for f in fits],
         max_memory_allocated=[[rep["max_memory_allocated"]
                                for rep in f["reports"]] for f in fits],
         oracle_gaps=gaps, rank1_left_out_fault_gap=fault_gap,
         loss_drops=drops,
         prediction_gap=pred_gap, heldout_accuracy=accuracy,
         seconds=time.perf_counter() - t0)
    for f in fits:
        for rep in f["reports"]:
            assert rep["device"].startswith("cuda"), rep
            assert rep["fusion"]["pack"] > 0, rep
            assert rep["fusion"]["pack"] == rep["fusion"]["unpack"], rep
            # A plain call takes a CPU tensor only: here the two
            # broadcasts of broadcast_optimizer_state's pickled state
            # (its length, then its bytes).
            assert rep["fusion_plain_calls"] == {"pack": 2, "unpack": 2}, \
                rep
    assert [f["model"].start_epoch for f in fits] == [0, SPARK_EPOCHS[0]]
    assert [f["checkpoint_epoch"] for f in fits] == \
        [e - 1 for e in SPARK_EPOCHS]
    assert all(math.isfinite(x) for h in histories.values() for x in h)
    assert gaps["losses"] <= SPARK_LOSS_ATOL, gaps
    assert drops["fit"] >= SPARK_LOSS_DROP > drops["frozen_net"], drops
    assert max(gaps["params_fit"], gaps["params_resumed"]) <= \
        SPARK_PARAM_ATOL, gaps
    assert fault_gap > 10 * SPARK_PARAM_ATOL, fault_gap
    assert pred.shape == (SPARK_HELDOUT, 10) and pred_gap <= SPARK_PRED_ATOL
    return {"flash": 0, "fusion": sum(
        rep["fusion"]["pack"] + rep["fusion"]["unpack"]
        for f in fits for rep in f["reports"])}


# ---------------------------------------------------------------------------
# examples: the user's entry points (the examples and the `horovod` alias)
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(REPO, "horovod_tpu_torch", "examples")
ADASUM_STEPS = 3            # BERT-large steps; the median leaves step 0 out
ADASUM_LR = 1e-4            # the example's default, AdamW(weight_decay=1e-4)
# The parameters after the last step against the one-process oracle's
# (max abs): above the gap between the oracle's last merge with its
# dot products in fp32 (as the runtime takes them for fp32 deltas) and
# in fp64, below the gap of a last merge that averaged the deltas.
ADASUM_PARAM_ATOL = 1e-6
EXAMPLES_TIMEOUT_S = 600
BENCH_EXAMPLE_BATCH = 32

# An upstream Horovod script, word for word what a user of upstream
# writes, plus the checks: it must reach the port through the alias.
ALIAS_SCRIPT = """
import json, sys
import torch
import horovod.torch as hvd

hvd.init()
import horovod_tpu_torch.torch
x = torch.arange(8, dtype=torch.float32, device="cuda") * (hvd.rank() + 1)
y = hvd.allreduce(x, op=hvd.Sum, name="alias.x")
want = torch.arange(8, dtype=torch.float32, device="cuda") * 3
print("RESULT " + json.dumps({
    "rank": hvd.rank(), "size": hvd.size(),
    "alias_is_port": hvd is horovod_tpu_torch.torch,
    "horovod_file": sys.modules["horovod"].__file__,
    "jax_loaded": sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                "optax", "horovod_tpu")),
    "device": str(y.device), "exact": bool(torch.equal(y, want)),
    "result": y.tolist()}), flush=True)
"""


def launch_example(args, np_: int, cwd: str, phase: str) -> str:
    """``python -m horovod_tpu_torch.runner.launch -np N -H localhost:N
    python <args>`` from ``cwd``, with this checkout on ``PYTHONPATH`` (so
    the repository root, whose ``horovod/`` is the JAX package's alias,
    is on the workers' path too); returns the launcher's output and
    raises unless it exits 0 within ``EXAMPLES_TIMEOUT_S``."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "-np", str(np_), "-H", f"localhost:{np_}", sys.executable] + args
    proc, lines, reader = start_launcher(
        cmd, dict(os.environ, PYTHONPATH=REPO), cwd)
    try:
        proc.wait(timeout=EXAMPLES_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        kill_tree(proc.pid)
        proc.wait()
    reader.join(timeout=30)
    out = "".join(lines)
    if proc.returncode != 0:
        print(out[-20000:], flush=True)
        raise RuntimeError(f"{phase}: the launcher exited {proc.returncode}")
    return out


def rank_stdout(out: str, rank: int) -> list:
    """Rank ``rank``'s standard output lines, the prefix stripped."""
    tag = f"[{rank}]<stdout>:"
    return [line[len(tag):] for line in out.splitlines()
            if line.startswith(tag)]


def adasum_oracle(model_state: dict) -> dict:
    """The example's run in one process: from the weights every rank
    broadcast (``BertForMaskedLM(bert_large_config(attention_impl=
    "flash"), seed=0)``), each rank's local AdamW step on its own batch
    (``make_bert_batch`` seeded by rank), with its own AdamW state, then
    the two deltas of every tensor merged by the plain Adasum formula
    (``ops/adasum.py``'s ``merge``, one segment, fp32 dot products as
    the runtime takes them for fp32 deltas), ``ADASUM_STEPS`` times.
    Returns the losses, the gap to ``model_state`` (rank 0's final
    parameters), and the two gaps that bracket the gate: the last merge
    with fp64 dot products (rounding), and the last merge's deltas
    averaged (the fault)."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.ops import adasum
    cfg = bert.bert_large_config(attention_impl="flash")
    model = bert.BertForMaskedLM(cfg, seed=0)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    batches = [{k: v.cuda() for k, v in training.make_bert_batch(
        ADASUM_BATCH, ADASUM_SEQ, cfg.vocab_size, seed=r).items()}
        for r in range(2)]
    opts = [torch.optim.AdamW(params, lr=ADASUM_LR, weight_decay=1e-4)
            for _ in range(2)]

    def merged(d0, d1, acc):
        n = d0.numel()
        return adasum.merge(d0.reshape(-1), d1.reshape(-1), [(0, n)],
                            acc).view_as(d0)

    losses = {0: [], 1: []}
    gaps = {"rounding": 0.0, "fault": 0.0}
    for step in range(ADASUM_STEPS):
        start = [p.detach().clone() for p in params]
        deltas = [[], []]
        for r in range(2):
            with torch.no_grad():
                for p, s0 in zip(params, start):
                    p.copy_(s0)
            opts[r].zero_grad()
            b = batches[r]
            loss = bert.mlm_loss(model(b["input_ids"], deterministic=True),
                                 b["labels"], b["mask"])
            loss.backward()
            losses[r].append(loss.item())
            opts[r].step()
            deltas[r] = [p.detach() - s0 for p, s0 in zip(params, start)]
        last = step == ADASUM_STEPS - 1
        with torch.no_grad():
            for p, s0, d0, d1 in zip(params, start, *deltas):
                new = s0 + merged(d0, d1, torch.float32)
                if last:
                    exact = s0 + merged(d0, d1, torch.float64)
                    fault = s0 + (d0 + d1) * 0.5
                    gaps["rounding"] = max(gaps["rounding"], (
                        new - exact).abs().max().item())
                    gaps["fault"] = max(gaps["fault"], (
                        new - fault).abs().max().item())
                p.copy_(new)
        del start, deltas
    gap = max((model_state[n].cuda() - p.detach()).abs().max().item()
              for n, p in zip(names, params))
    out = {"losses": losses, "params_gap": gap, **gaps}
    del model, params, opts, batches
    torch.cuda.empty_cache()
    return out


def adasum_bert_large(tmp: str) -> dict:
    """``adasum/adasum_bert_pretrain.py`` at BERT-large's published widths
    (``bert_large_config()``: 24 layers, 1024 wide, 16 heads, vocab
    30522, bf16 compute, fp32 parameters) with the flash kernel, seq
    128, batch 8 per rank, ``ADASUM_STEPS`` steps, two ranks on this
    card; then its one-process oracle.  Returns the ``adasum_bert``
    fields."""
    report = os.path.join(tmp, "adasum_report")
    t0 = time.perf_counter()
    out = launch_example(
        [os.path.join(EXAMPLES, "adasum", "adasum_bert_pretrain.py"),
         "--steps", str(ADASUM_STEPS), "--batch-size", str(ADASUM_BATCH),
         "--seq-len", str(ADASUM_SEQ), "--lr", str(ADASUM_LR),
         "--attention", "flash", "--report", report], 2, tmp,
        "examples (adasum_bert)")
    launch_s = time.perf_counter() - t0
    reports = []
    for r in range(2):
        with open(os.path.join(report, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    state = torch.load(os.path.join(report, "params.pt"))
    t0 = time.perf_counter()
    oracle = adasum_oracle(state)
    oracle_s = time.perf_counter() - t0
    del state

    def per_step(rep, pick):
        return (pick(rep["after"]) - pick(rep["before"])) / ADASUM_STEPS

    def responses(counts):
        return sum(n for k, n in counts["collectives"].items()
                   if "op=ADASUM" in k)

    printed = rank_stdout(out, 0)
    fields = {
        "example": "horovod_tpu_torch/examples/adasum/adasum_bert_pretrain.py",
        "config": "bert_large_config(attention_impl='flash'): 24 x 1024, "
                  "16 heads, vocab 30522, bf16 compute, fp32 parameters",
        "parameters": reports[0]["parameters"], "ranks": 2,
        "backend": [rep["backend"] for rep in reports],
        "batch_per_rank": ADASUM_BATCH, "seq": ADASUM_SEQ,
        "steps": ADASUM_STEPS, "printed": printed,
        "losses": {rep["rank"]: rep["losses"] for rep in reports},
        "oracle_losses": oracle["losses"],
        "step_ms": {rep["rank"]: rep["step_ms"] for rep in reports},
        "median_step_ms": [statistics.median(rep["step_ms"][1:])
                           for rep in reports],
        "max_memory_allocated": [rep["max_memory_allocated"]
                                 for rep in reports],
        "fused_responses_per_step": [per_step(rep, responses)
                                     for rep in reports],
        "fusion_packs_per_step": [per_step(rep, lambda c: c["fusion"]["pack"])
                                  for rep in reports],
        "fusion_unpacks_per_step": [
            per_step(rep, lambda c: c["fusion"]["unpack"]) for rep in reports],
        "fusion_plain_per_step": [
            per_step(rep, lambda c: c["fusion_plain"]["pack"])
            for rep in reports],
        "flash_launches_per_step": [per_step(rep, lambda c: c["flash"])
                                    for rep in reports],
        "params_gap": oracle["params_gap"],
        "rounding_gap": oracle["rounding"], "fault_gap": oracle["fault"],
        "params_atol": ADASUM_PARAM_ATOL,
        "launch_s": launch_s, "oracle_s": oracle_s}
    counts = {"flash": sum(rep["after"]["flash"] - rep["before"]["flash"]
                           for rep in reports),
              "fusion": sum(rep["after"]["fusion"][k] -
                            rep["before"]["fusion"][k]
                            for rep in reports for k in ("pack", "unpack"))}
    return fields, counts


def phase_examples() -> dict:
    """The user's entry points on the card, each launched as a user
    launches it (``python -m horovod_tpu_torch.runner.launch -np 2 -H
    localhost:2``, two ranks on this card over gloo with host staging)
    from a temporary directory: Adasum BERT-large pretraining
    (``adasum_bert``), the PyTorch synthetic benchmark with its stand-in
    CNN (``synthetic_benchmark``), and an upstream Horovod script through
    the ``horovod`` alias (``alias``).  Gates: every launch exits 0; the
    BERT-large ranks ran on gloo, through the flash kernel (24 launches
    a step and rank) and the fusion kernel (no plain pack), with finite
    losses equal to the oracle's within 1e-3 and rank 0's parameters
    within ``ADASUM_PARAM_ATOL`` of the oracle's, between the measured
    rounding and fault gaps; the benchmark printed its img/s; the alias
    script got the port, loaded no JAX and reduced a CUDA tensor
    exactly."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        bert_fields, counts = adasum_bert_large(tmp)
        emit("adasum_bert", **bert_fields)
        out = launch_example(
            [os.path.join(EXAMPLES, "pytorch", "pytorch_synthetic_benchmark.py"),
             "--batch-size", str(BENCH_EXAMPLE_BATCH)], 2, tmp,
            "examples (synthetic_benchmark)")
        bench = rank_stdout(out, 0)
        total = re.search(r"^Total img/sec on 2 worker\(s\): ([\d.]+) "
                          r"\+-([\d.]+)$", "\n".join(bench), re.M)
        per_worker = re.search(r"^Img/sec per worker: ([\d.]+) \+-([\d.]+)$",
                               "\n".join(bench), re.M)
        iters = [float(x) for x in re.findall(
            r"^Iter #\d+: ([\d.]+) img/sec per worker$", "\n".join(bench),
            re.M)]
        emit("synthetic_benchmark",
             example="horovod_tpu_torch/examples/pytorch/"
                     "pytorch_synthetic_benchmark.py",
             model="the example's stand-in CNN (no torchvision here)",
             ranks=2, batch_per_rank=BENCH_EXAMPLE_BATCH, printed=bench,
             img_s_per_iter=iters,
             img_s_per_worker=float(per_worker.group(1)) if per_worker
             else None,
             img_s_total=float(total.group(1)) if total else None)
        assert total and per_worker and len(iters) == 3, bench
        script = os.path.join(tmp, "upstream_train.py")
        with open(script, "w") as f:
            f.write(ALIAS_SCRIPT)
        out = launch_example([script], 2, tmp, "examples (alias)")
        alias = [json.loads(line[len("RESULT "):])
                 for r in range(2) for line in rank_stdout(out, r)
                 if line.startswith("RESULT ")]
        emit("alias", script="import horovod.torch as hvd, two ranks",
             pythonpath=REPO, results=alias)
        assert len(alias) == 2, out[-4000:]
        for a in alias:
            assert a["alias_is_port"] and a["jax_loaded"] == [], a
            assert a["exact"] and a["device"].startswith("cuda"), a
            assert a["horovod_file"].endswith(
                os.path.join("_alias", "horovod", "__init__.py")), a
    b = bert_fields
    assert b["backend"] == ["gloo", "gloo"], b["backend"]
    assert len(b["printed"]) == ADASUM_STEPS and all(
        line.startswith(f"step {i} loss ")
        for i, line in enumerate(b["printed"])), b["printed"]
    for r in range(2):
        assert all(math.isfinite(x) for x in b["losses"][r]), b["losses"]
        assert max(abs(x - y) for x, y in zip(
            b["losses"][r], b["oracle_losses"][r])) <= 1e-3, \
            (b["losses"], b["oracle_losses"])
        assert b["flash_launches_per_step"][r] == 24, b
        assert b["fusion_packs_per_step"][r] > 0, b
        assert b["fusion_plain_per_step"][r] == 0, b
        assert b["fused_responses_per_step"][r] > 0, b
    assert b["rounding_gap"] <= ADASUM_PARAM_ATOL < b["fault_gap"], b
    assert b["params_gap"] <= ADASUM_PARAM_ATOL, b
    emit("examples", seconds=time.perf_counter() - t0)
    return counts


TOOLS_TIMEOUT_S = 600
STAGING_SIZES_MB = ("1", "16", "64")
# What tests/test_flight_recorder.py's real-kill test arms, so that the
# death writes dumps: a 4096-event ring, HB liveness every 0.3 s, a
# 0.6 s reconnect grace and a 4 s stall shutdown.
ELASTIC_BLACKBOX_ENV = {"HOROVOD_BLACKBOX_EVENTS": "4096",
                        "HOROVOD_LIVENESS_INTERVAL": "0.3",
                        "HOROVOD_RECONNECT_GRACE": "0.6",
                        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "4"}
PROFILE_BATCH, PROFILE_ITERS = 128, 30


def run_tool(name: str, *args, env=None) -> str:
    """``python -m horovod_tpu_torch.tools.<name> *args`` from this
    checkout; returns its standard output and raises unless it exits 0
    within ``TOOLS_TIMEOUT_S``."""
    proc = subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.tools.{name}", *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, **(env or {})),
        capture_output=True, text=True, timeout=TOOLS_TIMEOUT_S)
    if proc.returncode != 0:
        print(proc.stdout[-8000:], proc.stderr[-8000:], flush=True)
        raise RuntimeError(f"tools: {name} {' '.join(args)} exited "
                           f"{proc.returncode}")
    return proc.stdout


def last_json(out: str) -> dict:
    """The JSON object a tool printed last (``json.dumps(..., indent=1)``
    after the log lines of its run)."""
    start = out.rfind("\n{\n")
    return json.loads(out[start + 1:] if start >= 0 else out)


def get_json(url: str, secret: str):
    req = urllib.request.Request(url)
    ts = repr(time.time())
    path = "/" + url.split("://", 1)[1].split("/", 1)[1]
    req.add_header(job_secret.TS_HEADER, ts)
    req.add_header(job_secret.HEADER,
                   job_secret.sign(secret, "GET", path, b"", ts))
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())


def staging_and_readers(tmp: str) -> tuple:
    """``measure_torch_staging`` at two ranks on this card, with each
    rank's ``/metrics`` endpoint (``HOROVOD_METRICS_PORT``: base + local
    rank) under a job secret, the sampling profiler and the straggler
    observatory on (rank 0 then hosts the Python coordinator and its
    ``/status`` carries the cluster view).  While it measures, the
    readers run against the live endpoints: ``hvdtop --once`` signed and
    unsigned, and ``flame`` over both ranks' ``/profile``.  Returns the
    staging result and the readers' fields."""
    while True:
        base = free_port()
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", base + 1))
                break
            except OSError:
                continue
    secret = job_secret.make_secret_key()
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_METRICS_PORT=str(base),
               HOROVOD_SECRET_KEY=secret, HOROVOD_PROFILE="1",
               HOROVOD_STRAGGLER="1")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.tools.measure_torch_staging",
           "--sizes", *STAGING_SIZES_MB]
    proc, lines, reader = start_launcher(cmd, env)
    urls = [f"http://127.0.0.1:{base + r}" for r in range(2)]
    try:
        deadline = time.monotonic() + TOOLS_TIMEOUT_S
        while True:
            try:
                if all(get_json(u + "/profile", secret).get("collapsed")
                       for u in urls):
                    break
            except (OSError, ValueError):
                pass
            if proc.poll() is not None or time.monotonic() > deadline:
                print("".join(lines)[-8000:], flush=True)
                raise RuntimeError("tools: the staging ranks' /profile "
                                   "never had samples")
            time.sleep(0.05)
        t0 = time.perf_counter()
        signed = run_tool("hvdtop", "--once", "--url", urls[0], "--secret",
                          secret)
        unsigned = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.tools.hvdtop",
             "--once", "--url", urls[0], "--secret", ""], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=TOOLS_TIMEOUT_S)
        collapsed, svg = (os.path.join(tmp, "job.collapsed"),
                          os.path.join(tmp, "job.svg"))
        flame_out = run_tool("flame", *urls, "-o", collapsed, "--svg", svg,
                             "--secret", secret)
        readers_s = time.perf_counter() - t0
        proc.wait(timeout=TOOLS_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            kill_tree(proc.pid)
            proc.wait()
    reader.join(timeout=30)
    out = "".join(lines)
    if proc.returncode != 0:
        print(out[-8000:], flush=True)
        raise RuntimeError(f"tools: measure_torch_staging exited "
                           f"{proc.returncode}")
    stacks = open(collapsed).read().splitlines()
    readers = {
        "hvdtop_frame": signed.splitlines(),
        "hvdtop_unsigned_rc": unsigned.returncode,
        "hvdtop_unsigned_stderr": unsigned.stderr.strip()[-300:],
        "flame_printed": flame_out.splitlines(),
        "flame_stacks_by_rank": {r: sum(1 for x in stacks
                                        if x.startswith(f"rank {r};"))
                                 for r in range(2)},
        "flame_samples_by_rank": {r: sum(int(x.rsplit(" ", 1)[1])
                                         for x in stacks
                                         if x.startswith(f"rank {r};"))
                                  for r in range(2)},
        "svg_bytes": os.path.getsize(svg), "readers_s": readers_s}
    return last_json(out), readers


def phase_tools() -> dict:
    """The port's operator tools (``horovod_tpu_torch/tools/``) on this
    card, each run as a user runs it (``python -m
    horovod_tpu_torch.tools.<name>``): ``measure_torch_staging`` at two
    ranks with the readers ``hvdtop`` and ``flame`` against its live
    endpoints (the ``staging`` and ``readers`` lines);
    ``measure_elastic --paths torch --runs 1`` with the flight recorder
    armed in the workers, then ``blackbox_merge`` of their dumps and
    ``validate_trace --merged`` of the merged trace
    (``elastic_latency``); ``profile_resnet`` at batch 128 with a device
    trace that ``validate_trace`` must accept (``resnet_profile``); and
    ``tune_report`` plain and ``--diff`` on the profile the
    tune_durable phase froze (in the ``readers`` line).  Gates: every
    tool exits 0 (``hvdtop`` unsigned is refused, 403, and exits 2);
    every staging allreduce is exact; flame's collapsed file has samples
    of both ranks; the elastic world shrank to 2 and the merge names the
    dead rank; ResNet-50's loss is finite and its trace holds
    convolution kernels."""
    t0 = time.perf_counter()
    counts = {"flash": 0, "fusion": 0}
    with tempfile.TemporaryDirectory() as tmp:
        staging, readers = staging_and_readers(tmp)
        emit("staging", tool="horovod_tpu_torch.tools.measure_torch_staging",
             ranks=staging["ranks"], device=staging["device"],
             exact=staging["exact"],
             results_checked=staging["results_checked"],
             allreduce=staging["allreduce"],
             conversion_only=staging["conversion_only"],
             paired=staging["paired"],
             fusion_launches=staging["fusion_launches"],
             endpoints="HOROVOD_METRICS_PORT, HOROVOD_PROFILE=1, "
                       "HOROVOD_STRAGGLER=1, a job secret")
        counts["fusion"] += sum(staging["fusion_launches"].values())
        assert staging["exact"] and staging["results_checked"] > 0, staging
        assert [r["size_mb"] for r in staging["allreduce"]] == [
            int(mb) for mb in STAGING_SIZES_MB for _ in range(2)], staging
        for r in staging["allreduce"]:
            assert r["gbps"] > 0, r
            assert r["backend"] == ("gloo, staged through pinned host "
                                    "memory" if r["input"] == "torch"
                                    else "gloo"), r
            assert r["device"] == ("cuda:0" if r["input"] == "torch"
                                   else "cpu"), r
        assert all(c["round_trip_us"] > 0
                   for c in staging["conversion_only"]), staging

        bb = os.path.join(tmp, "blackbox")
        out = run_tool("measure_elastic", "--paths", "torch", "--runs", "1",
                       env=dict(ELASTIC_BLACKBOX_ENV, HOROVOD_BLACKBOX_DIR=bb))
        elastic = last_json(out)["torch_reinit"]
        sample = elastic["samples"][0]
        assert "error" not in sample, sample
        counts["fusion"] += sample["fusion_launches"]
        merged = os.path.join(tmp, "merged.json")
        verdict = json.loads(run_tool("blackbox_merge", bb, "-o", merged))
        valid = run_tool("validate_trace", "--merged", merged)
        emit("elastic_latency", tool="horovod_tpu_torch.tools.measure_elastic",
             layout="localhost:2 + 127.0.0.1:1, the 127.0.0.1 worker dies "
                    "at epoch 3", step="allreduce of 4 fp32 on cuda",
             blackbox_env=ELASTIC_BLACKBOX_ENV,
             death_to_first_post_resize_step_s=sample[
                 "death_to_first_post_resize_step_s"],
             first_post_resize_step_ms=sample["first_post_resize_step_ms"],
             steady_state_step_ms=sample["steady_state_step_ms"],
             post_resize_size=sample["post_resize_size"],
             fusion_launches=sample["fusion_launches"],
             dumps=sorted(os.listdir(bb)), failed_rank=verdict["failed_rank"],
             spans=verdict["spans"], mttr_s=verdict["mttr_s"],
             first_divergent=(verdict["first_divergent_event"] or {}).get(
                 "kind"),
             clock_offsets=verdict["clock_offsets"],
             events_total=verdict["events_total"],
             merged_trace_valid=valid.strip().endswith("OK"))
        assert sample["post_resize_size"] == 2, sample
        assert verdict["failed_rank"] == 2, verdict
        assert verdict["spans"].get("total", 0) > 0, verdict

        tdir = os.path.join(tmp, "resnet_trace")
        prof = last_json(run_tool(
            "profile_resnet", "--batch-size", str(PROFILE_BATCH),
            "--iters", str(PROFILE_ITERS), "--trace", tdir))
        valid = run_tool("validate_trace", prof["trace_path"])
        hist = prof["kernel_histogram"]
        emit("resnet_profile", tool="horovod_tpu_torch.tools.profile_resnet",
             batch_size=prof["batch_size"], image_size=prof["image_size"],
             iters=PROFILE_ITERS, card=prof["card"],
             step_ms=prof["step_ms"], images_per_sec=prof["images_per_sec"],
             achieved_tflops=prof["achieved_tflops"],
             peak_bf16_tflops=prof["peak_bf16_tflops"],
             peak_source=prof["peak_source"], mfu=prof["mfu"],
             flops_per_step=prof["flops_per_step"],
             flops_source=prof["flops_source"],
             first_step_ms=prof["first_step_ms"], loss=prof["loss"],
             trace_steps=prof["trace_steps"],
             device_ms_per_step=prof["device_ms_per_step"],
             kernel_histogram=hist, top_kernels=prof["top_kernels"][:5],
             trace_valid=valid.strip().endswith("OK"))
        assert math.isfinite(prof["loss"]) and prof["step_ms"] > 0, prof
        assert hist.get("convolution", {}).get("launches_per_step", 0) > 0, \
            hist

        if not TUNED_PROFILE:
            raise RuntimeError("tools: tune_report needs the profile the "
                               "tune_durable phase froze")
        profile = os.path.join(tmp, "profile.json")
        with open(profile, "w") as f:
            f.write(TUNED_PROFILE[-1])
        report = run_tool("tune_report", profile)
        diff = run_tool("tune_report", "--diff", profile, profile)
        emit("readers", **readers, tune_report=report.splitlines(),
             tune_report_diff=diff.splitlines())
        assert readers["hvdtop_unsigned_rc"] == 2 and \
            "403" in readers["hvdtop_unsigned_stderr"], readers
        assert any(line.startswith("cluster: size 2")
                   for line in readers["hvdtop_frame"]), readers
        assert all(n > 0 for n in readers["flame_samples_by_rank"].values()), \
            readers
        assert "worker knobs unchanged" in diff, diff
    emit("tools", seconds=time.perf_counter() - t0)
    return counts


# The chaos phase: the soak as a user runs it (the baseline and two
# seeded fault schedules at 8 thread ranks, then the mid_epoch, mid_write
# and mid_delta checkpoint drills), then four drills in this process with
# the arguments of the JAX package's tier-1 tests.
CHAOS_SOAK_ARGS = ("--ranks", "8", "--schedules", "3", "--seed", "0")
CHAOS_PHASE_LIMIT_S = 150.0


def chaos_trigger_counts(records) -> dict:
    """{site: triggers} summed over records' failpoint counts."""
    out = {}
    for rec in records:
        for site, rules in (rec.get("failpoint_triggers") or {}).items():
            out[site] = out.get(site, 0) + sum(r["triggers"] for r in rules)
    return out


def phase_chaos() -> dict:
    """The port's chaos soak on this card
    (``horovod_tpu_torch/tools/chaos_soak.py``): ``python -m
    horovod_tpu_torch.tools.chaos_soak --ranks 8 --schedules 3 --seed
    0`` as a user runs it (its data plane on the card by default), then
    in this process, on ``cuda:0``, the replay-kill, MTTR kill-at-idle,
    relay kill-mid-negotiation and serve drills with the JAX tier-1
    tests' arguments.  Each rank is a thread with its own runtime and
    data-plane stream over the real control plane.  Gates: every ``ok``
    true, no hang and no incorrect result, every collective's result on
    ``cuda:0`` in its input's dtype (``hvd_chaos_results_total``), each
    postmortem names the victim, and the phase takes at most
    ``CHAOS_PHASE_LIMIT_S``.  Neither kernel runs here: the simulated
    data plane sums in float64 on the card."""
    from horovod_tpu_torch.tools import chaos_soak as cs
    t0 = time.perf_counter()
    flash0, fusion0 = fa.launches, sum(fb.launches.values())
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "chaos_soak.json")
        out = run_tool("chaos_soak", *CHAOS_SOAK_ARGS, "--out", art)
        summary = json.loads([ln for ln in out.splitlines()
                              if ln.startswith("CHAOSJSON ")][-1][10:])
        with open(art) as f:
            soak = json.load(f)
    soak_s = time.perf_counter() - t0
    placed0 = cs.result_placement()
    drills = {
        "replay_kill": cs.run_replay_kill_drill(
            ranks=8, seed=3, hang_timeout_s=20.0, stall_shutdown_s=2.0,
            device="cuda"),
        "mttr_kill_idle": cs.run_mttr_drill(
            fault="kill", when="idle", ranks=8, seed=7, device="cuda"),
        "relay_kill_negotiation": cs.run_relay_drill(
            fault="kill", when="negotiation", ranks=8, fanout=2, seed=3,
            device="cuda"),
        "serve": cs.run_serve_drill(
            ranks=3, seed=5, steps=15, commit_every=3,
            commit_timeout_s=1.0, device="cuda"),
    }
    placed1 = cs.result_placement()
    in_process = {d: {k: n - placed0.get(d, {}).get(k, 0)
                      for k, n in by.items()} for d, by in placed1.items()}
    soak_placed = cs.result_placement(
        soak["metrics"]["counters"].get("hvd_chaos_results_total"))
    mttr, relay = drills["mttr_kill_idle"], drills["relay_kill_negotiation"]
    launches = {"flash": fa.launches - flash0,
                "fusion": sum(fb.launches.values()) - fusion0}
    seconds = time.perf_counter() - t0
    records = soak["schedules"] + (soak["checkpoint_drill"] or [])
    emit("chaos", tool="horovod_tpu_torch.tools.chaos_soak",
         soak_args=" ".join(CHAOS_SOAK_ARGS), soak_ok=summary["ok"],
         outcomes={**{"schedule%d" % r["index"]: r["outcome"]
                      for r in soak["schedules"]},
                   **{"checkpoint_" + d["mode"]: d["ok"]
                      for d in soak["checkpoint_drill"] or []},
                   **{name: d["ok"] for name, d in drills.items()}},
         specs=[r["spec"] for r in soak["schedules"]],
         recovery_latency={k: summary["recovery_latency"][k]
                           for k in ("count", "p50_s", "p90_s", "max_s")},
         mttr={k: mttr.get(k) for k in ("victim", "detect_s", "restore_s",
                                         "resume_s", "mttr_s")},
         replay_kill={k: drills["replay_kill"].get(k) for k in
                      ("victim", "replay_entries", "cycles_replayed",
                       "recovery_latency_s")},
         relay={k: relay.get(k) for k in ("victim_relay", "rehomed",
                                          "rehome_s", "rehome_bound_s")},
         serve={k: drills["serve"].get(k) for k in
                ("victim", "kill_commit", "served_during_gap",
                 "resumed_to", "reads", "torn_reads")},
         postmortem={"mttr_failed_rank": mttr["postmortem"].get(
                         "failed_rank"),
                     "relay_failed_relay": relay["postmortem"].get(
                         "failed_relay")},
         failpoint_triggers=chaos_trigger_counts(records),
         result_devices={"soak": soak_placed, "drills": in_process},
         kernel_launches=launches,
         kernel_note="the chaos phase launches neither kernel: it adds 0 "
                     "to the kernels line's flash and fusion launches",
         soak_seconds=soak_s, seconds=seconds)
    bad = [name for name, ok in (
        [("soak", summary["ok"])]
        + [(n, d["ok"]) for n, d in drills.items()]) if not ok]
    assert not bad, {n: drills.get(n, summary) for n in bad}
    for r in soak["schedules"]:
        assert r["outcome"] in ("ok", "recovered"), r
        assert not r["hangs"] and not r["incorrect"], r
    assert all(d["ok"] for d in soak["checkpoint_drill"]), soak
    assert not drills["replay_kill"]["hangs"] and \
        not drills["replay_kill"]["incorrect"], drills["replay_kill"]
    assert not mttr["errors"] and not mttr["results_bad"], mttr
    assert not relay["hangs"] and not relay["results_bad"], relay
    assert drills["serve"]["torn_reads"] == 0, drills["serve"]
    for where, placed in (("soak", soak_placed), ("drills", in_process)):
        assert set(placed) == {"cuda:0"} and \
            set(placed["cuda:0"]) == {"yes"} and \
            placed["cuda:0"]["yes"] > 0, (where, placed)
    assert mttr["postmortem"]["failed_rank"] == mttr["victim"], mttr
    assert relay["postmortem"]["failed_relay"] == relay["victim_relay"], \
        relay
    assert launches == {"flash": 0, "fusion": 0}, launches
    assert seconds <= CHAOS_PHASE_LIMIT_S, seconds
    return launches


def phase_lint() -> dict:
    """The port's static-analysis gate on the tree this card runs:
    ``python -m horovod_tpu_torch.tools.hvdlint --check all`` as a user
    runs it, against the committed baseline.  The line gives its exit
    code, seconds and the counts its output names (new violations and
    stale baseline entries, grandfathered violations), and the files in
    the gate's scope.  Gate: exit code 0.  It launches neither kernel."""
    from horovod_tpu_torch.tools import hvdlint
    flash0, fusion0 = fa.launches, sum(fb.launches.values())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.hvdlint",
         "--check", "all"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    grandfathered = [int(m.group(1)) for m in (
        re.match(r"hvdlint: (\d+) grandfathered", ln) for ln in lines) if m]
    launches = {"flash": fa.launches - flash0,
                "fusion": sum(fb.launches.values()) - fusion0}
    emit("lint", rc=proc.returncode,
         files_scanned=len(hvdlint.Project.from_root(REPO).files),
         violations=sum(ln.startswith(("NEW ", "STALE ")) for ln in lines),
         grandfathered=sum(grandfathered), seconds=seconds)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert launches == {"flash": 0, "fusion": 0}, launches
    return launches


def main():
    global CARD
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is available")
    if sys.argv[1:2] == ["--train-worker"]:
        train_2rank_worker(sys.argv[2:] == ["--keras-reducer"])
        return
    if sys.argv[1:] == ["--elastic-worker"]:
        elastic_worker()
        return
    if sys.argv[1:] == ["--durable-worker"]:
        durable_worker()
        return
    if sys.argv[1:] == ["--sharded-worker"]:
        sharded_worker()
        return
    if sys.argv[1:] == ["--resnet-worker"]:
        resnet_worker()
        return
    if sys.argv[1:] == ["--cp-worker"]:
        cp_worker()
        return
    if sys.argv[1:] == ["--dlrm-worker"]:
        dlrm_worker()
        return
    CARD = card()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    emit("packages", **{name: importlib.util.find_spec(name) is not None
                        for name in ("keras", "tensorflow")},
         note="information only: model.fit, the TF binding and "
              "KerasEstimator are held against the JAX package on the "
              "CPU (tests/test_torch_port_keras.py, "
              "test_torch_port_tensorflow.py, test_torch_port_spark.py); "
              "here the keras_reducer check runs Keras's torch-backend "
              "reducer, which needs no Keras")
    t0 = time.perf_counter()
    seconds = {}

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__[len("phase_"):]] = time.perf_counter() - t
        return out

    timed(phase_build)
    flash_row = timed(phase_kernels)
    fusion_row = timed(phase_fusion_kernel)
    timed(phase_model_parity)
    timed(phase_train)
    timed(phase_trace_repeat)
    timed(phase_nccl_world1)
    launches, first_native = timed(phase_train_2rank)
    coordinator = timed(phase_coordinator, first_native)
    elastic = timed(phase_elastic)
    durable = timed(phase_tune_durable)
    sharded = timed(phase_sharded_train)
    resnet50 = timed(phase_resnet50)
    context_parallel = timed(phase_context_parallel)
    dlrm_serve = timed(phase_dlrm_serve)
    spark_estimator = timed(phase_spark_estimator)
    examples = timed(phase_examples)
    tools = timed(phase_tools)
    chaos = timed(phase_chaos)
    lint = timed(phase_lint)
    paths = {"train_2rank": launches, "coordinator": coordinator,
             "elastic": elastic, "tune_durable": durable,
             "sharded_train": sharded, "resnet50": resnet50,
             "context_parallel": context_parallel,
             "dlrm_serve": dlrm_serve, "spark_estimator": spark_estimator,
             "examples": examples, "tools": tools, "chaos": chaos,
             "lint": lint}
    for row, kernel in ((flash_row, "flash"), (fusion_row, "fusion")):
        row["launches"] = sum(p[kernel] for p in paths.values())
        row["launches_by_path"] = {name: p[kernel]
                                   for name, p in paths.items()}
    emit("script", seconds=time.perf_counter() - t0, phase_seconds=seconds)
    print(CARD, flush=True)
    print(json.dumps({"kernels": [flash_row, fusion_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
