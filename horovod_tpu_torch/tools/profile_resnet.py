"""One-shot ResNet-50 training-step profile for the MFU ceiling analysis.

Builds the train step the port's ResNet-50 benchmark runs — the port's
``ResNet50`` (bf16 compute, fp32 parameters, 1000 classes, weights from
seed 0), inputs drawn by ``np.random.RandomState(0)`` as the JAX
package's ``bench.build_resnet_train_step`` draws them (images
``rand(B, H, W, 3)``, here moved to NCHW; labels ``randint(0, 1000)``),
softmax cross-entropy and ``SGD(lr=0.01, momentum=0.9)`` — and reports:

  * FLOPs per step, analytic (``flops_source: "analytic"``: ResNet-50's
    forward is about 4.1 GFLOPs an image at 224x224, training about 3x
    that); bytes stay ``null``, since nothing here measures them;
  * the measured step (``--warmup`` steps, then ``--iters`` steps timed
    on the host clock, ended by a synchronize) -> img/s, achieved
    TFLOP/s and MFU against the card's peak;
  * peak and HBM bandwidth from a table keyed on the card's name (one
    row, the H100 SXM, spec-sheet numbers); an unknown card gets
    ``null``.  The card's name and power limit as ``nvidia-smi`` reports
    them are printed beside them;
  * with ``--trace DIR``: a device trace (``timeline.start_xla_trace``)
    of ``TRACE_STEPS`` more steps after the timed ones, so the timing
    carries no profiler cost, read by ``profile_step.device_ms_by_name``
    into a per-category kernel histogram (launches and device ms a step:
    convolution, batchnorm, reduction, elementwise, copy/transpose...)
    and the top kernels by device ms.

Usage (on the card; ``--device cpu`` runs the same on the host):
    python -m horovod_tpu_torch.tools.profile_resnet --batch-size 128 --iters 30
    python -m horovod_tpu_torch.tools.profile_resnet --batch-size 128 --trace /tmp/tb

Counterpart of the JAX package's ``tools/profile_resnet.py``: the same
flags (``--device cpu`` for its ``--cpu``) and report keys, where XLA's
cost analysis and HLO histogram become the analytic count and the
device trace's kernel histogram.
"""

import argparse
import json
import subprocess
import sys
import time

TRACE_STEPS = 3

# Dense bf16 peak and HBM bandwidth by card name: spec-sheet numbers
# (NVIDIA H100 SXM data sheet), at the card's full power limit.
PEAKS = [(("H100 80GB HBM3", "H100 SXM"),
          {"peak_bf16_tflops": 989.4, "hbm_gbps": 3350.0,
           "source": "NVIDIA H100 SXM data sheet (spec sheet, dense "
                     "bf16, 700 W)"})]

# Kernel categories of a ResNet training step, first match wins.
CATEGORIES = (
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm",
                     "winograd")),
    ("copy/transpose", ("nchwtonhwc", "nhwctonchw", "transpose", "copy",
                        "memcpy", "memset", "permute")),
    ("batchnorm", ("batch_norm", "batchnorm", "welford")),
    ("reduction", ("reduce",)),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
    ("optimizer", ("foreach", "multi_tensor")),
    ("elementwise", ("elementwise",)),
)


def resnet50_analytic_flops(batch_size: int) -> float:
    """ResNet-50 fwd ≈ 4.1 GFLOPs/image at 224²; training ≈ 3× fwd."""
    return 3 * 4.1e9 * batch_size


def peak_of(device_name: str):
    """The ``PEAKS`` row of a card name, or None."""
    for names, row in PEAKS:
        if any(n in device_name for n in names):
            return row
    return None


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def kernel_histogram(trace_path: str, steps: int) -> dict:
    """Launches and device ms a step by category, and the top kernels
    by device ms, of a device trace of ``steps`` steps."""
    from .. import profile_step
    by_name = profile_step.device_ms_by_name(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in profile_step.DEVICE_CATS:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    cats = {}
    for name, ms in by_name.items():
        c = cats.setdefault(category(name), {"launches": 0, "ms": 0.0})
        c["launches"] += counts[name]
        c["ms"] += ms
    per_step = {k: {"launches_per_step": v["launches"] / steps,
                    "device_ms_per_step": v["ms"] / steps}
                for k, v in sorted(cats.items(), key=lambda kv: -kv[1]["ms"])}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernel_histogram": per_step,
        "device_ms_per_step": sum(by_name.values()) / steps,
        "top_kernels": [{"name": n[:160], "category": category(n),
                         "device_ms_per_step": ms / steps}
                        for n, ms in top],
    }


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_train_step(batch_size: int, image_size: int, num_classes: int,
                     device):
    """The benchmark's step on ``device``: returns ``step()`` (one SGD
    step, returns the loss tensor)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from ..models.resnet import ResNet50

    model = ResNet50(num_classes=num_classes, seed=0, device=device).train()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch_size, image_size, image_size, 3))
    x = x.permute(0, 3, 1, 2).contiguous().to(device, torch.bfloat16)
    labels = torch.from_numpy(
        rng.randint(0, num_classes, batch_size)).to(device, torch.long)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), labels)
        loss.backward()
        opt.step()
        return loss

    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--trace", type=str, default=None,
                   help="write a device trace of %d more steps into this "
                        "dir" % TRACE_STEPS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the step runs (default: the card)")
    args = p.parse_args(argv)

    import torch
    from ..common.timeline import start_xla_trace, stop_xla_trace
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_resnet: no CUDA device is available "
              "(--device cpu profiles on the host)", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    if dev.type == "cuda":
        name, card = torch.cuda.get_device_name(0), card_line()
    else:
        name, card = "cpu", None
    print(f"device: {name} ({dev.type})")
    if card:
        print(f"card: {card}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    step = build_train_step(args.batch_size, args.image_size, 1000, dev)
    t0 = time.perf_counter()
    step().item()
    first_ms = (time.perf_counter() - t0) * 1e3
    print(f"first step: {first_ms / 1e3:.1f}s", flush=True)
    for _ in range(max(args.warmup - 1, 0)):
        step()
    sync()

    t0 = time.perf_counter()
    for _ in range(args.iters):
        loss = step()
    sync()
    dt = time.perf_counter() - t0
    loss = loss.item()

    flops = resnet50_analytic_flops(args.batch_size)
    row = peak_of(name) if dev.type == "cuda" else None
    report = {
        "flops_per_step": flops,
        "flops_source": "analytic",
        "bytes_accessed_per_step": None,
        "arithmetic_intensity": None,
        "hbm_gbps_assumed": row["hbm_gbps"] if row else None,
        "hbm_bound_step_ms": None,
        "batch_size": args.batch_size,
        "image_size": args.image_size,
        "device": name,
        "card": card,
        "peak_source": row["source"] if row else None,
        "first_step_ms": round(first_ms, 2),
        "loss": loss,
    }
    if args.trace:
        start_xla_trace(args.trace)
        for _ in range(TRACE_STEPS):
            step()
        sync()
        path = stop_xla_trace()
        report["trace_dir"] = args.trace
        report["trace_path"] = path
        report["trace_steps"] = TRACE_STEPS
        report.update(kernel_histogram(path, TRACE_STEPS))

    step_s = dt / args.iters
    peak = row["peak_bf16_tflops"] if row else None
    achieved = flops / step_s / 1e12
    report.update({
        "step_ms": round(step_s * 1e3, 2),
        "images_per_sec": round(args.batch_size / step_s, 1),
        "achieved_tflops": round(achieved, 1),
        "peak_bf16_tflops": peak,
        "mfu": round(achieved / peak, 4) if peak else None,
    })
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
