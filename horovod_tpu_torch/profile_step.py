"""Where a GPT-2-small training step's device time goes, on the card.

    python3 -m horovod_tpu_torch.profile_step [--steps 3] [--top 12]

Trains the same configuration as chip_smoke.py's training phase (GPT-2
small, bf16 compute, flash attention, AdamW through hvd.torch, batch
8 x 1024) for two warm-up steps, then traces ``--steps`` steps with
``timeline.start_xla_trace``/``stop_xla_trace`` (``torch.profiler``) and
prints one JSON line: the window's wall time, the device time summed
over kernels, the device's idle share of the window, device time by
category and the top kernels by device time, beside the card's name and
power limit.  The profiler slows the host, so the idle share here is an
upper bound; ``chip_smoke.py`` times steps without it.

:func:`device_ms_by_name` and :func:`ms_by_category` read any Chrome
trace that ``stop_xla_trace`` wrote.
"""

import argparse
import json
import subprocess
import tempfile
import time

import torch

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common.timeline import start_xla_trace, stop_xla_trace
from horovod_tpu_torch.models import gpt

CATEGORIES = (("flash_fwd", ("flash_fwd",)),
              ("flash_bwd", ("flash_bwd",)),
              ("matmul_fp32", ("f32f32", "sgemm")),
              ("matmul_16bit", ("gemm", "xmma", "cutlass", "cublas",
                                "nvjet")),
              ("softmax", ("softmax",)),
              ("layer_norm", ("layer_norm",)),
              ("optimizer", ("adam", "foreach", "multi_tensor")),
              ("reduce", ("reduce",)))


# Work on the card in a torch.profiler Chrome trace; record_function
# ranges mirrored on the device ("gpu_user_annotation") are not work.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def device_ms_by_name(trace_path: str) -> dict:
    """Device ms per kernel (or copy, or set) name, summed over a Chrome
    trace written by ``stop_xla_trace``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def ms_by_category(by_name: dict) -> dict:
    """:func:`device_ms_by_name`'s times summed by :func:`category`,
    largest first."""
    out = {}
    for name, ms in by_name.items():
        out[category(name)] = out.get(category(name), 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    hvd.init()
    cfg = gpt.gpt2_small_config(attention_impl="flash", dropout=0.0)
    model = gpt.GPTLMHeadModel(cfg, seed=0).train()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4),
        named_parameters=model.named_parameters())
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (8, 1024), device="cuda",
                        generator=g)

    def step():
        opt.zero_grad()
        gpt.lm_loss(model(ids), ids).backward()
        opt.step()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        start_xla_trace(log_dir)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = device_ms_by_name(stop_xla_trace())
    hvd.shutdown()

    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:args.top]
    print(json.dumps({
        "card": card, "steps": args.steps, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "per_step_ms": {c: ms / args.steps
                        for c, ms in ms_by_category(kernels).items()},
        "top_kernels_per_step_ms": [[n[:90], ms / args.steps]
                                    for n, ms in top]}), flush=True)


if __name__ == "__main__":
    main()
