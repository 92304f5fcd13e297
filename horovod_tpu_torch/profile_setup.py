"""Where ``chip_smoke.py``'s set-up time goes, on the card.

    python3 -m horovod_tpu_torch.profile_setup [--repeats 2]
    python3 -m horovod_tpu_torch.profile_setup --smoke DIR [DIR ...]

The first form times the construction of GPT-2 small, BERT-base and
ResNet-50 on the card (``device=None``) with the port's seeded draw
(``models/gpt.py:_init_rng``, numpy's legacy ``RandomState``) and with
the ``torch.Generator`` draw the port used before it
(``nn.init.trunc_normal_`` and ``normal_`` on a CPU generator), in the
order numpy, torch, torch, numpy, ``--repeats`` times, and prints one
JSON line of seconds per model and draw beside the card's name and power
limit.

The second form runs ``python3 chip_smoke.py`` from each ``DIR`` in
turn and prints, for each run, its exit code and the seconds from the
start of the run to each line of its standard output (each phase prints
its line when it ends), so two trees' phases can be compared within one
call; ``--log-prefix`` keeps each run's lines.
"""

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

import torch
from torch import nn


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _torch_trunc_normal(t, fan_in, g):
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


@contextlib.contextmanager
def torch_generator_draw():
    """The models draw from a CPU ``torch.Generator`` while in this
    context, as the port did before ``_init_rng``."""
    from .models import bert, gpt, resnet
    patches = {"_init_rng": lambda seed: torch.Generator().manual_seed(seed),
               "_normal": lambda t, std, g: t.normal_(0.0, std, generator=g),
               "_trunc_normal": _torch_trunc_normal}
    saved = [(m, k, getattr(m, k)) for m in (gpt, bert, resnet)
             for k in patches if hasattr(m, k)]
    for m, k, _ in saved:
        setattr(m, k, patches[k])
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def time_builds(repeats: int) -> dict:
    from .models import bert, gpt, resnet
    builds = {"gpt2_small": lambda: gpt.GPTLMHeadModel(
        gpt.gpt2_small_config()),
        "bert_base": lambda: bert.BertForMaskedLM(bert.bert_base_config()),
        "resnet50": lambda: resnet.ResNet50()}
    out = {name: {"numpy": [], "torch": []} for name in builds}
    for _ in range(repeats):
        for draw in ("numpy", "torch", "torch", "numpy"):
            for name, build in builds.items():
                ctx = (torch_generator_draw() if draw == "torch"
                       else contextlib.nullcontext())
                with ctx:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    model = build()
                    torch.cuda.synchronize()
                    out[name][draw].append(time.perf_counter() - t)
                del model
    return out


def time_smoke(dirs, log_prefix=None) -> list:
    runs = []
    for i, d in enumerate(dirs):
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=d,
                                stdout=subprocess.PIPE, text=True)
        log = (open(f"{log_prefix}.{i}.log", "w") if log_prefix
               else contextlib.nullcontext())
        lines = []
        with log:
            for line in proc.stdout:
                t = time.perf_counter() - t0
                if log_prefix:
                    log.write(line)
                try:
                    phase = json.loads(line).get("phase")
                except (ValueError, AttributeError):
                    phase = None
                lines.append({"t": t, "phase": phase})
        runs.append({"dir": d, "rc": proc.wait(), "lines": lines,
                     "seconds": time.perf_counter() - t0})
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--smoke", nargs="+", metavar="DIR")
    ap.add_argument("--log-prefix", help="write run i's standard output "
                    "to LOG_PREFIX.i.log")
    args = ap.parse_args()
    if args.smoke:
        out = {"smoke_runs": time_smoke(args.smoke, args.log_prefix)}
    else:
        out = {"build_seconds": time_builds(args.repeats)}
    print(json.dumps({"card": _card(), "torch": torch.__version__, **out}),
          flush=True)


if __name__ == "__main__":
    main()
