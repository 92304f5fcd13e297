"""The flash backward kernels' bound over their device time: per traced
step, the sum over the flash calls of max(bytes / HBM bandwidth, FLOPs /
16-bit peak), over the device time of the kernels named ``flash_bwd``;
averaged over the ranks.  None where none ran.

Bytes: Q, K, V and dO read once, dQ, dK and dV written once (7 BH S D
elements when Sq = Skv).  FLOPs: the five products of the backward
(QK^T, dO V^T, dS K, dS^T Q, P^T dO) over the causal half with its
diagonal, 2.5 times the forward's two."""
import statistics

from hvdbench import readers, roofline


def bound_s(call: dict, card: str) -> float:
    p = roofline.of(card)
    nbytes = ((3 * call["sq"] + 4 * call["skv"]) * call["bh"] * call["d"]
              * call["itemsize"])
    flops = 2.5 * roofline.attention_flops(call)
    return max(nbytes / p["hbm_bytes_s"], flops / p["bf16_flops"])


def read(run):
    cell = run["cell"]
    calls = cell.flops.flash_calls(cell.config, cell.traffic)
    shares = []
    for r in run["ranks"]:
        t = readers.per_step_kernel_s(r, "flash_bwd")
        if t > 0:
            bound = sum(bound_s(c, r["device_name"]) for c in calls)
            shares.append(100.0 * bound / t)
    return statistics.mean(shares) if shares else None
