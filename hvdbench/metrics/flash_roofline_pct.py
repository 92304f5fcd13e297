"""The flash kernel's bound over its device time: per traced step, the
sum over its calls of max(bytes / HBM bandwidth, FLOPs / 16-bit peak),
counted from the attention shapes, over the device time of the kernels
named ``flash_fwd``; averaged over the ranks.  None where none ran."""
import statistics

from hvdbench import readers, roofline


def read(run):
    cell = run["cell"]
    calls = cell.flops.flash_calls(cell.config, cell.traffic)
    shares = []
    for r in run["ranks"]:
        t = readers.per_step_kernel_s(r, "flash_fwd")
        if t > 0:
            bound = sum(roofline.attention_bound_s(c, r["device_name"])
                        for c in calls)
            shares.append(100.0 * bound / t)
    return statistics.mean(shares) if shares else None
