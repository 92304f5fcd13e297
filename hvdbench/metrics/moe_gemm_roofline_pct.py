"""The grouped expert kernels' bound over their device time: per traced
step, ``flops.moe_gemm_bound_s`` at the held assignments an expert layer
can expect (``flops.expected_routed``, T k held / E, the count
``step_flops`` uses), times the expert layers, over the device time of
the kernels named ``moe_gemm``; averaged over the ranks, in %.  None
where none ran."""
import statistics

from hvdbench import readers


def read(run):
    cell = run["cell"]
    flops, cfg = cell.flops, cell.config
    layers = len(cfg["layer_types"]) - cfg["num_dense_layers"]
    routed = flops.expected_routed(cfg, cell.traffic)
    shares = []
    for r in run["ranks"]:
        t = readers.per_step_kernel_s(r, "moe_gemm")
        if t > 0:
            bound = layers * flops.moe_gemm_bound_s(routed, r["device_name"],
                                                    cfg)
            shares.append(100.0 * bound / t)
    return statistics.mean(shares) if shares else None
