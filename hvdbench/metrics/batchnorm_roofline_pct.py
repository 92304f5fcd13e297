"""The BatchNorm kernels' bound over their device time: per traced step,
the norm's own bytes over the card's memory bandwidth, over the device
time of the kernels named ``hvd_batchnorm``; averaged over the ranks, in
%.  None where none ran.

The bound counts the norm's work whatever implements it: each call's
N x C x H x W values, 5 accesses each at the compute type's width
(forward: x read, y written; backward: dy and x read, dx written),
10 bytes a value in bf16.  The calls are walked from the cell's config
as the flax ImageNet example builds the network: the stem's norm, three
in every bottleneck, one in each projection."""
import statistics

from hvdbench import readers, roofline

ACCESSES = 5
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def norm_shapes(cfg: dict, batch: int) -> list:
    """(N, C, H, W) of every BatchNorm call of one step's forward."""
    s = -(-cfg["image_size"] // 2)               # the 7x7 stem, stride 2
    nf = cfg["num_filters"]
    shapes = [(batch, nf, s, s)]
    s = -(-s // 2)                               # the max-pool
    in_ch = nf
    for stage, size in enumerate(cfg["stage_sizes"]):
        f = nf * 2 ** stage
        for j in range(size):
            out = -(-s // (2 if stage > 0 and j == 0 else 1))
            shapes += [(batch, f, s, s), (batch, f, out, out),
                       (batch, 4 * f, out, out)]
            if out != s or in_ch != 4 * f:
                shapes.append((batch, 4 * f, out, out))
            in_ch, s = 4 * f, out
    return shapes


def values(cfg: dict, batch: int) -> int:
    return sum(n * c * h * w for n, c, h, w in norm_shapes(cfg, batch))


def bound_s(cfg: dict, batch: int, card: str) -> float:
    nbytes = ACCESSES * ITEMSIZE[cfg["port"]["compute_dtype"]] * \
        values(cfg, batch)
    return nbytes / roofline.of(card)["hbm_bytes_s"]


def read(run):
    cell = run["cell"]
    batch = cell.traffic["rows_per_rank"]
    shares = []
    for r in run["ranks"]:
        t = readers.per_step_kernel_s(r, "hvd_batchnorm")
        if t > 0:
            bound = bound_s(cell.config, batch, r["device_name"])
            shares.append(100.0 * bound / t)
    return statistics.mean(shares) if shares else None
