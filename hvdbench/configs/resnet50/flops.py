"""ResNet-50's operations per training step, from its convolution and
dense shapes: 2 FLOPs per multiply-add, times 3 for forward and
backward.  BatchNorm, ReLU, pooling and the loss are not counted."""


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward pass."""
    s = -(-cfg["image_size"] // 2)               # the 7x7 stem, stride 2
    nf = cfg["num_filters"]
    macs = cfg["in_channels"] * 49 * nf * s * s
    s = -(-s // 2)                               # the max-pool
    in_ch = nf
    for stage, size in enumerate(cfg["stage_sizes"]):
        f = nf * 2 ** stage
        for j in range(size):
            stride = 2 if stage > 0 and j == 0 else 1
            out = -(-s // stride)
            macs += in_ch * f * s * s             # 1x1
            macs += f * 9 * f * out * out         # 3x3, the stride
            macs += f * 4 * f * out * out         # 1x1 x4
            if stride != 1 or in_ch != 4 * f:
                macs += in_ch * 4 * f * out * out
            in_ch, s = 4 * f, out
    return macs + in_ch * cfg["num_classes"]


def step_flops(cfg: dict, traffic: dict) -> int:
    """One rank's training step over its batch."""
    return 3 * 2 * forward_macs(cfg) * traffic["rows_per_rank"]

