"""The yardstick of the roofline and utilisation metrics: the published
peaks of the cards the benchmark runs on (NVIDIA's data sheets, dense
rates without sparsity, at the card's full power limit), and a kernel's
bytes and operations counted from its shapes.  A card the table does
not hold fails a run rather than borrowing another's peak."""

PEAKS = {
    # H100 SXM5: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3.
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def of(card: str) -> dict:
    if card not in PEAKS:
        raise KeyError(f"no published peak for the card {card!r}")
    return PEAKS[card]


def attention_bound_s(call: dict, card: str) -> float:
    """The least time of one attention forward: the larger of its bytes
    (Q, K, V read once, O written once) over the memory bandwidth and
    its FLOPs (QK^T and PV, the causal half with its diagonal) over the
    16-bit peak."""
    p = of(card)
    return max(attention_bytes(call) / p["hbm_bytes_s"],
               attention_flops(call) / p["bf16_flops"])


def attention_bytes(call: dict) -> int:
    bh, sq, skv, d = call["bh"], call["sq"], call["skv"], call["d"]
    return (2 * bh * sq * d + 2 * bh * skv * d) * call["itemsize"]


def attention_flops(call: dict) -> int:
    bh, sq, skv, d = call["bh"], call["sq"], call["skv"], call["d"]
    if call["causal"]:
        if sq != skv:
            raise ValueError("causal attention counted for sq == skv only")
        pairs = sq * (sq + 1) // 2
    else:
        pairs = sq * skv
    return 2 * 2 * bh * pairs * d
