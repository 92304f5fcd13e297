"""LFM2-8B-A1B's operations per training step, from its shapes: 2 FLOPs
per multiply-add of every matmul (the tied LM head and the router
included) and of the short convolution, the causal half of QK^T and AV
(the diagonal counted), times 3 for forward and backward.  The routed
experts count the held assignments a step can expect, T k held / E (a
token's k experts are as likely to be any of the E).  No recompute is
counted.  Also the flash kernel's calls, and the grouped expert
products' bytes and bound (``moe_gemm_roofline_pct``)."""

from hvdbench import roofline

EXPERT_MATRICES = 3  # w1, w3 and w2 of each expert


def _dims(cfg: dict, traffic: dict) -> dict:
    dep = cfg["deployment"]
    return {"B": traffic["rows_per_rank"], "S": traffic["seq_len"],
            "H": cfg["hidden_size"], "I": cfg["intermediate_size"],
            "Im": cfg["moe_intermediate_size"], "V": cfg["vocab_size"],
            "heads": cfg["num_attention_heads"],
            "kv": cfg["num_key_value_heads"], "k": cfg["num_experts_per_tok"],
            "E": dep["num_experts_published"], "held": cfg["num_experts"],
            "taps": cfg["conv_L_cache"], "types": cfg["layer_types"],
            "dense": cfg["num_dense_layers"]}


def expected_routed(cfg: dict, traffic: dict) -> float:
    """Held assignments a step's expert layer can expect: T k held / E."""
    d = _dims(cfg, traffic)
    return d["B"] * d["S"] * d["k"] * d["held"] / d["E"]


def forward_flops(cfg: dict, traffic: dict) -> float:
    """One rank's forward pass over one batch."""
    d = _dims(cfg, traffic)
    B, S, H = d["B"], d["S"], d["H"]
    T = B * S
    hd = H // d["heads"]
    conv = 2 * T * (3 * H * H + H * H + d["taps"] * H)
    attn = (2 * T * (2 * H * H + 2 * H * d["kv"] * hd)
            + 2 * 2 * B * d["heads"] * (S * (S + 1) // 2) * hd)
    dense = 2 * T * 3 * H * d["I"]
    router = 2 * T * H * d["E"]
    experts = 2 * expected_routed(cfg, traffic) * EXPERT_MATRICES * H * d["Im"]
    total = 2 * T * H * d["V"]  # the head
    for i, kind in enumerate(d["types"]):
        total += conv if kind == "conv" else attn
        total += dense if i < d["dense"] else router + experts
    return total


def step_flops(cfg: dict, traffic: dict) -> float:
    """One rank's training step: forward and backward (3 x forward)."""
    return 3 * forward_flops(cfg, traffic)


def flash_calls(cfg: dict, traffic: dict) -> list:
    """The flash kernel's calls in one rank's step: one causal forward per
    attention layer over [rows x query heads, seq, seq, head dim] (key
    and value heads repeated to the query heads), 2-byte elements."""
    d = _dims(cfg, traffic)
    n = sum(kind == "full_attention" for kind in d["types"])
    return [dict(bh=d["B"] * d["heads"], sq=d["S"], skv=d["S"],
                 d=d["H"] // d["heads"], causal=True, itemsize=2)] * n


def moe_gemm_bytes(routed: float, cfg: dict) -> float:
    """Bytes one expert layer's grouped products read and write in a
    step, each operand once, 2-byte elements: per expert matrix W [N, K]
    of the held experts and ``routed`` rows, Y = X W^T (X, W in, Y out),
    dX = dY W (dY, W in, dX out) and dW = dY^T X (dY, X in, dW out)."""
    H, Im, held = cfg["hidden_size"], cfg["moe_intermediate_size"], \
        cfg["num_experts"]
    total = 0.0
    for n, k in ((Im, H), (Im, H), (H, Im)):  # w1, w3, w2
        weight, x, y = held * n * k, routed * k, routed * n
        total += (x + weight + y) + (y + weight + x) + (y + x + weight)
    return 2 * total


def moe_gemm_bound_s(routed: float, card: str, cfg: dict) -> float:
    """The least time of one expert layer's grouped products in a step at
    ``routed`` held assignments: max(their bytes over the memory
    bandwidth, 3 products x 3 matrices x 2 routed H Im FLOPs over the
    16-bit peak), on the card named ``card``."""
    peaks = roofline.of(card)
    flops = 3 * EXPERT_MATRICES * 2 * routed * cfg["hidden_size"] * \
        cfg["moe_intermediate_size"]
    return max(moe_gemm_bytes(routed, cfg) / peaks["hbm_bytes_s"],
               flops / peaks["bf16_flops"])
