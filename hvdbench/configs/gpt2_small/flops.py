"""GPT-2's operations per training step, from its shapes: 2 FLOPs per
multiply-add of every matmul (the tied LM head included) and the causal
half of QK^T and AV (the diagonal counted), times 3 for forward and
backward.  No recompute is counted."""


def _shape(cfg: dict, traffic: dict):
    h = cfg["n_embd"]
    return (traffic["rows_per_rank"], traffic["seq_len"], h,
            cfg["n_inner"] or 4 * h, cfg["n_layer"], cfg["vocab_size"],
            cfg["n_head"])


def forward_flops(cfg: dict, traffic: dict) -> int:
    """One rank's forward pass over one batch."""
    B, S, H, I, L, V, _ = _shape(cfg, traffic)
    tokens = B * S
    dense = 2 * tokens * (4 * H * H + 2 * H * I)
    attention = 2 * 2 * B * (S * (S + 1) // 2) * H
    head = 2 * tokens * H * V
    return L * (dense + attention) + head


def step_flops(cfg: dict, traffic: dict) -> int:
    """One rank's training step: forward and backward (3 x forward)."""
    return 3 * forward_flops(cfg, traffic)


def flash_calls(cfg: dict, traffic: dict) -> list:
    """The flash kernel's calls in one rank's step: one causal forward a
    layer over [rows x heads, seq, seq, head dim], 2-byte elements."""
    B, S, H, _, L, _, heads = _shape(cfg, traffic)
    return [dict(bh=B * heads, sq=S, skv=S, d=H // heads, causal=True,
                 itemsize=2)] * L

