"""The lfm2_8b_a1b cell's counts (``configs/lfm2_8b_a1b/flops.py``)
against torch's FLOP counter on a tiny configuration and against the
numbers the cell's metrics rest on."""

import math

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import FlopCounterMode

from hvdbench import spec

H100 = "NVIDIA H100 80GB HBM3"


def _cell():
    return spec.Cell("lfm2_8b_a1b.1chip")


class _Picks(TorchFunctionMode):
    """Records the experts each ``torch.topk`` call chooses."""

    def __init__(self):
        super().__init__()
        self.picks = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.topk:
            self.picks.append(out.indices)
        return out


def _tiny(held):
    cell = _cell()
    cfg = dict(cell.config, vocab_size=512, hidden_size=64,
               intermediate_size=96, moe_intermediate_size=32,
               num_attention_heads=4, num_key_value_heads=2,
               layer_types=["conv", "conv", "full_attention", "conv",
                            "conv", "full_attention"],
               num_hidden_layers=6, num_experts=len(held),
               deployment=dict(cell.config["deployment"],
                               experts_held=[held.start, held.stop]))
    return cell, cfg, dict(cell.traffic, rows_per_rank=2, seq_len=24)


@pytest.mark.parametrize("held", [range(0, 8), range(8, 32)])
def test_forward_flops_match_torchs_flop_counter(held):
    cell, cfg, t = _tiny(held)
    ref = cell.reference
    w = ref.make_weights(cfg, 7, "cpu")
    ids = torch.randint(0, cfg["vocab_size"], (t["rows_per_rank"],
                                               t["seq_len"]),
                        generator=torch.Generator().manual_seed(7))
    with FlopCounterMode(display=False) as counter:
        ref.loss_of(w, ids, cfg)
    with _Picks() as picks:
        ref.loss_of(w, ids, cfg)
    B, S, H, Im = t["rows_per_rank"], t["seq_len"], cfg["hidden_size"], \
        cfg["moe_intermediate_size"]
    heads, taps = cfg["num_attention_heads"], cfg["conv_L_cache"]
    types = cfg["layer_types"]
    attn = sum(kind == "full_attention" for kind in types)
    conv = len(types) - attn
    # The counter counts the whole of QK^T and PV, where the count takes
    # the causal half with its diagonal; and the convolution's padded
    # tail, S + taps - 1 outputs of which the first S are kept.
    masked = attn * 2 * 2 * B * heads * (S * S - S * (S + 1) // 2) * \
        (H // heads)
    tail = conv * 2 * B * H * (taps - 1) * taps
    # The count takes each expert layer's expected held assignments;
    # this run's routing held these.
    assert len(picks.picks) == len(types) - cfg["num_dense_layers"]
    routed = [int(((p >= held.start) & (p < held.stop)).sum())
              for p in picks.picks]
    expected = cell.flops.expected_routed(cfg, t)
    assert expected == B * S * 4 * len(held) / 32
    routing = sum(2 * (n - expected) * 3 * H * Im for n in routed)
    assert counter.get_total_flops() == pytest.approx(
        cell.flops.forward_flops(cfg, t) + masked + tail + routing,
        rel=1e-12)


def test_cell_step_flops_and_expert_bound():
    cell = _cell()
    cfg, t = cell.config, cell.traffic
    assert round(cell.flops.step_flops(cfg, t) / 1e12, 2) == 43.32
    assert cell.flops.expected_routed(cfg, t) == 8192
    # At 8,115 held assignments (a uniform routing's count at the
    # chip_smoke row's seed) the bytes bound the products.
    assert cell.flops.moe_gemm_bytes(8115, cfg) == 1_089_391_104
    assert math.isclose(cell.flops.moe_gemm_bound_s(8115, H100, cfg) * 1e3,
                        0.5420416957735086, rel_tol=1e-12)
    calls = cell.flops.flash_calls(cfg, t)
    assert len(calls) == 6 and calls[0] == dict(
        bh=64, sq=4096, skv=4096, d=64, causal=True, itemsize=2)
