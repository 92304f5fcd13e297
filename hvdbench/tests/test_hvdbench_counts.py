"""The yardstick's counts against hand counts and an independent one."""

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from hvdbench import roofline, spec


def _cell(name):
    return spec.Cell(name)


def test_flash_counts_reproduce_the_kernel_table():
    call = dict(bh=96, sq=1024, skv=1024, d=64, causal=True, itemsize=2)
    assert roofline.attention_bytes(call) == 50_331_648
    assert roofline.attention_flops(call) == 12_897_484_800
    bound = roofline.attention_bound_s(call, "NVIDIA H100 80GB HBM3")
    assert math.isclose(bound * 1e3, 0.015024372537313433, rel_tol=1e-12)


def test_gpt2_small_gradients_are_the_fusion_tables_bytes():
    cell = _cell("gpt2_small.1chip")
    specs = cell.reference.weight_specs(cell.config)
    assert len(specs) == 196
    assert 4 * sum(math.prod(s) for _, s, _, _ in specs) == 497_759_232


def test_gpt2_small_step_flops():
    cell = _cell("gpt2_small.1chip")
    flops = cell.flops.step_flops(cell.config, cell.traffic)
    assert round(flops / 1e12, 2) == 9.80
    calls = cell.flops.flash_calls(cell.config, cell.traffic)
    assert len(calls) == 12 and calls[0]["bh"] == 144


def test_resnet50_forward_macs():
    cell = _cell("resnet50.1chip")
    # He et al. 2016, Table 1: 3.8e9 FLOPs (multiply-adds) for v1; the
    # stride on the 3x3 (v1.5) makes it 4.09e9.
    assert cell.flops.forward_macs(cell.config) == 4_089_184_256
    assert cell.flops.step_flops(cell.config, cell.traffic) == \
        3 * 2 * 4_089_184_256 * 128


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_resnet_flops_match_torchs_flop_counter():
    cell = _cell("resnet50.1chip")
    cfg = dict(cell.config, image_size=64)
    w = cell.reference.make_weights(cfg, 0, "cpu")
    batch = (torch.randn(1, 3, 64, 64), torch.zeros(1, dtype=torch.long))
    got = _counted(lambda: cell.reference.loss_of(w, batch, cfg))
    assert got == 2 * cell.flops.forward_macs(cfg)


def test_gpt_flops_match_torchs_flop_counter(tree):
    cell = spec.Cell("gpt_tiny.cpu", root=tree)
    cfg, t = cell.config, cell.traffic
    w = cell.reference.make_weights(cfg, 0, "cpu")
    ids = torch.randint(0, cfg["vocab_size"], (t["rows_per_rank"],
                                               t["seq_len"]))
    got = _counted(lambda: cell.reference.loss_of(w, ids, cfg))
    # The counter counts the whole of QK^T and PV; the count, the causal
    # half with its diagonal.
    B, S, H, L = t["rows_per_rank"], t["seq_len"], cfg["n_embd"], \
        cfg["n_layer"]
    masked = L * 2 * 2 * B * (S * S - S * (S + 1) // 2) * H
    assert got == cell.flops.forward_flops(cfg, t) + masked
