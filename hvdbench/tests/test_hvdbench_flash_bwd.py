"""The flash backward's roofline reader against hand-made rank results."""

import math

from hvdbench import spec

CARD = "NVIDIA H100 80GB HBM3"


def _read(ranks):
    cell = spec.Cell("gpt2_small.1chip")
    return cell.reader("flash_bwd_roofline_pct")(
        {"cell": cell, "ranks": ranks, "t_start": 1.0})


def _rank(kernel_s, steps=2):
    return {"device_name": CARD, "trace": {"steps": steps,
                                           "kernel_s": kernel_s}}


def test_flash_bwd_roofline_counts_the_backward_kernels_only():
    per_call = {"flash_bwd_dq_kernel": 0.2e-3, "flash_bwd_dkdv_kernel":
                0.15e-3, "flash_fwd_wgmma_kernel": 0.07e-3}
    ranks = [_rank({k: 2 * 12 * s for k, s in per_call.items()})]
    # GPT-2 small: 12 causal calls a step at BH 144, S 1024, D 64, bf16;
    # FLOPs bound it: 2.5 x 4 x 144 x 524,800 x 64 over 989 TFLOP/s.
    bound = 12 * max(7 * 144 * 1024 * 64 * 2 / 3.35e12,
                     2.5 * 4 * 144 * 524_800 * 64 / 989e12)
    assert math.isclose(_read(ranks), 100 * bound / (12 * 0.35e-3))


def test_flash_bwd_roofline_finds_nothing_where_no_kernel_ran():
    assert _read([_rank({"flash_fwd_wgmma_kernel": 1e-3,
                         "sm80_xmma_gemm_f32f32": 0.1})]) is None
