"""The metric readers against hand-made rank results."""

import math

from hvdbench import spec

CARD = "NVIDIA H100 80GB HBM3"


def _rank(kernel_s, busy=0.8, window=1.0, steps=2):
    return {"device_name": CARD, "steps": 100, "t_window0": 10.0,
            "t_window1": 30.0, "t_init": 5.0, "peak_bytes": 2 ** 30,
            "step_ms": [10.0] * 99 + [50.0],
            "trace": {"steps": steps, "busy_s": busy, "window_s": window,
                      "kernel_s": kernel_s}}


def _read(cell_name, metric, ranks):
    cell = spec.Cell(cell_name)
    return cell.reader(metric)({"cell": cell, "ranks": ranks,
                                "t_start": 1.0})


def test_the_readers():
    kernels = {"flash_fwd_wgmma_kernel": 2 * 12 * 0.07e-3}
    ranks = [_rank(kernels), _rank(kernels, busy=0.6)]
    name = "gpt2_small.1chip"
    assert _read(name, "step_ms_p95", ranks) == 10.0
    flash = _read(name, "flash_roofline_pct", ranks)
    bound = 12 * max(4 * 144 * 1024 * 64 * 2 / 3.35e12,
                     4 * 144 * 524_800 * 64 / 989e12)
    assert math.isclose(flash, 100 * bound / (12 * 0.07e-3))
    assert math.isclose(_read(name, "device_idle_pct.tokens", ranks), 30.0)
    assert _read(name, "hvd_init_s", ranks) == 4.0
    assert _read(name, "setup_s", ranks) == 9.0
    assert _read(name, "peak_mem_gib", ranks) == 1.0
    assert math.isclose(_read(name, "train_tokens_per_s", ranks),
                        2 * 100 * 12 * 1024 / 20.0)
    mfu = _read(name, "step_mfu_pct.tokens", ranks)
    assert math.isclose(mfu, 100 * 2 * 100 * 9_804_233_834_496 / 20.0
                        / (2 * 989e12))


def test_readers_find_nothing_where_nothing_ran():
    ranks = [_rank({"gemm": 0.1})]
    assert _read("gpt2_small.1chip", "flash_roofline_pct", ranks) is None
