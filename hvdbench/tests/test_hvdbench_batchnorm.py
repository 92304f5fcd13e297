"""The BatchNorm roofline reader's count of ResNet-50's norms and its
reading of hand-made rank results."""

import math
import os

from hvdbench import spec

CARD = "NVIDIA H100 80GB HBM3"


def _reader_module():
    cell = spec.Cell("resnet50.1chip")
    return cell, spec.load_module(
        os.path.join(cell.metrics_dir, "batchnorm_roofline_pct.py"),
        "hvdbench_test_batchnorm_roofline_pct")


def _rank(kernel_s, steps=8):
    return {"device_name": CARD, "trace": {"steps": steps,
                                           "kernel_s": kernel_s}}


def test_resnet50_step_has_53_norms_over_1422589952_values():
    cell, mod = _reader_module()
    shapes = mod.norm_shapes(cell.config, 128)
    assert len(shapes) == 53
    assert mod.values(cell.config, 128) == 1_422_589_952
    assert shapes[0] == (128, 64, 112, 112)
    assert shapes[-1] == (128, 2048, 7, 7)
    bound = mod.bound_s(cell.config, 128, CARD)
    assert math.isclose(bound, 10 * 1_422_589_952 / 3.35e12)
    assert round(bound * 1e3, 4) == 4.2465


def test_batchnorm_roofline_counts_the_norm_kernels_only():
    cell, mod = _reader_module()
    read = cell.reader("batchnorm_roofline_pct")
    per_step = {"void (anonymous namespace)::hvd_batchnorm_stats<bf16, 8>":
                3e-3, "void (anonymous namespace)::hvd_batchnorm_bwd_apply"
                "<bf16, 8>": 5e-3, "sm90_xmma_fprop_implicit_gemm": 0.02}
    ranks = [_rank({k: 8 * s for k, s in per_step.items()})]
    got = read({"cell": cell, "ranks": ranks, "t_start": 1.0})
    assert math.isclose(got, 100 * mod.bound_s(cell.config, 128, CARD)
                        / 8e-3)


def test_batchnorm_roofline_finds_nothing_where_no_kernel_ran():
    cell, _ = _reader_module()
    read = cell.reader("batchnorm_roofline_pct")
    ranks = [_rank({"void at::native::reduce_kernel<512, 1>": 0.1})]
    assert read({"cell": cell, "ranks": ranks, "t_start": 1.0}) is None
