"""The comparison that decides ``correct`` fails a broken step: a run
driven through the harness on the CPU (the look for a card skipped) with
the timed path broken underneath, once for each fault a training cell
can have, and the fp8 controls in the port's place."""

import pytest
import torch

from hvdbench import calibrate, check, plain, run, spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 21


def _correct(tree, name="gpt_tiny.cpu", **kw):
    cell = spec.Cell(name, root=tree)
    line, _, _ = run.run_cell(cell, SEED, 0.3, False, device=CPU, **kw)
    return line["correct"], line["checks"]


def test_a_sound_step_is_correct(tree):
    ok, checks = _correct(tree)
    assert ok, checks


def test_a_step_that_leaves_the_state_unchanged(tree, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    ok, checks = _correct(tree)
    assert not ok and checks["update_norm_gap"]["value"] == 1.0


def _half_batch(tree, monkeypatch):
    cell = spec.Cell("gpt_tiny.cpu", root=tree)
    program = cell.driver.Program
    real = program.loss
    monkeypatch.setattr(program, "loss",
                        lambda self, ids: real(self, ids[:ids.shape[0] // 2]))


def test_half_of_the_batch_left_out(tree, monkeypatch):
    _half_batch(tree, monkeypatch)
    ok, checks = _correct(tree)
    assert not ok, checks


def test_a_loss_altered_where_it_is_produced(tree, monkeypatch):
    cell = spec.Cell("gpt_tiny.cpu", root=tree)
    program = cell.driver.Program
    real = program.loss
    monkeypatch.setattr(program, "loss",
                        lambda self, ids: real(self, ids) * 1.001)
    ok, checks = _correct(tree)
    assert not ok and checks["loss_gap"]["value"] > 5e-4, checks


def test_the_exchange_between_ranks_left_out(tree, port_on_path):
    ok, checks = _correct(tree, "gpt_tiny.2rank",
                          worker_module="hvdbench.tests.fault_worker")
    assert not ok, checks


def test_two_sound_ranks_are_correct(tree, port_on_path):
    ok, checks = _correct(tree, "gpt_tiny.2rank")
    assert ok, checks


@pytest.mark.parametrize("prec", ["FP8_PRODUCTS", "FP8"])
def test_the_fp8_control_is_not_correct(tree, prec):
    cell = spec.Cell("gpt_tiny.cpu", root=tree)
    for seed in (SEED, SEED + 1, SEED + 2):
        batches = run.checked_batches(cell, seed, CPU)
        ref = run.reference(cell, seed, batches, CPU)
        ctl = run.reference(cell, seed, batches, CPU,
                            prec=getattr(plain, prec))
        gaps = check.gaps(calibrate._as_ranks(ctl, 1), ref)
        assert not check.judge(gaps, cell.workload["limits"]), gaps
