"""Each configuration's step, at a tiny size on the CPU through the port's
plain kernel paths, against its plain reference."""

import pytest
import torch

from hvdbench import check, plain, run, spec, worker

CELLS = ("gpt_tiny.cpu", "resnet_tiny.cpu")


@pytest.fixture(scope="module")
def hvd():
    import horovod_tpu_torch.torch as hvd
    hvd.init()
    yield hvd
    hvd.shutdown()


def _gaps(tree, hvd, name, seed, **build_kw):
    cell = spec.Cell(name, root=tree)
    cpu = torch.device("cpu")
    result, batches = worker.run_rank(cell, hvd, seed, 0, False, device=cpu,
                                      build_kw=build_kw)
    ref = run.reference(cell, seed, [batches[:3]], cpu)
    return check.gaps([result["check"]], ref)


@pytest.mark.parametrize("name", CELLS)
def test_the_port_in_fp32_is_the_reference(tree, hvd, name):
    gaps = _gaps(tree, hvd, name, 2 ** 31 + 5, dtype=torch.float32)
    assert all(v < 2e-5 for v in gaps.values()), gaps


def test_the_port_in_bf16_is_within_the_tiny_limits(tree, hvd):
    gaps = _gaps(tree, hvd, "gpt_tiny.cpu", 2 ** 31 + 6)
    limits = spec.Cell("gpt_tiny.cpu", root=tree).workload["limits"]
    assert check.judge(gaps, limits), gaps


def test_the_reference_runs_without_tf32(monkeypatch):
    seen = []
    real = plain.train

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*a, **kw)

    monkeypatch.setattr(plain, "train", spy)
    torch.backends.cudnn.allow_tf32 = True
    cell = spec.Cell("resnet50.1chip")
    cfg = dict(cell.config, stage_sizes=[1], num_filters=4, image_size=16)
    w = cell.reference.make_weights(cfg, 0, "cpu")
    gen = plain.generator("cpu", 0, "t")
    b = cell.reference.make_rows(cfg, cell.traffic, 2, gen, "cpu")
    cell.reference.train(cfg, w, [[b]])
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32


def test_weights_and_batches_repeat_from_the_seed(tree):
    cell = spec.Cell("gpt_tiny.cpu", root=tree)
    a = cell.reference.make_weights(cell.config, 2 ** 31 + 9, "cpu")
    b = cell.reference.make_weights(cell.config, 2 ** 31 + 9, "cpu")
    c = cell.reference.make_weights(cell.config, 2 ** 31 + 10, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["word_embeddings.weight"],
                           c["word_embeddings.weight"])
    x = run.checked_batches(cell, 7, "cpu")[0]
    assert torch.equal(x[0], run.checked_batches(cell, 7, "cpu")[0][0])
    assert not torch.equal(x[0], x[1])
