"""The port's Adasum (ops/adasum.py) against the JAX package's numpy
oracle ``adasum_reference_numpy`` on the same inputs, at 2 and 4 ranks,
in fp32 and bf16; the power-of-two error; per-tensor dots inside one
fused buffer.  The distributed ladder runs here with one thread per rank
and an in-memory exchange; the multi-process path is in
test_torch_port_multiproc.py."""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.ops.adasum import (adasum_reduce_ingraph,
                                    adasum_reference_numpy)

from horovod_tpu_torch.ops import adasum
from horovod_tpu_torch.ops import fusion_buffer as fb

# fp32: the oracle merges in fp64, the port in fp32 with fp32 dots.
# bf16: the oracle rounds to bf16 after every level, the port (like the
# JAX body) once at the end.
_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
_NP = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}


def _rank_arrays(n, shapes, seed=0):
    rng = np.random.RandomState(seed)
    # Per-rank scales differ, so the coefficients are far from 1/2.
    return [[np.asarray(rng.randn(*s) * (r + 1), np.float32) for s in shapes]
            for r in range(n)]


def _torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


def _run_ranks(per_rank, prescale=1.0, postscale=1.0):
    """``adasum_allreduce`` on every rank at once, one thread each; the
    exchange hands tensors through a shared mailbox."""
    n = len(per_rank)
    mail, cond = {}, threading.Condition()
    results, errors = [None] * n, []

    def exchange_for(me):
        level = [0]

        def exchange(v, peer):
            with cond:
                mail[(me, peer, level[0])] = v.clone()
                cond.notify_all()
                assert cond.wait_for(lambda: (peer, me, level[0]) in mail,
                                     timeout=30)
                u = mail[(peer, me, level[0])]
            level[0] += 1
            return u
        return exchange

    def body(r):
        try:
            results[r] = adasum.adasum_allreduce(
                per_rank[r], prescale, postscale, list(range(n)), r,
                exchange_for(r), fb.FusionBuffers())
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    return results


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_matches_numpy_oracle(n, dtype):
    arrays = _rank_arrays(n, [(33,)])
    members = [_torch(a[0], dtype).float() for a in arrays]
    got = adasum.ladder(members, [(0, 33)], adasum.acc_dtype(dtype))
    want = adasum_reference_numpy(
        [a[0].astype(_NP[dtype]) for a in arrays]).astype(np.float32)
    for g in got:   # every member holds the same result
        assert torch.equal(g, got[0])
        np.testing.assert_allclose(g.to(dtype).float().numpy(), want,
                                   rtol=_TOL[dtype], atol=_TOL[dtype])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_allreduce_takes_dots_per_tensor(n, dtype):
    # Two tensors of very different scale in one fused response: each
    # tensor's result is its own oracle's, not a whole-buffer merge.
    shapes = [(40,), (3, 7), ()]
    arrays = _rank_arrays(n, shapes, seed=1)
    for r in range(n):
        arrays[r][1] = arrays[r][1] * 1000.0
    per_rank = [[_torch(a, dtype) for a in arrays[r]] for r in range(n)]
    results = _run_ranks(per_rank)
    for r in range(1, n):   # bit-identical on every rank
        assert all(torch.equal(x, y) for x, y in zip(results[r], results[0]))
    for i, shape in enumerate(shapes):
        want = adasum_reference_numpy(
            [arrays[r][i].astype(_NP[dtype]) for r in range(n)])
        got = results[0][i]
        assert got.dtype == dtype and tuple(got.shape) == shape
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32),
                                   rtol=_TOL[dtype], atol=_TOL[dtype] * 1000)
    whole = adasum_reference_numpy(
        [np.concatenate([a.reshape(-1) for a in arrays[r]])
         for r in range(n)])
    assert not np.allclose(results[0][0].float().numpy(), whole[:40],
                           rtol=1e-3)


def test_prescale_and_postscale_apply_in_the_dtype():
    arrays = _rank_arrays(2, [(16,)], seed=2)
    per_rank = [[_torch(a[0], torch.float32)] for a in arrays]
    plain = _run_ranks(per_rank)
    scaled = _run_ranks(per_rank, prescale=2.0, postscale=0.25)
    # Adasum is scale-invariant in its inputs' common scale: scaling both
    # by 2 scales the result by 2, then the postscale applies.
    torch.testing.assert_close(scaled[0][0], plain[0][0] * 0.5, rtol=1e-6,
                               atol=1e-6)


def test_zero_norm_leaves_the_other_operand():
    a = torch.zeros(5)
    b = torch.arange(5.0)
    out = adasum.merge(a, b, [(0, 5)], torch.float32)
    assert torch.equal(out, b)
    assert torch.equal(adasum.merge(a, a, [(0, 5)], torch.float32), a)


def test_accumulates_half_inputs_in_fp64():
    assert adasum.acc_dtype(torch.bfloat16) == torch.float64
    assert adasum.acc_dtype(torch.float16) == torch.float64
    assert adasum.acc_dtype(torch.float32) == torch.float32


@pytest.mark.parametrize("n", [3, 6])
def test_non_power_of_two_raises_the_reference_message(n):
    with pytest.raises(ValueError) as want:
        adasum_reduce_ingraph(np.zeros(2, np.float32), "world", n)
    with pytest.raises(ValueError) as got:
        adasum.ladder([torch.zeros(2)] * n, [(0, 2)], torch.float32)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="power-of-2"):
        adasum.adasum_allreduce([torch.zeros(2)], 1.0, 1.0, list(range(n)),
                                0, None)
