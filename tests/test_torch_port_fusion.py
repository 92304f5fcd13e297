"""The port's fusion buffer (ops/fusion_buffer.py) on the CPU: the plain
pack and unpack against the JAX package's scaling of a fused response
(``horovod_tpu.ops.backend._scale``) on the same numpy inputs, for every
dtype the wire maps.  Exact: both sides round the factor to the dtype
and multiply once.

bf16 is held against the XLA program's scaling (``_scale`` of a jax
array, ``xla_ops.py`` ``_allreduce_fn``): the ring never scales in bf16
(it works in fp32), and numpy's product of ml_dtypes bf16 arrays does
not round to nearest, where XLA and PyTorch do."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from horovod_tpu.ops.backend import _scale as jax_scale

from horovod_tpu_torch.ops import fusion_buffer as fb

_DTYPES = [  # (numpy dtype, torch dtype)
    (np.uint8, torch.uint8), (np.int8, torch.int8),
    (np.uint16, torch.uint16), (np.int16, torch.int16),
    (np.int32, torch.int32), (np.int64, torch.int64),
    (np.float16, torch.float16), (np.float32, torch.float32),
    (np.float64, torch.float64), (ml_dtypes.bfloat16, torch.bfloat16),
]


def _to_torch(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _jax_scale(a: np.ndarray, factor: float) -> np.ndarray:
    if a.dtype == ml_dtypes.bfloat16:
        return np.asarray(jax_scale(jnp.asarray(a), factor))
    return np.asarray(jax_scale(a, factor))


def _inputs(np_dtype, seed=0):
    """Ragged sizes, a 0-d and an empty tensor; integer values small
    enough that every scaled result fits the dtype."""
    rng = np.random.RandomState(seed)
    out = []
    for shape in [(10, 7), (), (0,), (37,), (3, 5, 2), (1,)]:
        if np.issubdtype(np.dtype(np_dtype), np.integer):
            lo = 0 if np.issubdtype(np_dtype, np.unsignedinteger) else -40
            out.append(rng.randint(lo, 40, size=shape).astype(np_dtype))
        else:
            out.append(np.asarray(rng.randn(*shape), np.float32).astype(np_dtype))
    return out


@pytest.mark.parametrize("np_dtype,dtype", _DTYPES,
                         ids=[str(d) for _, d in _DTYPES])
@pytest.mark.parametrize("factor", [1.0, 0.5, 1.0 / 3.0, 3.0])
def test_plain_pack_scales_as_the_jax_package(np_dtype, dtype, factor):
    arrays = _inputs(np_dtype)
    tensors = [_to_torch(a, dtype) for a in arrays]
    flat = fb.pack(tensors, factor)
    offsets, total = fb.layout([a.size for a in arrays], dtype)
    assert flat.shape == (total,) and flat.dtype == dtype
    for a, o in zip(arrays, offsets):
        want = _jax_scale(a, factor).reshape(-1)
        np.testing.assert_array_equal(_bits(flat[o:o + a.size]),
                                      _np_bits(want))
    outs = [torch.empty(t.shape, dtype=dtype) for t in tensors]
    fb.unpack(flat, outs, factor)
    for a, out in zip(arrays, outs):
        want = _jax_scale(_jax_scale(a, factor), factor)
        assert out.shape == a.shape
        np.testing.assert_array_equal(_bits(out), _np_bits(want))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16, jnp.float32])
@pytest.mark.parametrize("factor", [0.1, 1.0 / 3.0, 7.3])
def test_float_factor_is_rounded_to_the_dtype_as_xla_does(dtype, factor):
    # The XLA program multiplies by jnp.asarray(factor, dtype): the factor
    # is rounded to the dtype first (bf16 keeps 8 bits of it).
    x = np.random.RandomState(1).randn(257).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    want = np.asarray(jax_scale(jx, factor))
    got = fb.pack([_to_torch(np.asarray(jx), {jnp.bfloat16: torch.bfloat16,
                                              jnp.float16: torch.float16,
                                              jnp.float32: torch.float32}[dtype])],
                  factor)[:257]
    np.testing.assert_array_equal(_bits(got), _np_bits(want))
    assert fb.factor_in(torch.bfloat16, 0.1) == float(
        np.float32(ml_dtypes.bfloat16(0.1)))


@pytest.mark.parametrize("np_dtype,dtype", [(np.int32, torch.int32),
                                            (np.uint8, torch.uint8),
                                            (np.int64, torch.int64)])
def test_integer_scaling_truncates_toward_zero(np_dtype, dtype):
    a = np.array([7, 5, 3, 1, 0] + ([-7, -5, -3] if np_dtype != np.uint8
                                    else []), dtype=np_dtype)
    for factor in (0.5, 0.3, 1.5):
        got = fb.pack([_to_torch(a, dtype)], factor)[:a.size].numpy()
        np.testing.assert_array_equal(got, jax_scale(a, factor))


def test_bool_scaling_is_nonzero_product():
    a = torch.tensor([True, False, True])
    flat = fb.pack([a], 0.5)
    assert flat.dtype == torch.bool and flat[:3].tolist() == [True, False,
                                                              True]
    assert fb.pack([a], 0.0)[:3].tolist() == [False, False, False]


@pytest.mark.parametrize("dtype,per", [(torch.uint8, 16), (torch.int16, 8),
                                       (torch.float32, 4), (torch.int64, 2),
                                       (torch.bfloat16, 8)])
def test_layout_rounds_each_offset_up_to_16_bytes(dtype, per):
    offsets, total = fb.layout([0, 1, per, per + 1, 3], dtype)
    assert offsets == [0, 0, per, 2 * per, 4 * per]
    assert total == 4 * per + -(-3 // per) * per
    assert all(o * dtype.itemsize % 16 == 0 for o in offsets)


def test_padding_is_zero_and_never_reaches_an_output():
    tensors = [torch.full((3,), 7.0), torch.full((5,), 9.0), torch.tensor(1.5)]
    flat = fb.pack(tensors, 2.0)
    assert flat.tolist() == [14.0] * 3 + [0.0] + [18.0] * 5 + [0.0] * 3 + \
        [3.0, 0.0, 0.0, 0.0]
    flat.fill_(-1.0)
    flat[[0, 1, 2, 4, 5, 6, 7, 8, 12]] = 4.0
    outs = [torch.empty(3), torch.empty(5), torch.empty(())]
    fb.unpack(flat, outs, 0.5)
    assert [o.tolist() for o in outs] == [[2.0] * 3, [2.0] * 5, 2.0]


def test_empty_and_zero_d_tensors():
    tensors = [torch.empty(0), torch.tensor(2.0), torch.empty(0, 4)]
    flat = fb.pack(tensors, 3.0)
    assert flat.tolist() == [6.0, 0.0, 0.0, 0.0]
    outs = [torch.empty(0), torch.empty(()), torch.empty(0, 4)]
    fb.unpack(flat, outs, 1.0)
    assert outs[1].item() == 6.0 and outs[2].shape == (0, 4)
    only_empty = fb.pack([torch.empty(0)], 2.0)
    assert only_empty.numel() == 0
    fb.unpack(only_empty, [torch.empty(0)], 2.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8, torch.bool])
def test_round_trip_at_factor_one_is_exact(dtype):
    g = torch.Generator().manual_seed(2)
    base = torch.randn(5000, generator=g).mul(100).to(dtype)
    tensors = [base[1:1000].view(27, 37), base[3:4], base[1001:4000],
               base[7:7]]
    flat = fb.pack(tensors, 1.0)
    outs = [torch.empty(t.shape, dtype=dtype) for t in tensors]
    fb.unpack(flat, outs, 1.0)
    assert all(torch.equal(o, t) for o, t in zip(outs, tensors))


def test_persistent_buffers_grow_geometrically_and_are_reused():
    bufs = fb.FusionBuffers()
    a = bufs.get("cpu", torch.float32, 10)
    assert a.numel() == 10
    b = bufs.get("cpu", torch.float32, 1000)
    assert b.data_ptr() == a.data_ptr()          # 64 Ki elements to start
    c = bufs.get("cpu", torch.float32, 100_000)   # doubles to 128 Ki
    assert c.numel() == 100_000 and c.data_ptr() != b.data_ptr()
    assert bufs.get("cpu", torch.float32, 131_072).data_ptr() == \
        c.data_ptr()
    d = bufs.get("cpu", torch.float32, 140_000)
    assert d.data_ptr() != c.data_ptr() and \
        bufs._bufs[("cpu", torch.float32, False)].numel() == 262_144
    assert bufs.get("cpu", torch.int32, 5).dtype == torch.int32
    flat = fb.pack([torch.ones(3), torch.ones(2)], 1.0, out=d)
    assert flat.data_ptr() == d.data_ptr() and flat.numel() == 8


def test_cpu_calls_count_plain_versions_not_launches():
    launches, plain = dict(fb.launches), dict(fb.plain_calls)
    flat = fb.pack([torch.ones(4)], 2.0)
    fb.unpack(flat, [torch.empty(4)], 0.5)
    assert fb.launches == launches
    assert fb.plain_calls == {"pack": plain["pack"] + 1,
                              "unpack": plain["unpack"] + 1}


def test_mixed_inputs_are_refused():
    with pytest.raises(ValueError, match="one dtype and device"):
        fb.pack([torch.ones(2), torch.ones(2, dtype=torch.float64)], 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fb.pack([torch.ones(3, 3).t()], 1.0)
    with pytest.raises(ValueError, match="at least"):
        fb.pack([torch.ones(8)], 1.0, out=torch.empty(4))
    with pytest.raises(ValueError, match="outputs need"):
        fb.unpack(torch.empty(3), [torch.empty(8)], 1.0)
