"""The port's flash attention against the JAX package's Pallas kernel
(interpreter mode on the CPU), on the same numpy inputs.

On a CPU tensor the port runs the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
``tests/test_torch_port_cuda.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.ops.pallas_attention import flash_attention as jax_flash
from horovod_tpu_torch import kernels
from horovod_tpu_torch.ops import flash_attention as fa

B, S, H, D = 2, 64, 2, 16


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(0)
    return tuple(rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))


@pytest.fixture
def no_kernel(monkeypatch):
    """A CPU call must never reach the kernel loader."""
    def boom(*a, **k):
        raise AssertionError("CPU path touched the CUDA kernel loader")
    monkeypatch.setattr(kernels, "load", boom)
    monkeypatch.setattr(fa, "_kernel_lib", boom)


def _both(q, k, v, **kw):
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True, **kw))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw).numpy()
    return got, ref


@pytest.mark.parametrize("causal", [False, True])
def test_matches_pallas_kernel(qkv, no_kernel, causal):
    got, ref = _both(*qkv, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_uneven_blocks(qkv, no_kernel):
    got, ref = _both(*qkv, block_q=48, block_k=24)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_causal_uneven_lengths(no_kernel):
    rng = np.random.RandomState(1)
    q = rng.randn(B, 40, H, D).astype(np.float32)
    k = rng.randn(B, 72, H, D).astype(np.float32)
    v = rng.randn(B, 72, H, D).astype(np.float32)
    got, ref = _both(q, k, v, causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_gradients_match_jax(qkv, no_kernel):
    q, k, v = qkv

    def loss(q, k, v):
        return jnp.mean(jax_flash(q, k, v, causal=True, block_q=16,
                                  block_k=16, interpret=True) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in qkv)
    out = fa.flash_attention(tq, tk, tv, causal=True, block_q=16,
                             block_k=16)
    (out ** 2).mean().backward()
    for got, exp in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                   atol=2e-5, rtol=2e-4)


def test_bf16(qkv, no_kernel):
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in qkv)
    ref = np.asarray(jax_flash(jq, jk, jv, block_q=16, block_k=16,
                               interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in qkv)
    got = fa.flash_attention(tq, tk, tv, block_q=16, block_k=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=3e-2,
                               rtol=3e-2)


def test_unsupported_head_dim_raises(no_kernel):
    x = torch.zeros(1, 8, 1, 24)
    with pytest.raises(ValueError, match="head dim 24"):
        fa.flash_attention(x, x, x)


def test_kernel_wrapper_refuses_cpu_tensors(no_kernel):
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_cuda(x, x, x, 0.25, True)


@pytest.mark.parametrize("sq,skv", [(300, 300), (130, 257)])
def test_wgmma_tile_blocks_match_pallas_at_ragged_causal_lengths(no_kernel,
                                                                 sq, skv):
    # 128 x 128 is the wgmma body's tile; the plain version at those
    # blocks is what the card holds that body against.
    rng = np.random.RandomState(2)
    q = rng.randn(1, sq, H, D).astype(np.float32)
    k = rng.randn(1, skv, H, D).astype(np.float32)
    v = rng.randn(1, skv, H, D).astype(np.float32)
    got, ref = _both(q, k, v, causal=True, block_q=128, block_k=128)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,head_dim,body", [
    (torch.float32, 16, fa.BODY_FP32),
    (torch.float32, 64, fa.BODY_FP32),
    (torch.float32, 128, fa.BODY_FP32),
    (torch.bfloat16, 16, fa.BODY_MMA),
    (torch.float16, 32, fa.BODY_MMA),
    (torch.bfloat16, 64, fa.BODY_WGMMA),
    (torch.float16, 64, fa.BODY_WGMMA),
    (torch.bfloat16, 128, fa.BODY_WGMMA),
    (torch.float16, 128, fa.BODY_WGMMA),
])
def test_body_for_picks_the_kernel_body(dtype, head_dim, body):
    assert fa._body_for(dtype, head_dim) == body


def test_cpu_tensors_never_count_kernel_launches(qkv, no_kernel):
    before, before_body = fa.launches, dict(fa.launches_by_body)
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in qkv)
        fa.flash_attention(tq, tk, tv, causal=True)
    assert fa.launches == before
    assert fa.launches_by_body == before_body
