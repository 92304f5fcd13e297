"""The slice as a whole: a Horovod training script through the port's
``hvd.torch`` against the same script through the JAX package, both at
world size 1, plus the eager collectives of both bindings on the same
inputs."""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import optax
import torch

import horovod_tpu.jax as jhvd
import horovod_tpu.torch as ref_hvd
import horovod_tpu_torch.torch as hvd
from horovod_tpu.models import gpt as jgpt
from horovod_tpu_torch.models import gpt as tgpt


@pytest.fixture(scope="module")
def both():
    jhvd.init()
    hvd.init()
    yield
    hvd.shutdown()
    jhvd.shutdown()


def test_sgd_steps_match_jax_distributed_optimizer(both):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 32)).astype(np.int32)
    jm = jgpt.GPTLMHeadModel(jgpt.gpt_tiny_config(dtype=jnp.float32,
                                                  attention_impl="flash"))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}

    tx = jhvd.DistributedOptimizer(optax.sgd(0.1))
    opt_state = tx.init(params)

    def loss_fn(p):
        return jgpt.lm_loss(jm.apply(p, jnp.asarray(ids)), jnp.asarray(ids))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for _ in range(3):
        _, grads = grad_fn(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    model = tgpt.GPTLMHeadModel(
        tgpt.gpt_tiny_config(dtype=torch.float32, attention_impl="flash"),
        device="cpu")
    model.load_state_dict(tgpt.convert_flax_gpt_params(flat))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    tids = torch.from_numpy(ids)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = tgpt.lm_loss(model(tids), tids)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0]

    expected = tgpt.convert_flax_gpt_params(
        {k: np.asarray(v) for k, v in
         flax.traverse_util.flatten_dict(params, sep="/").items()})
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expected[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def _inputs(dtype):
    rng = np.random.RandomState(5)
    if dtype == torch.int32:
        return torch.from_numpy(rng.randint(-50, 50, (6, 3)).astype(np.int32))
    return torch.from_numpy(rng.randn(6, 3).astype(np.float32))


def _same(got, exp):
    assert isinstance(got, torch.Tensor)
    assert got.dtype == exp.dtype
    assert torch.equal(got, exp)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["Sum", "Average", "Min", "Max"])
@pytest.mark.parametrize("pre,post", [(1.0, 1.0), (0.5, 3.0)])
def test_allreduce_matches_reference_binding(both, dtype, op, pre, post):
    x = _inputs(dtype)
    kw = dict(prescale_factor=pre, postscale_factor=post)
    got = hvd.allreduce(x, op=getattr(hvd, op), **kw)
    exp = ref_hvd.allreduce(x, op=getattr(ref_hvd, op), **kw)
    _same(got, exp)
    assert got.dtype == x.dtype
    assert got.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_grouped_allreduce_matches_reference_binding(both, dtype):
    xs = [_inputs(dtype), _inputs(dtype)[:2] * 3]
    got = hvd.grouped_allreduce(xs, op=hvd.Average, prescale_factor=0.25)
    exp = ref_hvd.grouped_allreduce(xs, op=ref_hvd.Average,
                                    prescale_factor=0.25)
    for g, e in zip(got, exp):
        _same(g, e)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_broadcast_allgather_alltoall_match_reference_binding(both, dtype):
    x = _inputs(dtype)
    _same(hvd.broadcast(x, 0), ref_hvd.broadcast(x, 0))
    _same(hvd.allgather(x), ref_hvd.allgather(x))
    _same(hvd.alltoall(x), ref_hvd.alltoall(x))
    out, splits = hvd.alltoall(x, splits=[6])
    rout, rsplits = ref_hvd.alltoall(x, splits=[6])
    _same(out, rout)
    _same(splits, rsplits)


def test_inplace_variants_keep_the_tensor(both):
    x = _inputs(torch.float32)
    ref = ref_hvd.allreduce(x, op=ref_hvd.Sum, prescale_factor=0.5)
    y = hvd.allreduce_(x, op=hvd.Sum, prescale_factor=0.5)
    assert y is x
    _same(x, ref)
    assert hvd.broadcast_(x, 0) is x


def test_objects_round_trip(both):
    obj = {"step": 3, "names": ["a", "b"]}
    assert hvd.broadcast_object(obj, 0) == ref_hvd.broadcast_object(obj, 0)
    assert hvd.allgather_object(obj) == ref_hvd.allgather_object(obj)


def test_world_larger_than_one_names_slice_two(monkeypatch):
    # Slice 2 runs worlds larger than one: init joins the process group at
    # HOROVOD_TPU_COORDINATOR, and without that address it raises rather
    # than run alone.
    from horovod_tpu_torch.common import basics
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.delenv("HOROVOD_TPU_COORDINATOR", raising=False)
    monkeypatch.setattr(basics, "_global_state", basics.HorovodTpuState())
    with pytest.raises(RuntimeError, match="HOROVOD_TPU_COORDINATOR"):
        basics.init()
    assert not basics.is_initialized()
