"""The port's GPT against the JAX package's flax GPT: the same flax
weights (converted with convert_flax_gpt_params) and the same token ids
give the same logits, loss and gradients."""

import dataclasses

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import gpt as jgpt
from horovod_tpu_torch.models import gpt as tgpt

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(0).randint(0, 512, (2, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params(ids):
    model = jgpt.GPTLMHeadModel(jgpt.gpt_tiny_config(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    return params


def _flat(params):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}


def _pair(flax_params, dtype, impl):
    jd, td = DTYPES[dtype]
    jm = jgpt.GPTLMHeadModel(jgpt.gpt_tiny_config(dtype=jd,
                                                  attention_impl=impl))
    tm = tgpt.GPTLMHeadModel(tgpt.gpt_tiny_config(dtype=td,
                                                  attention_impl=impl),
                             device="cpu")
    tm.load_state_dict(tgpt.convert_flax_gpt_params(_flat(flax_params)))
    return jm, tm


def test_converted_state_dict_covers_every_parameter(flax_params):
    _, tm = _pair(flax_params, "float32", "einsum")
    sd = tgpt.convert_flax_gpt_params(_flat(flax_params))
    assert set(sd) == set(tm.state_dict())
    assert sd["layers.0.attention.query.weight"].shape == (64, 64)
    assert sd["layers.1.intermediate.weight"].shape == (128, 64)


@pytest.mark.parametrize("dtype,impl,tol", [
    ("float32", "einsum", 1e-4),
    ("float32", "flash", 1e-4),
    ("bfloat16", "einsum", 3e-2),
    ("bfloat16", "flash", 3e-2),
])
def test_logits_match_flax(flax_params, ids, dtype, impl, tol):
    jm, tm = _pair(flax_params, dtype, impl)
    ref = np.asarray(jm.apply(flax_params, jnp.asarray(ids)))
    got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=tol,
                               rtol=tol)


def test_loss_and_gradients_match_flax(flax_params, ids):
    jm, tm = _pair(flax_params, "float32", "flash")

    def loss_fn(p):
        return jgpt.lm_loss(jm.apply(p, jnp.asarray(ids)), jnp.asarray(ids))

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(flax_params)
    loss = tgpt.lm_loss(tm(torch.from_numpy(ids)), torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-4,
                               rtol=1e-4)
    conv = tgpt.convert_flax_gpt_params(_flat(ref_grads))
    named = dict(tm.named_parameters())
    for name in ("word_embeddings.weight", "layers.0.attention.query.weight",
                 "layers.0.attention.value.bias", "layers.1.output.weight",
                 "layers.1.mlp_norm.weight", "final_norm.bias"):
        np.testing.assert_allclose(named[name].grad.numpy(),
                                   conv[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_lm_loss_mask_matches_flax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 6, 11).astype(np.float32)
    ids = rng.randint(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.rand(2, 6) > 0.4).astype(np.int32)
    ref = jgpt.lm_loss(jnp.asarray(logits), jnp.asarray(ids),
                       jnp.asarray(mask))
    got = tgpt.lm_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_flash_with_dropout_in_training_raises():
    cfg = tgpt.gpt_tiny_config(dtype=torch.float32, attention_impl="flash",
                               dropout=0.1)
    model = tgpt.GPTLMHeadModel(cfg, device="cpu").train()
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="dropout"):
        model(ids)
    model.eval()
    assert model(ids).shape == (1, 8, cfg.vocab_size)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPTLMHeadModel(tgpt.gpt_tiny_config())


def test_seeded_init_is_deterministic_and_flax_scaled():
    cfg = tgpt.gpt_tiny_config(dtype=torch.float32)
    a = tgpt.GPTLMHeadModel(cfg, device="cpu", seed=7).state_dict()
    b = tgpt.GPTLMHeadModel(cfg, device="cpu", seed=7).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["layers.0.intermediate.weight"]
    assert abs(w.std().item() - 64 ** -0.5) < 0.15 * 64 ** -0.5
    assert dataclasses.replace(cfg, num_layers=1).num_layers == 1
