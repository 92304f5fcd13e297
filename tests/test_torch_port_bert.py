"""The port's BERT and its sharded pretraining step against the JAX
package's.

* At world one, fp32: the port's ``BertForMaskedLM`` with the JAX
  model's weights (``convert_flax_bert_params``) gives its logits and
  ``mlm_loss`` to rtol 1e-5, for ``einsum`` and ``flash`` attention and
  with a padding mask; the flash guards (padding mask, attention
  dropout) raise in both packages.
* One launch of four gloo ranks runs ``make_bert_pretrain_step`` (tiny
  BERT, fp32) on ``{"dp": 2, "tp": 2}`` with ``einsum`` and ``flash``
  from the JAX step's initial weights, against the JAX step on four
  virtual devices, to the tolerances of ``test_torch_port_training.py``.
  The batch's masked counts differ between the dp shards, which a mean
  of per-shard means would get wrong.  The same launch runs the three
  dry runs (``run_gpt_dry_run``, ``run_gpt_fsdp_dry_run``,
  ``run_bert_dry_run``) at four ranks: finite losses, the JAX meshes.
"""

import json
import os
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu import training as jtraining
from horovod_tpu.models import bert as jbert
from horovod_tpu.parallel import mesh as jmesh

from horovod_tpu_torch.models import bert as tbert

from test_torch_port_training import (LR, STEPS, _BODY_DRY, _flat,
                                      check_final, check_gradients,
                                      check_losses, launch_steps)


@pytest.fixture(scope="module")
def bert_ids():
    return np.random.RandomState(0).randint(0, 512, (2, 32)).astype(np.int32)


def _bert_pair(impl, ids, **kw):
    jm = jbert.BertForMaskedLM(jbert.bert_tiny_config(
        dtype=jnp.float32, attention_impl=impl, **kw))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    tm = tbert.BertForMaskedLM(tbert.bert_tiny_config(
        dtype=torch.float32, attention_impl=impl, **kw), device="cpu")
    tm.load_state_dict(tbert.convert_flax_bert_params(_flat(params)))
    return jm, params, tm


def test_converted_bert_state_dict_covers_every_parameter(bert_ids):
    _, params, tm = _bert_pair("einsum", bert_ids)
    sd = tbert.convert_flax_bert_params(_flat(params))
    assert set(sd) == set(tm.state_dict())
    assert sd["encoder.layers.0.attention.query.weight"].shape == (64, 64)
    assert sd["encoder.layers.1.intermediate.weight"].shape == (128, 64)
    assert sd["mlm_bias"].shape == (512,)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_bert_logits_and_loss_match_flax(impl, bert_ids):
    jm, params, tm = _bert_pair(impl, bert_ids)
    rng = np.random.RandomState(1)
    labels = rng.randint(0, 512, bert_ids.shape).astype(np.int32)
    mask = (rng.rand(*bert_ids.shape) < 0.3).astype(np.int32)
    ref = np.asarray(jm.apply(params, jnp.asarray(bert_ids)))
    got = tm(torch.from_numpy(bert_ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    ref_loss = jbert.mlm_loss(jnp.asarray(ref), jnp.asarray(labels),
                              jnp.asarray(mask))
    loss = tbert.mlm_loss(got, torch.from_numpy(labels),
                          torch.from_numpy(mask))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)


def test_bert_padding_mask_matches_flax(bert_ids):
    jm, params, tm = _bert_pair("einsum", bert_ids)
    am = np.ones_like(bert_ids)
    am[:, 20:] = 0
    ref = np.asarray(jm.apply(params, jnp.asarray(bert_ids),
                              attention_mask=jnp.asarray(am)))
    got = tm(torch.from_numpy(bert_ids),
             attention_mask=torch.from_numpy(am)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_bert_flash_guards_raise_in_both_packages(bert_ids):
    jm, params, tm = _bert_pair("flash", bert_ids, attention_dropout=0.1)
    ids = jnp.asarray(bert_ids)
    mask = np.ones_like(bert_ids)
    with pytest.raises(NotImplementedError, match="padding"):
        jm.apply(params, ids, attention_mask=jnp.asarray(mask))
    with pytest.raises(NotImplementedError, match="padding"):
        tm(torch.from_numpy(bert_ids), attention_mask=torch.from_numpy(mask))
    with pytest.raises(NotImplementedError, match="dropout"):
        jm.apply(params, ids, deterministic=False,
                 rngs={"dropout": jax.random.PRNGKey(0)})
    with pytest.raises(NotImplementedError, match="dropout"):
        tm(torch.from_numpy(bert_ids), deterministic=False)


def test_bert_needs_a_card_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbert.BertForMaskedLM(tbert.bert_tiny_config())


def test_bert_dropout_is_flax_scaled_and_seeded(bert_ids):
    _, _, tm = _bert_pair("einsum", bert_ids, hidden_dropout=0.5,
                          attention_dropout=0.5)
    ids = torch.from_numpy(bert_ids)

    def run(seed):
        return tm(ids, deterministic=False,
                  generator=torch.Generator().manual_seed(seed))

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(tm(ids), tm(ids, deterministic=True))


# ---------------------------------------------------------------------------
# the sharded step: four gloo ranks against four virtual devices
# ---------------------------------------------------------------------------

BERT_CASES = [("bert_dp2_tp2_einsum", {"dp": 2, "tp": 2}, "einsum"),
              ("bert_dp2_tp2_flash", {"dp": 2, "tp": 2}, "flash")]


def _bert_batch():
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 512, (8, 16)).astype(np.int32)
    labels = rng.randint(0, 512, (8, 16)).astype(np.int32)
    # The first dp shard (rows 0-3) masks far more than the second.
    rate = np.where(np.arange(8) < 4, 0.5, 0.1)[:, None]
    mask = (rng.rand(8, 16) < rate).astype(np.int32)
    return {"input_ids": ids, "labels": labels, "mask": mask}


def _jax_bert(axes, impl, batch_np):
    cfg = jbert.bert_tiny_config(dtype=jnp.float32, attention_impl=impl)
    mesh = jmesh.build_mesh(dict(axes), devices=jax.devices()[:4])
    make_jitted, bs = jtraining.make_bert_pretrain_step(
        cfg, mesh, learning_rate=LR)
    batch = {k: jax.device_put(jnp.asarray(v), bs)
             for k, v in batch_np.items()}
    init_fn, step_fn = make_jitted(batch)
    state = init_fn(jax.random.PRNGKey(0), batch)
    init = tbert.convert_flax_bert_params(_flat(state.params))
    model = jbert.BertForMaskedLM(cfg)
    grads = jax.jit(jax.grad(lambda p: jbert.mlm_loss(
        model.apply({"params": p}, batch["input_ids"]), batch["labels"],
        batch["mask"])))(state.params)
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    return {"init": init,
            "grads": tbert.convert_flax_bert_params(_flat(grads)),
            "losses": losses,
            "final": tbert.convert_flax_bert_params(_flat(state.params))}


_BODY_BERT = """
batch = {k: torch.from_numpy(v) for k, v in
         np.load(os.path.join(d, "batch.npz")).items()}
for name, axes, impl in spec["bert"]:
    sd = {k: torch.from_numpy(v) for k, v in
          np.load(os.path.join(d, name + ".npz")).items()}
    cfg = bert.bert_tiny_config(dtype=torch.float32, attention_impl=impl)
    mesh = build_mesh(axes, device_type="cpu")
    make_step, _ = training.make_bert_pretrain_step(cfg, mesh,
                                                    learning_rate=LR)
    init_fn, step_fn = make_step(batch)
    state = init_fn(batch=batch, state_dict=sd)
    losses, grads = [], {}
    for i in range(STEPS):
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
        if i == 0:
            grads = {n: full(p.grad)
                     for n, p in state.model.named_parameters()}
    assert state.step == STEPS
    record(name, state.model, state.optimizer, losses, grads)
"""


@pytest.fixture(scope="module")
def step_runs():
    batch = _bert_batch()
    want = {name: _jax_bert(axes, impl, batch)
            for name, axes, impl in BERT_CASES}
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "batch.npz"), **batch)
        for name, w in want.items():
            np.savez(os.path.join(d, name + ".npz"),
                     **{k: v.numpy() for k, v in w["init"].items()})
        got, infos = launch_steps(_BODY_BERT + _BODY_DRY, d,
                                  {"bert": BERT_CASES})
    return want, got, infos


CASES = [c[0] for c in BERT_CASES]


@pytest.mark.parametrize("case", CASES)
def test_step_losses_match_jax(case, step_runs):
    want, _, infos = step_runs
    check_losses(want, infos, case)


@pytest.mark.parametrize("case", CASES)
def test_step1_gradients_match_jax(case, step_runs):
    want, got, _ = step_runs
    check_gradients(want, got, case)


@pytest.mark.parametrize("case", CASES)
def test_final_parameters_match_jax(case, step_runs):
    want, got, _ = step_runs
    check_final(want, got, case)


@pytest.mark.parametrize("case", CASES)
def test_moments_take_their_parameters_placement(case, step_runs):
    _, _, infos = step_runs
    for info in infos:
        assert info[case]["moments_placed_as_params"]


def test_bert_vocab_is_tp_sharded(step_runs):
    _, _, infos = step_runs
    for info in infos:
        placements = info["bert_dp2_tp2_flash"]["placements"]
        assert placements["encoder.word_embeddings.weight"] == \
            ["Replicate()", "Shard(dim=0)"]
        assert placements["mlm_bias"] == ["Replicate()", "Shard(dim=0)"]
        assert placements["encoder.layers.0.attention.out.weight"] == \
            ["Replicate()", "Shard(dim=1)"]


def test_bert_batch_masks_differ_between_dp_shards():
    mask = _bert_batch()["mask"]
    assert mask[:4].sum() > 2 * mask[4:].sum() > 0


def test_dry_runs_give_finite_losses(step_runs):
    _, _, infos = step_runs
    for info in infos:
        dry = info["dry_runs"]
        assert dry["run_gpt_dry_run"][1] == {"dp": 2, "tp": 2}
        assert dry["run_gpt_fsdp_dry_run"][1] == {"fsdp": 2, "tp": 2}
        assert dry["run_bert_dry_run"][1] == {"dp": 2, "tp": 2, "sp": 1}
        for loss, _ in dry.values():
            assert np.isfinite(loss)
    assert len({json.dumps(i["dry_runs"]) for i in infos}) == 1
