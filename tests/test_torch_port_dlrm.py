"""The port's DLRM (``horovod_tpu_torch/models/dlrm.py``) against the JAX
package's, on the CPU.

* ``DLRMDense`` from ``convert_flax_dlrm_params`` gives flax's
  ``DLRMDense.apply`` logits at 1e-6 (fp32), and flax's own init's
  shapes; ``bce_logits_loss`` equals the JAX one at 1e-7, its
  gradient at 1e-6 (also at logits of exactly 0);
  ``synthetic_click_batch`` draws the same arrays from one seed.
* Two training steps at two gloo ranks as the JAX package's DLRM lane
  runs them (mean bags over two row-sharded tables, the dense gradients
  averaged by ``hvd.allreduce(..., op=Average, name="dlrm.densegrad")``,
  SGD on both): each rank's losses, the dense parameters and every
  table slice equal a serial replay with the JAX package (flax,
  ``jax.value_and_grad``, its sparse engine at size 1, the ranks' table
  updates in rank order) at 1e-6 (fp32: the two autodiffs round the
  same sums differently).
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import dlrm as jdlrm
from horovod_tpu.sparse import EmbeddingBag as JBag
from horovod_tpu.sparse import ShardedEmbedding as JTable

from horovod_tpu_torch.models import dlrm as tdlrm

from test_torch_port_multiproc import run_port_workers

LAUNCH_TIMEOUT_S = 150
TOL = 1e-6
SMALL = dict(num_dense=4, embed_dim=4, table_rows=(64, 48),
             ids_per_table=2, bottom=(8, 4), top=(8, 4))
BATCH, STEPS, LR = 6, 2, 0.05


def _flax_params(cfg, batch=BATCH, seed=0):
    model = jdlrm.DLRMDense(cfg)
    return model, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((batch, cfg.num_dense)),
        jnp.zeros((batch, cfg.num_tables * cfg.embed_dim)))


def _port_model(cfg, params):
    model = tdlrm.DLRMDense(tdlrm.DLRMConfig(**dataclasses.asdict(cfg)),
                            device="cpu")
    model.load_state_dict(tdlrm.convert_flax_dlrm_params(params))
    return model


@pytest.mark.parametrize("config", ["tiny", "small"])
def test_logits_match_flax(config):
    cfg = jdlrm.dlrm_tiny_config() if config == "tiny" \
        else jdlrm.DLRMConfig(**SMALL)
    jmodel, params = _flax_params(cfg, seed=3)
    model = _port_model(cfg, params)
    assert sorted(model.state_dict()) == sorted(
        tdlrm.convert_flax_dlrm_params(params))
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((16, cfg.num_dense)).astype(np.float32)
    emb = rng.standard_normal(
        (16, cfg.num_tables * cfg.embed_dim)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, dense, emb))
    got = model(torch.from_numpy(dense), torch.from_numpy(emb))
    assert got.shape == (16,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)


def test_tiny_config_and_init_shapes_match_flax():
    cfg = jdlrm.dlrm_tiny_config()
    assert dataclasses.asdict(tdlrm.dlrm_tiny_config()) == \
        dataclasses.asdict(cfg)
    assert tdlrm.dlrm_tiny_config().num_tables == cfg.num_tables == 2
    _, params = _flax_params(cfg)
    want = {k: tuple(v.shape) for k, v in
            tdlrm.convert_flax_dlrm_params(params).items()}
    model = tdlrm.DLRMDense(tdlrm.dlrm_tiny_config(), device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        want
    # flax's initializers: zero biases, lecun-normal kernels.
    for k, v in model.state_dict().items():
        if k.endswith("bias"):
            assert not v.any(), k


def test_bce_logits_loss_and_its_gradient_match_jax():
    """Also at logits of exactly 0 (an example whose top-MLP ReLUs all
    close scores the last bias, 0 at init): ``jnp.clip``'s gradient is 0
    there, ``torch.clamp``'s 1."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal(64) * 6).astype(np.float32)
    logits[:4] = 0.0
    labels = (rng.random(64) < 0.3).astype(np.float32)
    labels[:2] = 1.0
    want, want_grad = jax.value_and_grad(jdlrm.bce_logits_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_()
    got = tdlrm.bce_logits_loss(x, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", [0, [1, 3]])
def test_synthetic_click_batch_matches_jax(seed):
    cfg = jdlrm.dlrm_tiny_config()
    want = jdlrm.synthetic_click_batch(np.random.default_rng(seed), 32, cfg)
    got = tdlrm.synthetic_click_batch(np.random.default_rng(seed), 32,
                                      tdlrm.dlrm_tiny_config())
    for g, w in zip((got[0], *got[1], *got[2:]), (want[0], *want[1],
                                                  *want[2:])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdlrm.DLRMDense(tdlrm.dlrm_tiny_config())


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

_PORT_BODY = """
import json
from horovod_tpu_torch.models import dlrm
from horovod_tpu_torch.sparse import EmbeddingBag, ShardedEmbedding
torch.set_num_threads(1)
cfg = dlrm.DLRMConfig(**json.loads(os.environ["CFG"]))
BATCH, STEPS, LR = (json.loads(os.environ["RUN"])[k]
                    for k in ("batch", "steps", "lr"))
params = dict(np.load(os.environ["PARAMS"]))
model = dlrm.DLRMDense(cfg, device="cpu")
model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
tables = [ShardedEmbedding("dlrm.t%d" % i, rows, cfg.embed_dim,
                           seed=7 + i, device="cpu")
          for i, rows in enumerate(cfg.table_rows)]
bags = [EmbeddingBag(t, mode="mean") for t in tables]
res = {}
for step in range(STEPS):
    dense, ids, offsets, labels = dlrm.synthetic_click_batch(
        np.random.default_rng([RANK, step]), BATCH, cfg)
    emb = torch.cat([bag.forward(ids[i], offsets)
                     for i, bag in enumerate(bags)], dim=1)
    emb.requires_grad_()
    model.zero_grad()
    loss = dlrm.bce_logits_loss(model(torch.from_numpy(dense), emb),
                                torch.from_numpy(labels))
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    flat = hvd.allreduce(torch.cat([g.reshape(-1) for g in grads]),
                         op=hvd.Average, name="dlrm.densegrad")
    with torch.no_grad():
        for p, g in zip(model.parameters(),
                        flat.split([p.numel() for p in model.parameters()])):
            p -= LR * g.reshape(p.shape)
    for i, bag in enumerate(bags):
        bag.backward(emb.grad[:, i * cfg.embed_dim:(i + 1) * cfg.embed_dim],
                     lr=LR)
    res["loss_%d" % step] = loss.detach().numpy()
for k, v in model.state_dict().items():
    res["dense/" + k] = v.numpy()
for t in tables:
    res["table/" + t.name] = t.local.numpy()
hvd.shutdown()
np.savez(os.environ["OUT"].replace(".npz", "-%d.npz" % RANK), **res)
"""


def _jax_serial(cfg, params):
    """Both ranks' steps replayed with the JAX package in one process."""
    jmodel = jdlrm.DLRMDense(cfg)
    tables = [JTable("dlrm.t%d" % i, rows, cfg.embed_dim, rank=0, size=1,
                     seed=7 + i) for i, rows in enumerate(cfg.table_rows)]
    bags = [JBag(t, mode="mean") for t in tables]

    def loss_fn(p, dense, emb, labels):
        return jdlrm.bce_logits_loss(jmodel.apply(p, dense, emb), labels)

    grad_fn = jax.value_and_grad(loss_fn, argnums=(0, 2))
    losses = [[], []]
    for step in range(STEPS):
        batches = [jdlrm.synthetic_click_batch(
            np.random.default_rng([r, step]), BATCH, cfg) for r in range(2)]
        outs = []
        for r, (dense, ids, offsets, labels) in enumerate(batches):
            emb = np.concatenate([bag.forward(ids[i], offsets)
                                  for i, bag in enumerate(bags)], axis=1)
            loss, (g, gemb) = grad_fn(params, dense, emb, labels)
            losses[r].append(float(loss))
            outs.append((g, np.asarray(gemb)))
        avg = jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                     outs[0][0], outs[1][0])
        params = jax.tree_util.tree_map(lambda p, g: p - LR * g, params,
                                        avg)
        for r, (_, ids, offsets, _) in enumerate(batches):
            for i, bag in enumerate(bags):
                bag.forward(ids[i], offsets)
                bag.backward(outs[r][1][:, i * cfg.embed_dim:
                                        (i + 1) * cfg.embed_dim], lr=LR)
    return losses, params, {t.name: t.local for t in tables}


@pytest.fixture(scope="module")
def two_ranks():
    cfg = jdlrm.DLRMConfig(**SMALL)
    _, params = _flax_params(cfg, seed=5)
    want = _jax_serial(cfg, params)
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "params.npz"),
                 **{k: v.numpy() for k, v in
                    tdlrm.convert_flax_dlrm_params(params).items()})
        out = os.path.join(d, "out.npz")
        results = run_port_workers(
            _PORT_BODY, nproc=2,
            extra_env={"OMP_NUM_THREADS": "1", "OUT": out,
                       "PARAMS": os.path.join(d, "params.npz"),
                       "CFG": json.dumps(SMALL),
                       "RUN": json.dumps({"batch": BATCH, "steps": STEPS,
                                          "lr": LR})},
            timeout=LAUNCH_TIMEOUT_S)
        for rc, _ in results:
            assert rc == 0, "\n".join(t[-2500:] for _, t in results)
        got = []
        for r in range(2):
            with np.load(out.replace(".npz", f"-{r}.npz")) as f:
                got.append({k: f[k] for k in f.files})
    return want, got


def test_two_rank_losses_match_the_jax_replay(two_ranks):
    (losses, _, _), got = two_ranks
    for r in range(2):
        np.testing.assert_allclose(
            [float(got[r]["loss_%d" % s]) for s in range(STEPS)],
            losses[r], rtol=TOL, atol=TOL, err_msg=f"rank {r}")


def test_two_rank_dense_parameters_match_the_jax_replay(two_ranks):
    (_, params, _), got = two_ranks
    want = {k: v.numpy() for k, v in
            tdlrm.convert_flax_dlrm_params(params).items()}
    for r in range(2):
        for k, v in want.items():
            np.testing.assert_allclose(got[r]["dense/" + k], v, rtol=TOL,
                                       atol=TOL, err_msg=f"{k} rank {r}")
        for k in want:
            np.testing.assert_array_equal(got[r]["dense/" + k],
                                          got[0]["dense/" + k])


def test_two_rank_tables_match_the_jax_replay(two_ranks):
    (_, _, tables), got = two_ranks
    for r in range(2):
        for name, full in tables.items():
            np.testing.assert_allclose(got[r]["table/" + name], full[r::2],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{name} rank {r}")
        # The step moved the rows the batches touched.
        moved = [not np.array_equal(
            got[r]["table/" + name],
            JTable(name, len(full), full.shape[1], rank=r, size=2,
                   seed=7 + int(name[-1])).local) for name in tables]
        assert all(moved), moved


# sha256 of each seeded draw of chip_smoke.py's dlrm_serve phase, as its
# `draws` field printed them on the card (NVIDIA H100 80GB HBM3, numpy
# 2.3.5, torch 2.11.0+cu128) and as they are drawn here: rank 0's first
# batch (seed [0, 1]), DLRMDense(seed=11)'s init, and rank 0's shard of
# table "dlrm.t0" (seed 7) at size 2.  numpy's zipf stream changed
# between numpy 2.0.2 and 2.3.5, and both packages draw the ids with it,
# so its hash is per numpy version; the rest of the batch, the init
# (drawn with numpy's legacy RandomState, one stream per draw and
# chunk, since the torch.Generator's truncated normal differed between
# torch 2.11 and 2.13) and the
# splitmix64 rows are the same everywhere.
ZIPF_IDS = {
    "2.0.2": "93e43f4499da707bcbebf40a4be8f6b84a6e4faf780ad4192f9839f7aba85c69",
    "2.3.5": "200035c537792a88963835882af97ca4c4c04bae724dac688688d26923b43354",
}
DRAWS = {
    "batch_rest":
        "896a8cb6a1f4ab4e4dd03da25d7619ed48036ccf303381af3d3b9fb60d3bf357",
    "trunc_normal_init":
        "595f37303296c0faa819c29dc8e3e0c700e6564076a8659afbbe379e3050c275",
    "splitmix64_rows":
        "a34669f2896898458ffb9bbb25eb710162cf7c61a7a58c505155b55daf3a1b89",
}


def _sha(*arrays):
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def test_seeded_draws_are_the_cards():
    from horovod_tpu_torch.sparse import ShardedEmbedding
    cfg = tdlrm.dlrm_tiny_config()
    dense, ids, offsets, labels = tdlrm.synthetic_click_batch(
        np.random.default_rng([0, 1]), 32, cfg)
    model = tdlrm.DLRMDense(cfg, device="cpu", seed=11)
    table = ShardedEmbedding("dlrm.t0", cfg.table_rows[0], cfg.embed_dim,
                             rank=0, size=2, seed=7, device="cpu")
    assert {"batch_rest": _sha(dense, offsets, labels),
            "trunc_normal_init": _sha(*(v.numpy() for v in
                                        model.state_dict().values())),
            "splitmix64_rows": _sha(table.local.numpy())} == DRAWS
    if np.__version__ in ZIPF_IDS:
        assert _sha(*ids) == ZIPF_IDS[np.__version__]
    # The JAX package draws the same ids from the same stream.
    jids = jdlrm.synthetic_click_batch(np.random.default_rng([0, 1]), 32,
                                       jdlrm.dlrm_tiny_config())[1]
    assert _sha(*ids) == _sha(*(np.asarray(i) for i in jids))
