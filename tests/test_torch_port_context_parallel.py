"""The port's sequence, expert and pipeline parallelism against the JAX
package's: ``parallel/attention.py``, ``moe.py``, ``pipeline.py`` and
the two dry runs of ``training.py``.

* ``top1_dispatch`` in process, on the same logits: dispatch and combine
  exactly, the aux loss to one ulp (rtol 1e-6: the mean over tokens
  sums in another order), including the capacity-overflow case of
  ``test_pipeline_moe.py::test_top1_dispatch_capacity`` and ties.
* ``reference_attention`` in process, causal and not (fp32, 1e-5), and
  ``stack_stage_params`` exactly.
* One launch of four gloo ranks runs every sharded case through the
  port's ``shard_map``; the test process runs the same cases through
  JAX's ``shard_map`` on four of its virtual CPU devices:
  - ``ring_attention`` and ``ulysses_attention`` on ``{"sp": 4}``, causal
    and not: outputs and the q/k/v gradients of ``sum(out * c)`` (fp32,
    1e-5);
  - ``moe_ffn`` at ep 4 and at ep 2 (``{"dp": 2, "ep": 2}``), with and
    without dropped tokens: outputs and aux (1e-6), and each rank's
    gradients of ``sum(y * c)`` taken inside the per-rank body (JAX's
    ``jax.grad`` inside ``shard_map``, replication unchecked), 1e-5;
  - ``pipeline_apply`` on ``{"pp": 4}``: the forward against JAX's
    (1e-6), and the per-stage gradients against ``jax.grad`` of the
    stages composed in order (the JAX pipeline's own backward is red on
    the installed JAX), atol 1e-5 / rtol 1e-4 as the JAX test;
  - ``run_ring_attention_dry_run(4)`` (NaN-free) and
    ``run_pipeline_moe_dry_run(4)`` (``{pp: 2, ep: 2, dp: 1}``): its loss
    against the JAX pipeline's forward on the same seeds (1e-6), and its
    three gradients against ``jax.grad`` of the sequential model in
    which each ep rank routes its own tokens through its own copy of
    the stage and gate kernels and the experts are shared (1e-5).
"""

import json
import os
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import torch

from horovod_tpu import training as jtraining
from horovod_tpu.parallel import attention as jattn
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import moe as jmoe
from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu.parallel.collectives import shard_map as jshard_map

from horovod_tpu_torch import training as ttraining
from horovod_tpu_torch.parallel import attention as tattn
from horovod_tpu_torch.parallel import moe as tmoe
from horovod_tpu_torch.parallel import pipeline as tpipe

from test_torch_port_multiproc import run_port_workers

LAUNCH_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,C,seed", [(64, 2, 64, 0), (64, 8, 5, 1),
                                        (33, 4, 3, 2), (128, 8, 16, 3)])
def test_top1_dispatch_matches_jax(T, E, C, seed):
    logits = np.random.RandomState(seed).randn(T, E).astype(np.float32)
    want = [np.asarray(a) for a in jmoe.top1_dispatch(jnp.asarray(logits), C)]
    got = [a.numpy() for a in tmoe.top1_dispatch(torch.from_numpy(logits), C)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


@pytest.mark.parametrize("logits,capacity", [
    ([[5.0, 0.0], [4.0, 0.0], [3.0, 0.0], [0.0, 5.0]], 2),
    ([[0.0, 1.0, 1.0, 0.0]] * 6, 3),                  # argmax ties
])
def test_top1_dispatch_overflow_and_ties_match_jax(logits, capacity):
    logits = np.asarray(logits, np.float32)
    want = [np.asarray(a) for a in
            jmoe.top1_dispatch(jnp.asarray(logits), capacity)]
    got = [a.numpy() for a in
           tmoe.top1_dispatch(torch.from_numpy(logits), capacity)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if capacity == 2:
        # Tokens 0 and 1 fit expert 0; token 2 overflows and is dropped.
        assert got[0][0, 0, 0] == 1 and got[0][1, 0, 1] == 1
        assert got[0][2].sum() == 0 and got[0][3, 1, 0] == 1


def test_stack_stage_params_matches_jax():
    def init(seed):
        rng = np.random.RandomState(seed)
        return (rng.randn(3, 2).astype(np.float32),
                {"b": rng.randn(2).astype(np.float32)})

    want = jpipe.stack_stage_params(
        lambda s: jax.tree_util.tree_map(jnp.asarray, init(s)), [5, 6, 7], 3)
    got = tpipe.stack_stage_params(
        lambda s: (torch.from_numpy(init(s)[0]),
                   {"b": torch.from_numpy(init(s)[1]["b"])}), [5, 6, 7], 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1]["b"].numpy(),
                                  np.asarray(want[1]["b"]))


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 12, 3, 8).astype(np.float32) for _ in range(3))
    want = jattn.reference_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal)
    got = tattn.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the sharded cases: shared inputs
# ---------------------------------------------------------------------------

ATTN_SHAPE = (2, 16, 4, 8)          # [B, S, H, D], S over 4 ranks
MOE_T, MOE_D = 8, 4                 # tokens per rank, model width
# (name, mesh axes, token axes, capacity factor)
MOE_CASES = [("ep4", {"ep": 4}, ("ep",), 8.0),
             ("ep4_drop", {"ep": 4}, ("ep",), 1.0),
             ("ep2", {"dp": 2, "ep": 2}, ("dp", "ep"), 8.0),
             ("ep2_drop", {"dp": 2, "ep": 2}, ("dp", "ep"), 0.5)]
PIPE_S, PIPE_M, PIPE_B, PIPE_D = 4, 6, 2, 8


def _inputs():
    rng = np.random.RandomState(11)
    out = {}
    for name in ("q", "k", "v", "c"):
        out["attn_" + name] = rng.randn(*ATTN_SHAPE).astype(np.float32)
    for name, axes, _, _ in MOE_CASES:
        E = axes["ep"]
        out[f"{name}_x"] = rng.randn(4 * MOE_T, MOE_D).astype(np.float32)
        out[f"{name}_gw"] = rng.randn(MOE_D, E).astype(np.float32)
        out[f"{name}_W"] = (rng.randn(E, MOE_D, MOE_D) * 0.5).astype(
            np.float32)
        out[f"{name}_c"] = rng.randn(4 * MOE_T, MOE_D).astype(np.float32)
    out["pipe_W"] = (rng.randn(PIPE_S, PIPE_D, PIPE_D) * 0.3).astype(
        np.float32)
    out["pipe_b"] = (rng.randn(PIPE_S, PIPE_D) * 0.1).astype(np.float32)
    out["pipe_x"] = rng.randn(PIPE_M, PIPE_B, PIPE_D).astype(np.float32)
    return out


_PORT_BODY = """
import json, os
import numpy as np
import torch
from horovod_tpu_torch import training
from horovod_tpu_torch.parallel import (build_mesh, reference_attention,
                                        ring_attention, shard_map,
                                        ulysses_attention)
from horovod_tpu_torch.parallel.mesh import P
from horovod_tpu_torch.parallel.moe import moe_ffn
from horovod_tpu_torch.parallel.pipeline import pipeline_apply
torch.set_num_threads(1)
inputs = dict(np.load(os.environ["INPUTS"]))
moe_cases = json.loads(os.environ["MOE_CASES"])
t = lambda k: torch.from_numpy(inputs[k])
res = {}

sp = build_mesh({"sp": 4}, device_type="cpu")
for fn in (ring_attention, ulysses_attention):
    for causal in (False, True):
        name = f"{fn.__name__}_{'causal' if causal else 'full'}"
        q, k, v = (t("attn_" + n).requires_grad_() for n in "qkv")
        out = shard_map(lambda a, b, c: fn(a, b, c, axis_name="sp",
                                           causal=causal),
                        sp, P(None, "sp"), P(None, "sp"))(q, k, v)
        (out * t("attn_c")).sum().backward()
        res[name] = out.detach().numpy()
        for n, x in zip("qkv", (q, k, v)):
            res[f"{name}_d{n}"] = x.grad.numpy()

def expert_fn(W, h):
    return torch.tanh(h @ W[0])

for name, axes, tok, cf in moe_cases:
    mesh = build_mesh(axes, device_type="cpu")
    tok = tuple(tok)

    def body(x, gw, W, c):
        x, gw, W = (a.detach().requires_grad_() for a in (x, gw, W))
        y, aux = moe_ffn(x, gw, expert_fn, W, axis_name="ep",
                         capacity_factor=cf)
        grads = torch.autograd.grad((y * c).sum(), (x, gw, W))
        return (y.detach(), aux.detach().reshape(1), grads[0],
                grads[1][None], grads[2])

    outs = shard_map(body, mesh, (P(tok), P(), P("ep"), P(tok)),
                     (P(tok),) * 5)(
        t(f"{name}_x"), t(f"{name}_gw"), t(f"{name}_W"), t(f"{name}_c"))
    for key, o in zip(("y", "aux", "dx", "dgw", "dW"), outs):
        res[f"{name}_{key}"] = o.numpy()

pp = build_mesh({"pp": 4}, device_type="cpu")

def stage(params, h):
    W, b = params
    return torch.tanh(h @ W[0] + b[0])

res["pipe_out"] = shard_map(
    lambda W, b, xm: pipeline_apply(stage, (W, b), xm, axis_name="pp"),
    pp, (P("pp"), P("pp"), P(None, None)), P(None, None))(
        t("pipe_W"), t("pipe_b"), t("pipe_x")).numpy()

def pipe_grads(W, b, xm):
    W, b = W.detach().requires_grad_(), b.detach().requires_grad_()
    out = pipeline_apply(stage, (W, b), xm, axis_name="pp")
    return torch.autograd.grad(torch.mean(out ** 2), (W, b))

res["pipe_dW"], res["pipe_db"] = (g.numpy() for g in shard_map(
    pipe_grads, pp, (P("pp"), P("pp"), P(None, None)),
    (P("pp"), P("pp")))(t("pipe_W"), t("pipe_b"), t("pipe_x")))

mesh = training.run_ring_attention_dry_run(4, device_type="cpu")
res["ring_dry_axes"] = np.asarray([mesh.mesh.numel(),
                                   mesh.mesh_dim_names == ("sp",)])
loss, mesh = training.run_pipeline_moe_dry_run(4, device_type="cpu")
res["pmoe_dry_loss"] = np.asarray(loss)
res["pmoe_dry_axes"] = np.asarray(mesh.mesh.shape)
axes = training.factor_mesh_axes(4, names=("pp", "ep", "dp"))
args = [torch.from_numpy(a) for a in training.pipeline_moe_inputs(axes)]
loss, grads = training.make_pipeline_moe_step(mesh)(*args)
res["pmoe_loss"] = loss.numpy()
for key, g in zip(("dWs", "dgate", "dexpert"), grads):
    res["pmoe_" + key] = g.numpy()
hvd.shutdown()
np.savez(os.environ["OUT"].replace(".npz", f"-{RANK}.npz"), **res)
print("BODY DONE", RANK, flush=True)
"""


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jmesh(axes):
    return jmesh.build_mesh(dict(axes), devices=jax.devices()[:4])


def _jax_attention(inputs):
    want = {}
    mesh = _jmesh({"sp": 4})
    q, k, v, c = (jnp.asarray(inputs["attn_" + n]) for n in "qkvc")
    for fn in (jattn.ring_attention, jattn.ulysses_attention):
        for causal in (False, True):
            name = f"{fn.__name__}_{'causal' if causal else 'full'}"
            f = jax.jit(jshard_map(
                lambda a, b, cc, fn=fn, causal=causal: fn(
                    a, b, cc, axis_name="sp", causal=causal),
                mesh=mesh, in_specs=(JP(None, "sp"),) * 3,
                out_specs=JP(None, "sp"), check_vma=False))
            want[name] = np.asarray(f(q, k, v))
            grads = jax.grad(lambda a, b, cc: jnp.sum(f(a, b, cc) * c),
                             argnums=(0, 1, 2))(q, k, v)
            for n, g in zip("qkv", grads):
                want[f"{name}_d{n}"] = np.asarray(g)
    return want


def _jax_moe(inputs):
    want = {}

    def expert_fn(W, h):
        return jnp.tanh(h @ W[0])

    for name, axes, tok, cf in MOE_CASES:
        mesh = _jmesh(axes)

        def body(x, gw, W, c, cf=cf):
            def loss(x, gw, W):
                y, _ = jmoe.moe_ffn(x, gw, expert_fn, W, axis_name="ep",
                                    capacity_factor=cf)
                return jnp.sum(y * c)
            y, aux = jmoe.moe_ffn(x, gw, expert_fn, W, axis_name="ep",
                                  capacity_factor=cf)
            dx, dgw, dW = jax.grad(loss, argnums=(0, 1, 2))(x, gw, W)
            return y, aux.reshape(1), dx, dgw[None], dW

        f = jax.jit(jshard_map(
            body, mesh=mesh, in_specs=(JP(tok), JP(), JP("ep"), JP(tok)),
            out_specs=(JP(tok),) * 5, check_vma=False))
        outs = f(*(jnp.asarray(inputs[f"{name}_{k}"])
                   for k in ("x", "gw", "W", "c")))
        for key, o in zip(("y", "aux", "dx", "dgw", "dW"), outs):
            want[f"{name}_{key}"] = np.asarray(o)
    return want


def _jax_pipeline(inputs):
    W, b, x = (jnp.asarray(inputs["pipe_" + k]) for k in "Wbx")

    def stage(params, h):
        Wp, bp = params
        return jnp.tanh(h @ Wp[0] + bp[0])

    run = jax.jit(jshard_map(
        lambda Wp, bp, xm: jpipe.pipeline_apply(stage, (Wp, bp), xm,
                                                axis_name="pp"),
        mesh=_jmesh({"pp": 4}),
        in_specs=(JP("pp"), JP("pp"), JP(None, None)),
        out_specs=JP(None, None)))

    def loss_seq(Wp, bp):
        h = x
        for i in range(PIPE_S):
            h = jnp.tanh(h @ Wp[i] + bp[i])
        return jnp.mean(h ** 2)

    dW, db = jax.grad(loss_seq, argnums=(0, 1))(W, b)
    return {"pipe_out": np.asarray(run(W, b, x)), "pipe_dW": np.asarray(dW),
            "pipe_db": np.asarray(db)}


def _jax_pipeline_moe():
    """The JAX dry run's loss (its pipeline forward; its backward is red
    on the installed JAX) and the gradients of its sequential model."""
    axes = jtraining.factor_mesh_axes(4, names=("pp", "ep", "dp"))
    S, E = axes["pp"], axes["ep"]
    Ws, gate_w, expert_W, x = (jnp.asarray(a) for a in
                               ttraining.pipeline_moe_inputs(axes))
    T = x.shape[1] // axes["dp"]
    capacity = max(1, int(4.0 * T / E))

    def expert_fn(W, h):
        return jnp.tanh(h @ W[0])

    def stage(params, h):
        W, gw, eW = params
        h = jnp.tanh(h @ W[0])
        y, _ = jmoe.moe_ffn(h, gw[0], expert_fn, eW[0], axis_name="ep",
                            capacity_factor=4.0)
        return h + y

    def loss_fn(Ws, gate_w, expert_W, xm):
        out = jpipe.pipeline_apply(stage, (Ws, gate_w, expert_W), xm,
                                   axis_name="pp", vary_axes=("ep", "dp"))
        return jax.lax.pmean(jnp.mean(out ** 2), ("dp", "ep"))

    run = jax.jit(jshard_map(
        loss_fn, mesh=_jmesh(axes),
        in_specs=(JP("pp"), JP("pp"), JP("pp", "ep"), JP(None, "dp")),
        out_specs=JP()))
    loss = float(run(Ws, gate_w, expert_W, x))

    def seq_loss(Ws_copies, gate_copies, expert_W):
        # Each ep rank's own tokens (here the same ones) through its own
        # copy of the stage and gate kernels; the experts are shared.
        total = 0.0
        for e in range(E):
            h = x
            for s in range(S):
                h = jnp.tanh(h @ Ws_copies[e][s])
                outs = []
                for m in range(h.shape[0]):
                    d, c, _ = jmoe.top1_dispatch(h[m] @ gate_copies[e][s],
                                                 capacity)
                    buckets = jnp.einsum("tec,td->ecd", d, h[m])
                    out = jnp.stack([jnp.tanh(buckets[j] @ expert_W[s, j])
                                     for j in range(E)])
                    outs.append(jnp.einsum("tec,ecd->td", c, out))
                h = h + jnp.stack(outs)
            total = total + jnp.mean(h ** 2)
        return total

    dWs, dgate, dexpert = jax.grad(seq_loss, argnums=(0, 1, 2))(
        [Ws] * E, [gate_w] * E, expert_W)
    return {"pmoe_loss": np.asarray(loss, np.float32),
            "pmoe_dWs": np.asarray(dWs[0]),
            "pmoe_dgate": np.asarray(dgate[0]),
            "pmoe_dexpert": np.asarray(dexpert)}


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    want = {**_jax_attention(inputs), **_jax_moe(inputs),
            **_jax_pipeline(inputs), **_jax_pipeline_moe()}
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **inputs)
        out = os.path.join(d, "out.npz")
        results = run_port_workers(
            _PORT_BODY, nproc=4,
            extra_env={"OMP_NUM_THREADS": "1",
                       "INPUTS": os.path.join(d, "in.npz"), "OUT": out,
                       "MOE_CASES": json.dumps(MOE_CASES)},
            timeout=LAUNCH_TIMEOUT_S)
        for rc, text in results:
            assert rc == 0, "\n".join(t[-2500:] for _, t in results)
        got = []
        for r in range(4):
            with np.load(out.replace(".npz", f"-{r}.npz")) as f:
                got.append({k: f[k] for k in f.files})
    return want, got


ATTN_NAMES = [f"{fn}_{mode}" for fn in ("ring_attention",
                                        "ulysses_attention")
              for mode in ("full", "causal")]


@pytest.mark.parametrize("name", ATTN_NAMES)
def test_sequence_parallel_attention_matches_jax(name, runs):
    want, got = runs
    for r in range(4):
        for key in (name, name + "_dq", name + "_dk", name + "_dv"):
            np.testing.assert_allclose(got[r][key], want[key], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_moe_ffn_matches_jax(case, runs):
    want, got = runs
    for key in ("y", "aux"):
        np.testing.assert_allclose(got[0][f"{case}_{key}"],
                                   want[f"{case}_{key}"], rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    for key in ("dx", "dgw", "dW"):
        np.testing.assert_allclose(got[0][f"{case}_{key}"],
                                   want[f"{case}_{key}"], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_moe_drops_tokens_over_capacity(runs):
    """The drop cases route more tokens to some expert than its
    capacity: some token's output is exactly zero."""
    want, got = runs
    for case in ("ep4_drop", "ep2_drop"):
        rows = np.abs(got[0][f"{case}_y"]).sum(axis=1)
        assert (rows == 0).any() and (rows > 0).any(), case
        assert not (np.abs(got[0][case.replace("_drop", "") + "_y"])
                    .sum(axis=1) == 0).any()


def test_pipeline_forward_matches_jax(runs):
    want, got = runs
    for r in range(4):
        np.testing.assert_allclose(got[r]["pipe_out"], want["pipe_out"],
                                   rtol=1e-6, atol=1e-6)


def test_pipeline_gradients_match_the_sequential_model(runs):
    want, got = runs
    for r in range(4):
        for key in ("pipe_dW", "pipe_db"):
            np.testing.assert_allclose(got[r][key], want[key], atol=1e-5,
                                       rtol=1e-4, err_msg=key)


def test_ring_attention_dry_run_is_nan_free(runs):
    _, got = runs
    for r in range(4):
        assert got[r]["ring_dry_axes"].tolist() == [4, 1]


def test_pipeline_moe_dry_run_matches_jax(runs):
    want, got = runs
    for r in range(4):
        assert got[r]["pmoe_dry_axes"].tolist() == [2, 2, 1]
        np.testing.assert_allclose(got[r]["pmoe_dry_loss"],
                                   want["pmoe_loss"], rtol=1e-6)
        np.testing.assert_array_equal(got[r]["pmoe_loss"],
                                      got[r]["pmoe_dry_loss"])


@pytest.mark.parametrize("key", ["pmoe_dWs", "pmoe_dgate", "pmoe_dexpert"])
def test_pipeline_moe_gradients_match_the_sequential_model(key, runs):
    want, got = runs
    for r in range(4):
        np.testing.assert_allclose(got[r][key], want[key], rtol=1e-5,
                                   atol=1e-5)
