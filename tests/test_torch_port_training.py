"""The port's sharded GPT step and dry runs against the JAX package's.

One launch of four gloo ranks runs ``make_gpt_train_step`` (tiny GPT,
fp32, dropout 0) on ``{"dp": 2, "tp": 2}`` and on ``{"fsdp": 2, "tp":
2}`` with ``fsdp="fsdp"``, each with ``einsum`` and ``flash``, from the
JAX step's initial weights and the same ids; the test process runs the
JAX steps on the same mesh shapes over four virtual devices.  Step-1
loss to rtol 1e-5, step-1 gradients (gathered) to rtol 1e-4 / atol
1e-6, the losses of four steps to rtol 1e-4, the final parameters to
atol 1e-3 (a tenth of the learning rate: Adam moves a parameter by about
the rate per step whatever the gradient's size).
``test_torch_port_bert.py`` holds the BERT step and model and the three
dry runs.
"""

import json
import os
import tempfile

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp

from horovod_tpu import training as jtraining
from horovod_tpu.models import gpt as jgpt
from horovod_tpu.parallel import mesh as jmesh

from horovod_tpu_torch.models import gpt as tgpt

from test_torch_port_multiproc import run_port_workers

STEPS = 4
LR = 1e-2
# A four-rank launch takes 60 to 130 s beside the rest of tier-1.
LAUNCH_TIMEOUT_S = 400


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


# ---------------------------------------------------------------------------
# the sharded steps: four gloo ranks against four virtual devices
# ---------------------------------------------------------------------------

GPT_CASES = [("dp2_tp2_einsum", {"dp": 2, "tp": 2}, None, "einsum"),
             ("dp2_tp2_flash", {"dp": 2, "tp": 2}, None, "flash"),
             ("fsdp2_tp2_einsum", {"fsdp": 2, "tp": 2}, "fsdp", "einsum"),
             ("fsdp2_tp2_flash", {"fsdp": 2, "tp": 2}, "fsdp", "flash")]


def _gpt_ids():
    return np.random.RandomState(5).randint(0, 512, (8, 16)).astype(np.int32)


def _jax_gpt(axes, fsdp, impl, ids):
    cfg = jgpt.gpt_tiny_config(dtype=jnp.float32, attention_impl=impl)
    mesh = jmesh.build_mesh(dict(axes), devices=jax.devices()[:4])
    init_fn, step_fn, bs = jtraining.make_gpt_train_step(
        cfg, mesh, learning_rate=LR, fsdp=fsdp)
    ids = jax.device_put(jnp.asarray(ids), bs)
    params, opt = init_fn(jax.random.PRNGKey(1), ids)
    init = tgpt.convert_flax_gpt_params(_flat(params))
    model = jgpt.GPTLMHeadModel(cfg)
    grads = jax.jit(jax.grad(lambda p: jgpt.lm_loss(
        model.apply({"params": p}, ids), ids)))(params)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step_fn(params, opt, ids)
        losses.append(float(loss))
    return {"init": init,
            "grads": tgpt.convert_flax_gpt_params(_flat(grads)),
            "losses": losses,
            "final": tgpt.convert_flax_gpt_params(_flat(params))}


_BODY_COMMON = """
import json, math, os, torch
import numpy as np
from torch.distributed.tensor import DTensor
from horovod_tpu_torch import training
from horovod_tpu_torch.models import bert, gpt
from horovod_tpu_torch.parallel import build_mesh

d = os.environ["DIR"]
spec = json.loads(os.environ["SPEC"])
STEPS = int(os.environ["STEPS"])
LR = float(os.environ["LR"])
out, info = {}, {}


def full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def record(name, model, opt, losses, grads):
    for n, g in grads.items():
        out[f"{name}/grad/{n}"] = g.numpy()
    for n, p in model.named_parameters():
        out[f"{name}/final/{n}"] = full(p).numpy()
    same = all(tuple(opt.state[p][k].placements) == tuple(p.placements)
               for p in model.parameters() for k in ("exp_avg",
                                                     "exp_avg_sq"))
    info[name] = {"losses": losses, "moments_placed_as_params": same,
                  "placements": {n: [repr(x) for x in p.placements]
                                 for n, p in model.named_parameters()}}
"""

_BODY_GPT = """
ids = torch.from_numpy(np.load(os.path.join(d, "ids.npy")))
for name, axes, fsdp, impl in spec["gpt"]:
    sd = {k: torch.from_numpy(v) for k, v in
          np.load(os.path.join(d, name + ".npz")).items()}
    cfg = gpt.gpt_tiny_config(dtype=torch.float32, attention_impl=impl)
    mesh = build_mesh(axes, device_type="cpu")
    init_fn, step_fn, _ = training.make_gpt_train_step(
        cfg, mesh, learning_rate=LR, fsdp=fsdp)
    model, opt = init_fn(ids=ids, state_dict=sd)
    losses, grads = [], {}
    for i in range(STEPS):
        model, opt, loss = step_fn(model, opt, ids)
        losses.append(float(loss))
        if i == 0:
            grads = {n: full(p.grad) for n, p in model.named_parameters()}
    record(name, model, opt, losses, grads)
"""

_BODY_DRY = """
dry = {}
for fn in ("run_gpt_dry_run", "run_gpt_fsdp_dry_run", "run_bert_dry_run"):
    loss, mesh = getattr(training, fn)(4, device_type="cpu")
    dry[fn] = [loss, dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))]
info["dry_runs"] = dry
"""

_BODY_END = """
if RANK == 0:
    np.savez(os.path.join(d, "out.npz"), **out)
print("INFO " + json.dumps(info), flush=True)
"""

def launch_steps(body, d, spec):
    """``body`` in four gloo ranks with the inputs in ``d``; returns the
    arrays rank 0 saved and every rank's INFO dict."""
    results = run_port_workers(
        _BODY_COMMON + body + _BODY_END, nproc=4,
        extra_env={"OMP_NUM_THREADS": "1", "DIR": d,
                   "SPEC": json.dumps(spec),
                   "STEPS": str(STEPS), "LR": repr(LR)},
        timeout=LAUNCH_TIMEOUT_S)
    for rc, text in results:
        assert rc == 0, "\n".join(t[-2500:] for _, t in results)
    got = dict(np.load(os.path.join(d, "out.npz")))
    infos = [json.loads(next(l for l in text.splitlines()
                             if l.startswith("INFO "))[5:])
             for _, text in results]
    return got, infos


def check_losses(want, infos, case):
    ref = want[case]["losses"]
    for info in infos:
        got = info[case]["losses"]
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        assert got[-1] < got[0]


def check_gradients(want, got, case):
    for name, g in want[case]["grads"].items():
        np.testing.assert_allclose(got[f"{case}/grad/{name}"], g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def check_final(want, got, case):
    """Final parameters to atol 1e-3.  A parameter whose step-1 gradient
    is below the gradient check's atol everywhere (the attention key
    biases: softmax ignores a shift shared by every key, so their exact
    gradient is 0) moves by the sign of rounding noise, up to the
    learning rate per step in either package; it is held to that."""
    off = {}
    for name, p in want[case]["final"].items():
        diff = np.abs(got[f"{case}/final/{name}"] - p.numpy()).max()
        noise = np.abs(want[case]["grads"][name].numpy()).max() < 1e-6
        if diff > (2 * STEPS * LR if noise else 1e-3):
            off[name] = float(diff)
    assert not off, off


@pytest.fixture(scope="module")
def step_runs():
    ids = _gpt_ids()
    want = {}
    for name, axes, fsdp, impl in GPT_CASES:
        want[name] = _jax_gpt(axes, fsdp, impl, ids)
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "ids.npy"), ids)
        for name, w in want.items():
            np.savez(os.path.join(d, name + ".npz"),
                     **{k: v.numpy() for k, v in w["init"].items()})
        got, infos = launch_steps(_BODY_GPT, d, {"gpt": GPT_CASES})
    return want, got, infos


CASES = [c[0] for c in GPT_CASES]


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


def test_fsdp_shards_the_large_kernels(step_runs):
    """The JAX test's check: under fsdp a large kernel is sharded over
    fsdp (and its moment with it, above); under dp x tp it is not."""
    _, _, infos = step_runs
    for info in infos:
        fsdp = info["fsdp2_tp2_flash"]["placements"]
        dp = info["dp2_tp2_flash"]["placements"]
        assert fsdp["layers.0.intermediate.weight"] == \
            ["Shard(dim=1)", "Shard(dim=0)"]
        assert dp["layers.0.intermediate.weight"] == \
            ["Replicate()", "Shard(dim=0)"]
        assert fsdp["layers.0.attention_norm.weight"] == \
            ["Replicate()", "Replicate()"]
        assert fsdp["word_embeddings.weight"] == \
            ["Shard(dim=1)", "Shard(dim=0)"]
