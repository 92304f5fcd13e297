"""Gradients taken outside the port's ``shard_map`` against ``jax.grad``
taken outside JAX's, through inputs and outputs that a spec leaves
replicated over a mesh axis.

One launch of four gloo ranks runs every case through
``horovod_tpu_torch.parallel.shard_map`` on ``{"dp": 2, "tp": 2}``; the
test process runs the same cases through the JAX package's
``common/jax_compat.shard_map`` (at its default ``check_vma=None``, as
the JAX package calls it) on four virtual CPU devices.  The inputs are
``P()`` (replicated over both axes), ``P("dp")`` (replicated over
``tp``) and ``P(("dp", "tp"))``; the outputs ``P()`` and ``P("dp")``.
Each body mixes a collective with plain elementwise ops.  The outputs
and the gradients of ``sum(out_i * w_i)`` with respect to the three
whole inputs agree at 1e-6 (fp32) on every rank.
"""

import json
import os
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from horovod_tpu.common.jax_compat import shard_map as jshard_map
from horovod_tpu.parallel import mesh as jmesh

from test_torch_port_multiproc import run_port_workers

LAUNCH_TIMEOUT_S = 180
TOL = 1e-6

IN_SPECS = ((), ("dp",), (("dp", "tp"),))
# Body sources, written once against the names both sides bind: ``sum_``
# and ``mean_`` (sum and mean over axes), ``sin``, ``cos``, ``tanh``,
# ``exp``.
CASES = {
    "sum": ("lambda a, b, c: ("
            "sum_(sin(a[:2]) * c + b * c, ('dp', 'tp')), "
            "sum_(b * tanh(c) + a[2:], 'tp'), "
            "cos(a))",
            ((), ("dp",), ())),
    "mean": ("lambda a, b, c: ("
             "mean_(c * a[:2] + exp(b), ('dp', 'tp')), "
             "mean_(b * exp(c), 'tp') + a[:2])",
             ((), ("dp",))),
}


def _inputs():
    rng = np.random.RandomState(5)
    return {"a": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(4, 3).astype(np.float32),
            "c": rng.randn(8, 3).astype(np.float32)}


_PORT_BODY = """
import json, os
import numpy as np
import torch
from horovod_tpu_torch.parallel import (allreduce_mean, allreduce_sum,
                                        build_mesh, shard_map)
from horovod_tpu_torch.parallel.mesh import P
torch.set_num_threads(1)
sum_, mean_ = allreduce_sum, allreduce_mean
sin, cos, tanh, exp = torch.sin, torch.cos, torch.tanh, torch.exp
inputs = dict(np.load(os.environ["INPUTS"]))
cases = json.loads(os.environ["CASES"])
in_specs = tuple(P(*s) for s in json.loads(os.environ["IN_SPECS"]))
mesh = build_mesh({"dp": 2, "tp": 2}, device_type="cpu")
res = {}
for name, (src, out_specs) in cases.items():
    fn = shard_map(eval(src), mesh, in_specs,
                   tuple(P(*s) for s in out_specs))
    args = [torch.from_numpy(inputs[k]).requires_grad_() for k in "abc"]
    outs = fn(*args)
    loss = sum((o * torch.from_numpy(inputs[f"{name}_w{i}"])).sum()
               for i, o in enumerate(outs))
    grads = torch.autograd.grad(loss, args)
    for i, o in enumerate(outs):
        res[f"{name}_out{i}"] = o.detach().numpy()
    for k, g in zip("abc", grads):
        res[f"{name}_d{k}"] = g.numpy()
hvd.shutdown()
np.savez(os.environ["OUT"].replace(".npz", f"-{RANK}.npz"), **res)
"""


def _jax_side(inputs):
    """The JAX outputs and gradients; adds each case's output weights
    ``<case>_w<i>`` (random, of the outputs' shapes) to ``inputs``."""
    mesh = jmesh.build_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    env = {"sum_": jax.lax.psum, "mean_": jax.lax.pmean, "sin": jnp.sin, "cos": jnp.cos, "tanh": jnp.tanh,
           "exp": jnp.exp}
    rng = np.random.RandomState(6)
    want = {}
    args = [jnp.asarray(inputs[k]) for k in "abc"]
    for name, (src, out_specs) in CASES.items():
        fn = jax.jit(jshard_map(
            eval(src, env), mesh, tuple(JP(*s) for s in IN_SPECS),
            tuple(JP(*s) for s in out_specs)))
        outs = fn(*args)
        for i, o in enumerate(outs):
            want[f"{name}_out{i}"] = np.asarray(o)
            inputs[f"{name}_w{i}"] = rng.randn(*o.shape).astype(np.float32)
        ws = [jnp.asarray(inputs[f"{name}_w{i}"]) for i in range(len(outs))]

        def loss(a, b, c, fn=fn, ws=ws):
            return sum(jnp.sum(o * w) for o, w in zip(fn(a, b, c), ws))

        grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
        for k, g in zip("abc", grads):
            want[f"{name}_d{k}"] = np.asarray(g)
    return want


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    want = _jax_side(inputs)
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **inputs)
        out = os.path.join(d, "out.npz")
        results = run_port_workers(
            _PORT_BODY, nproc=4,
            extra_env={"OMP_NUM_THREADS": "1",
                       "INPUTS": os.path.join(d, "in.npz"), "OUT": out,
                       "CASES": json.dumps(CASES),
                       "IN_SPECS": json.dumps(IN_SPECS)},
            timeout=LAUNCH_TIMEOUT_S)
        for rc, _ in results:
            assert rc == 0, "\n".join(t[-2500:] for _, t in results)
        got = []
        for r in range(4):
            with np.load(out.replace(".npz", f"-{r}.npz")) as f:
                got.append({k: f[k] for k in f.files})
    return want, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_match_jax(case, runs):
    want, got = runs
    keys = [k for k in want if k.startswith(case + "_out")]
    assert len(keys) == len(CASES[case][1])
    for r in range(4):
        for k in keys:
            np.testing.assert_allclose(got[r][k], want[k], rtol=TOL,
                                       atol=TOL, err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("arg", ["a", "b", "c"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_outer_gradients_match_jax_grad(case, arg, runs):
    """``a`` is replicated over both axes, ``b`` over ``tp``, ``c`` over
    neither; each case has an output replicated over both axes and one
    over ``tp``."""
    want, got = runs
    k = f"{case}_d{arg}"
    for r in range(4):
        np.testing.assert_allclose(got[r][k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{k} rank {r}")
