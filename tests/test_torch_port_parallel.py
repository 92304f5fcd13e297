"""The port's ``parallel/`` against the JAX package's: mesh layout, the
partition rules' placements, and every in-graph collective.

* Mesh helpers (``parse_mesh_axes``, ``_factor``, ``factor_mesh_axes``)
  and ``_fit_spec`` give the JAX package's answers, in process.
* ``infer_shardings`` on the port's GPT and BERT (tiny, and GPT-2 small
  built on the ``meta`` device) names, for every parameter, the mesh
  axes the JAX ``infer_shardings`` names on the counterpart flax
  dimension, on ``{"dp": 2, "tp": 2}``, ``{"fsdp": 2, "tp": 2}`` and
  ``{"dp": 4}``.  The flax-to-torch layout is written out here on its
  own (a kernel ``[in, out]`` is a weight ``[out, in]``; attention's
  head dims flatten, the heads major).
* One launch of four gloo ranks (``hvd.init()`` through the launcher's
  env contract) builds meshes and runs every collective through the
  port's ``shard_map``; the test process runs the same cases through
  JAX's ``shard_map`` on four of its virtual CPU devices.  Floats agree
  to rtol 1e-6 (Adasum to the tolerance of
  ``test_torch_port_adasum.py``), data movement and integers exactly;
  gradients through permutations and all-to-alls agree too.
"""

import json
import logging
import math
import os
import tempfile
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import torch

from horovod_tpu import training as jtraining
from horovod_tpu.models import bert as jbert
from horovod_tpu.models import gpt as jgpt
from horovod_tpu.ops.adasum import (adasum_hierarchical_ingraph as
                                    j_hadasum,
                                    adasum_reduce_ingraph as j_adasum)
from horovod_tpu.parallel import collectives as jcollectives
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import sharding as jsharding

from horovod_tpu_torch import training as ttraining
from horovod_tpu_torch.models import bert as tbert
from horovod_tpu_torch.models import gpt as tgpt
from horovod_tpu_torch.parallel import collectives as tcollectives
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import sharding as tsharding

from test_torch_port_multiproc import run_port_workers

# The four-rank launch takes 20 to 60 s beside the rest of tier-1.
LAUNCH_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# mesh helpers, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["dp:4,tp:2", "dp", "fsdp:2, tp:-1",
                                  "", "dp:8,", "cross:2,local:4"])
def test_parse_mesh_axes_matches_jax(spec):
    assert tmesh.parse_mesh_axes(spec) == jmesh.parse_mesh_axes(spec)


@pytest.mark.parametrize("n,shape", [(8, [-1]), (8, [2, -1]), (8, [2, 4]),
                                     (6, [3, -1, 1]), (4, [1, 4]),
                                     (8, [-1, -1]), (8, [3, -1]),
                                     (8, [2, 2])])
def test_factor_matches_jax(n, shape):
    try:
        want = jmesh._factor(n, shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh._factor(n, shape)
        assert str(got.value) == str(e)
    else:
        assert tmesh._factor(n, shape) == want


@pytest.mark.parametrize("n", list(range(1, 17)) + [24, 48])
@pytest.mark.parametrize("names,absorb", [(("dp", "tp", "sp"), "dp"),
                                          (("pp", "ep", "dp"), "dp"),
                                          (("fsdp", "tp"), "tp")])
def test_factor_mesh_axes_matches_jax(n, names, absorb, caplog):
    with caplog.at_level(logging.WARNING):
        want = jtraining.factor_mesh_axes(n, names, absorb)
        jax_warned = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = ttraining.factor_mesh_axes(n, names, absorb)
        port_warned = [r.getMessage() for r in caplog.records]
    assert got == want
    assert port_warned == jax_warned
    if n in (3, 6, 12) or (n == 24 and len(names) == 3):
        assert port_warned and "odd factor 3" in port_warned[0]


def test_factor_mesh_axes_rejects_what_jax_rejects():
    for args in ((0,), (4, ()), (4, ("tp",), "dp")):
        with pytest.raises(ValueError):
            jtraining.factor_mesh_axes(*args)
        with pytest.raises(ValueError):
            ttraining.factor_mesh_axes(*args)


def test_build_mesh_needs_a_card_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tmesh.build_mesh({"dp": 1})
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tmesh.build_hierarchical_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh({"dp": 1}, device_type="cpu")


@pytest.mark.parametrize("spec,shape,axes", [
    (("tp", "fsdp"), (50257, 768), {"fsdp": 2, "tp": 2}),
    (("tp", "fsdp"), (30522, 768), {"dp": 2, "tp": 2}),
    (("tp", None), (7, 8), {"dp": 4}),
    ((("dp", "tp"), None), (8, 3), {"dp": 2, "tp": 2}),
    ((("dp", "tp"), None), (6, 3), {"dp": 2, "tp": 2}),
    (("fsdp", "tp", None), (64, 4, 16), {"fsdp": 2, "tp": 2}),
    (("fsdp", "tp", None, "dp"), (64, 4), {"fsdp": 2, "tp": 2}),
    ((None,), (0,), {"dp": 2}),
    (("dp",), (0,), {"dp": 2}),
    ((), (3, 3), {"dp": 2}),
])
def test_fit_spec_drops_what_jax_drops(spec, shape, axes):
    jm = jmesh.build_mesh(dict(axes),
                          devices=jax.devices()[:math.prod(axes.values())])
    want = jsharding._fit_spec(JP(*spec), shape, jm)
    got = tsharding._fit_spec(tmesh.P(*spec), shape, axes)
    assert tuple(got) == tuple(want)


# ---------------------------------------------------------------------------
# placements against the JAX rules, in process
# ---------------------------------------------------------------------------

def _flat(tree):
    import flax
    return flax.traverse_util.flatten_dict(tree, sep="/")


def _expected_torch_spec(flax_key, jspec, ndim_torch):
    """The JAX spec carried onto the torch tensor: written out here on
    its own, not with the port's layout helper."""
    leaf = flax_key.rsplit("/", 1)[-1]
    parts = list(jspec) + [None] * 4
    qkv = any(f"attention/{m}/" in flax_key
              for m in ("query", "key", "value"))
    out = "attention/out/" in flax_key
    if leaf == "kernel":
        if qkv:                       # [H, heads, hd] -> [heads*hd, H]
            assert parts[2] is None
            return (parts[1], parts[0])
        if out:                       # [heads, hd, H] -> [H, heads*hd]
            assert parts[1] is None
            return (parts[2], parts[0])
        return (parts[1], parts[0])   # [in, out] -> [out, in]
    if leaf == "bias" and qkv:        # [heads, hd] -> [heads*hd]
        assert parts[1] is None
        return (parts[0],)
    return tuple(parts[:ndim_torch])


def _torch_name(flax_key):
    names = []
    for p in flax_key.split("/"):
        if p.startswith("layer_"):
            names += ["layers", p[len("layer_"):]]
        elif p in ("kernel", "embedding", "scale"):
            names.append("weight")
        else:
            names.append(p)
    return ".".join(names)


MODELS = {
    "gpt_tiny": (lambda: jgpt.GPTLMHeadModel(jgpt.gpt_tiny_config()),
                 lambda: tgpt.GPTLMHeadModel(
                     tgpt.gpt_tiny_config(), device="meta"),
                 jsharding.gpt_partition_rules,
                 tsharding.gpt_partition_rules, 512),
    "gpt2_small": (lambda: jgpt.GPTLMHeadModel(jgpt.gpt2_small_config()),
                   lambda: tgpt.GPTLMHeadModel(
                       tgpt.gpt2_small_config(), device="meta"),
                   jsharding.gpt_partition_rules,
                   tsharding.gpt_partition_rules, 50257),
    "bert_tiny": (lambda: jbert.BertForMaskedLM(jbert.bert_tiny_config()),
                  lambda: tbert.BertForMaskedLM(
                      tbert.bert_tiny_config(), device="meta"),
                  jsharding.bert_partition_rules,
                  tsharding.bert_partition_rules, 512),
}
MESHES = [({"dp": 2, "tp": 2}, None), ({"fsdp": 2, "tp": 2}, "fsdp"),
          ({"dp": 4}, None)]


@pytest.fixture(scope="module")
def abstract_params():
    out = {}
    for name, (jmodel, *_rest) in MODELS.items():
        ids = jnp.zeros((2, 8), jnp.int32)
        shapes = jax.eval_shape(jmodel().init, jax.random.PRNGKey(0), ids)
        out[name] = shapes["params"]
    return out


@pytest.mark.parametrize("axes,fsdp", MESHES,
                         ids=["dp2_tp2", "fsdp2_tp2", "dp4"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_placements_follow_the_jax_rules(model, axes, fsdp,
                                         abstract_params):
    _, tmodel, jrules, trules, _ = MODELS[model]
    jm = jmesh.build_mesh(dict(axes), devices=jax.devices()[:4])
    jspecs = _flat(jsharding.infer_shardings(
        abstract_params[model], jm, jrules(fsdp=fsdp)))
    with torch.device("meta"):
        tm = tmodel()
    got = tsharding.infer_shardings(tm, axes, trules(fsdp=fsdp))
    assert set(got) == {_torch_name(k) for k in jspecs}
    for key, sharding in jspecs.items():
        name = _torch_name(key)
        want = _expected_torch_spec(key, sharding.spec,
                                    len(got[name].spec))
        assert tuple(got[name].spec) == want, (name, sharding.spec)


@pytest.fixture(scope="module")
def resnet50_params():
    from horovod_tpu.models import resnet as jresnet
    model = jresnet.ResNet50(num_classes=1000)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    return shapes["params"]


@pytest.mark.parametrize("axes,fsdp", [({"fsdp": 2, "tp": 2}, "fsdp"),
                                       ({"fsdp": 4}, "fsdp"),
                                       ({"dp": 4}, None)],
                         ids=["fsdp2_tp2", "fsdp4", "dp4"])
def test_resnet_placements_follow_the_jax_rules(axes, fsdp,
                                                resnet50_params):
    """``resnet_partition_rules`` on the port's ResNet-50 (built on the
    ``meta`` device), as a module and as a state dict with
    ``resnet.flax_path``, against the JAX rules on flax's: every
    parameter named by the converter's map, conv kernels HWIO as weights
    OIHW, the head's kernel ``[in, out]`` as its weight ``[out, in]``;
    the state dict's BN statistics replicated."""
    from horovod_tpu_torch.models import resnet as tresnet
    jm = jmesh.build_mesh(dict(axes), devices=jax.devices()[:4])
    jspecs = _flat(jsharding.infer_shardings(
        resnet50_params, jm, jsharding.resnet_partition_rules(fsdp=fsdp)))
    with torch.device("meta"):
        tm = tresnet.ResNet50(device="meta")
    rules = tsharding.resnet_partition_rules(fsdp=fsdp)
    got = tsharding.infer_shardings(tm, axes, rules)
    got_sd = tsharding.infer_shardings(
        tm.state_dict(), axes, rules,
        flax_path=partial(tresnet.flax_path, block="BottleneckResNetBlock"))
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    ndims = {k: len(v.shape) for k, v in _flat(resnet50_params).items()}
    want = {}
    for key, sharding in jspecs.items():
        *mod, leaf = key.split("/")
        spec = list(sharding.spec) + [None] * 4
        if leaf == "kernel" and ndims[key] == 4:
            spec = (spec[3], spec[2], spec[0], spec[1])
        elif leaf == "kernel":
            spec = (spec[1], spec[0])
        else:
            spec = tuple(spec[:ndims[key]])
        want[f"{tresnet._module_path(mod)}.{leaves[leaf]}"] = tuple(spec)
    assert len(want) == 161
    assert {n: tuple(s.spec) for n, s in got.items()} == want
    assert want["head.weight"] == ((None, fsdp) if fsdp else (None, None))
    stats = {n: (None,) for n, _ in tm.named_buffers()}
    assert len(stats) == 2 * 53
    assert {n: tuple(s.spec) for n, s in got_sd.items()} == {**want,
                                                              **stats}


def test_vocab_sharding_follows_fit_spec():
    """GPT-2 small's vocab (50257, odd) is not tp-sharded; BERT-base's
    (30522) is; the tiny ones' (512) are."""
    axes = {"dp": 2, "tp": 2}
    with torch.device("meta"):
        g = tgpt.GPTLMHeadModel(tgpt.gpt2_small_config(), device="meta")
        b = tbert.BertForMaskedLM(tbert.bert_base_config(), device="meta")
    gs = tsharding.infer_shardings(g, axes, tsharding.gpt_partition_rules())
    bs = tsharding.infer_shardings(b, axes,
                                   tsharding.bert_partition_rules())
    assert tuple(gs["word_embeddings.weight"].spec) == (None, None)
    assert tuple(bs["encoder.word_embeddings.weight"].spec) == ("tp", None)
    assert tuple(bs["mlm_bias"].spec) == ("tp",)
    assert tuple(gs["layers.0.attention.query.weight"].spec) == \
        ("tp", None)
    assert [repr(p) for p in gs["layers.0.attention.out.weight"]
            .placements(2)] == ["Replicate()", "Shard(dim=1)"]


def test_state_dict_needs_num_heads_for_attention():
    sd = {"layers.0.attention.query.weight": torch.zeros(64, 64),
          "layers.0.intermediate.weight": torch.zeros(128, 64)}
    rules = tsharding.gpt_partition_rules()
    with pytest.raises(ValueError, match="num_heads"):
        tsharding.infer_shardings(sd, {"tp": 2}, rules)
    got = tsharding.infer_shardings(sd, {"tp": 2}, rules, num_heads=4)
    assert tuple(got["layers.0.attention.query.weight"].spec) == \
        ("tp", None)
    assert tuple(got["layers.0.intermediate.weight"].spec) == ("tp", None)


def test_spec_placements_nest_in_mesh_order():
    axes = {"dp": 2, "tp": 2}
    assert [repr(p) for p in tmesh.spec_placements(
        (("dp", "tp"), None), axes, 2)] == ["Shard(dim=0)", "Shard(dim=0)"]
    with pytest.raises(ValueError, match="mesh order"):
        tmesh.spec_placements((("tp", "dp"),), axes, 1)
    with pytest.raises(ValueError, match="shards two dims"):
        tmesh.spec_placements(("dp", "dp"), axes, 2)


# ---------------------------------------------------------------------------
# collectives: four gloo ranks against four virtual devices
# ---------------------------------------------------------------------------

def _inputs(seed):
    rng = np.random.RandomState(seed)
    return {
        "v": rng.randn(4, 3).astype(np.float32),
        "pos": (rng.rand(4, 3) + 0.5).astype(np.float32),
        "rows": rng.randn(8, 2).astype(np.float32),
        "cols": rng.randn(4, 2).astype(np.float32),
        "rs": rng.randn(8, 3).astype(np.float32),
        "rs1": rng.randn(3, 8).astype(np.float32),
        "a2a": np.arange(16, dtype=np.float32).reshape(4, 4),
        "a2a1": rng.randn(4, 8).astype(np.float32),
        "g": rng.randn(2, 2).astype(np.float32),
        "h": rng.randn(2, 2).astype(np.float32),
        "hu": rng.randn(3, 5).astype(np.float32),
        "counts": rng.randint(0, 9, (4, 4)).astype(np.int32),
        "ada": rng.randn(4, 11).astype(np.float32) *
        np.arange(1, 5, dtype=np.float32)[:, None],
        "hada": rng.randn(2, 2, 11).astype(np.float32),
        "c": rng.randn(4, 3).astype(np.float32),
    }


# (name, mesh axes, fn source, in_specs, out_specs, input, grad): the fn
# source runs with ``par`` (either package's parallel.collectives), ``P`` (its
# PartitionSpec), ``adasum`` and ``hadasum`` (its in-graph Adasums).
CASES = [
    ("allreduce_sum", {"dp": 4}, "lambda a: par.allreduce_sum(a, 'dp')",
     "P('dp')", "P('dp')", "v", False),
    ("allreduce_mean", {"dp": 4}, "lambda a: par.allreduce_mean(a, 'dp')",
     "P('dp')", "P('dp')", "v", False),
    ("allreduce_min", {"dp": 4}, "lambda a: par.allreduce_min(a, 'dp')",
     "P('dp')", "P('dp')", "v", False),
    ("allreduce_max", {"dp": 4}, "lambda a: par.allreduce_max(a, 'dp')",
     "P('dp')", "P('dp')", "v", False),
    ("allreduce_prod", {"dp": 4}, "lambda a: par.allreduce_prod(a, 'dp')",
     "P('dp')", "P('dp')", "pos", False),
    ("allgather", {"dp": 4}, "lambda a: par.allgather(a, 'dp', axis=0)",
     "P('dp')", "P('dp')", "rows", True),
    ("allgather_axis1", {"dp": 4},
     "lambda a: par.allgather(a, 'dp', axis=1)", "P('dp')", "P('dp')",
     "cols", False),
    ("allgather_untiled", {"dp": 4},
     "lambda a: par.allgather(a, 'dp', axis=0, tiled=False)", "P('dp')",
     "P('dp')", "cols", False),
    ("reduce_scatter", {"dp": 4},
     "lambda a: par.reduce_scatter(a, 'dp', axis=0)", "P(None, None)",
     "P('dp', None)", "rs", False),
    ("reduce_scatter_axis1", {"dp": 4},
     "lambda a: par.reduce_scatter(a, 'dp', axis=1)", "P(None, None)",
     "P(None, 'dp')", "rs1", False),
    ("broadcast", {"dp": 4},
     "lambda a: par.broadcast(a, root_rank=2, axis_name='dp')", "P('dp')",
     "P('dp')", "v", False),
    ("alltoall", {"dp": 4},
     "lambda a: par.alltoall(a[0], 'dp', split_axis=0, concat_axis=0)"
     "[None]", "P('dp')", "P('dp')", "a2a", True),
    ("alltoall_split1", {"dp": 4},
     "lambda a: par.alltoall(a, 'dp', split_axis=1, concat_axis=0)",
     "P('dp')", "P('dp')", "a2a1", True),
    ("neighbor_shift", {"dp": 4},
     "lambda a: par.neighbor_shift(a, 1, 'dp')", "P('dp')", "P('dp')", "v",
     True),
    ("neighbor_shift_back", {"dp": 4},
     "lambda a: par.neighbor_shift(a, -1, 'dp')", "P('dp')", "P('dp')",
     "v", False),
    ("ppermute_partial", {"dp": 4},
     "lambda a: par.ppermute(a, [(0, 1), (1, 0)], 'dp')", "P('dp')",
     "P('dp')", "v", True),
    ("axis_index", {"dp": 4}, "lambda a: a * 0 + par.axis_index('dp')",
     "P('dp')", "P('dp')", "v", False),
    ("axis_size", {"dp": 4}, "lambda a: a * 0 + par.axis_size('dp')",
     "P('dp')", "P('dp')", "v", False),
    ("allreduce_two_axes", {"dp": 2, "tp": 2},
     "lambda a: par.allreduce_sum(a, ('dp', 'tp'))", "P('dp', 'tp')",
     "P('dp', 'tp')", "g", False),
    ("allreduce_tp", {"dp": 2, "tp": 2},
     "lambda a: par.allreduce_sum(a, 'tp')", "P('dp', 'tp')",
     "P('dp', 'tp')", "g", False),
    ("allgather_two_axes", {"dp": 2, "tp": 2},
     "lambda a: par.allgather(a, ('dp', 'tp'), axis=0)",
     "P(('dp', 'tp'))", "P(('dp', 'tp'))", "v", False),
    ("axis_index_two_axes", {"dp": 2, "tp": 2},
     "lambda a: a * 0 + par.axis_index(('dp', 'tp'))", "P('dp', 'tp')",
     "P('dp', 'tp')", "g", False),
    ("hierarchical_allreduce", {"cross": 2, "local": 2},
     "lambda a: par.hierarchical_allreduce_sum(a, 'local', 'cross')",
     "P('cross', 'local')", "P('cross', 'local')", "h", False),
    ("hierarchical_allreduce_uneven", {"cross": 2, "local": 2},
     "lambda a: par.hierarchical_allreduce_sum(a, 'local', 'cross')",
     "P(None, None)", "P(None, None)", "hu", False),
    ("alltoallv_counts", {"dp": 4},
     "lambda c: par.alltoallv(c, c[0], 'dp')[1][None]", "P('dp')",
     "P('dp')", "counts", False),
    ("adasum", {"dp": 4}, "lambda a: adasum(a[0], 'dp', 4)[None]",
     "P('dp')", "P('dp')", "ada", False),
    ("adasum_hierarchical", {"cross": 2, "local": 2},
     "lambda a: hadasum(a[0, 0], 'local', 'cross', 2)[None, None]",
     "P('cross', 'local')", "P('cross', 'local')", "hada", False),
]
CASES_BY_NAME = {c[0]: c for c in CASES}

_PORT_BODY = """
import json, os, torch
import numpy as np
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from horovod_tpu_torch import parallel as pp
from horovod_tpu_torch.parallel import collectives as C
par = C
from horovod_tpu_torch.parallel import mesh as M
from horovod_tpu_torch.ops.adasum import (adasum_reduce_ingraph as adasum,
                                          adasum_hierarchical_ingraph as hadasum)
P = M.P
spec = json.loads(os.environ["CASES"])
inputs = dict(np.load(os.environ["INPUTS"]))
res, info = {}, {}
meshes = {}
for name, axes, src, ins, outs, key, grad in spec:
    k = tuple(axes.items())
    if k not in meshes:
        meshes[k] = pp.build_mesh(axes, device_type="cpu")
    fn = par.shard_map(eval(src), meshes[k], eval(ins), eval(outs))
    x = torch.from_numpy(inputs[key])
    if grad:
        x.requires_grad_()
    y = fn(x)
    res[name] = y.detach().numpy()
    if grad:
        (y * torch.from_numpy(inputs[name + "_c"])).sum().backward()
        res[name + "_grad"] = x.grad.numpy()

m = pp.build_mesh({"dp": 2, "tp": 2}, device_type="cpu")
info["grid"] = m.mesh.tolist()
info["names"] = list(m.mesh_dim_names)
info["coord"] = m.get_coordinate()
info["default"] = [list(pp.build_mesh(device_type="cpu").mesh_dim_names),
                   pp.build_mesh(device_type="cpu").mesh.tolist()]
os.environ["HOROVOD_TPU_MESH_AXES"] = "dp:2,tp:-1"
e = pp.build_mesh(device_type="cpu")
info["env"] = [list(e.mesh_dim_names), e.mesh.tolist()]
del os.environ["HOROVOD_TPU_MESH_AXES"]
h = pp.build_hierarchical_mesh(device_type="cpu")
info["hier"] = [list(h.mesh_dim_names), h.mesh.tolist()]
os.environ["HOROVOD_CROSS_RANK"] = "1" if RANK == 3 else "0"
h = pp.build_hierarchical_mesh(device_type="cpu")
info["hier_unequal"] = [list(h.mesh_dim_names), h.mesh.tolist()]
lm = pp.local_mesh("dp", device_type="cpu")
info["local"] = [lm.mesh.tolist(), pp.mesh_axis_size(lm, "dp")]
one = par.shard_map(lambda a: par.allreduce_sum(a, "dp"), lm, P(), P())(
    torch.tensor([float(RANK)]))
info["local_sum"] = one.tolist()

d4 = pp.build_mesh({"dp": 4}, device_type="cpu")
with C.count_collectives() as cc:
    par.shard_map(lambda a: par.allreduce_sum(a, "dp"), d4, P("dp"), P())(
        torch.arange(4.0))
    t = distribute_tensor(torch.arange(8.0), d4, [Shard(0)],
                          src_data_rank=None)
    full = t.full_tensor()
info["counted"] = [cc.bytes, cc.calls, full.tolist()]
C._register_route("CPU")
calls0, bytes0 = C.route_calls, C.route_bytes
full = distribute_tensor(torch.arange(8.0).reshape(4, 2), d4, [Shard(0)],
                         src_data_rank=None).full_tensor()
info["route"] = [C.route_calls - calls0, C.route_bytes - bytes0,
                 full.tolist()]
# A group that carries its tensors itself gathers them in place.
rides = C._cuda_rides_gloo
C._cuda_rides_gloo = lambda group=None: False
calls0, bytes0 = C.route_calls, C.route_bytes
full = distribute_tensor(torch.arange(8.0).reshape(4, 2), d4, [Shard(0)],
                         src_data_rank=None).full_tensor()
info["route_in_place"] = [C.route_calls - calls0, C.route_bytes - bytes0,
                          full.tolist()]
C._cuda_rides_gloo = rides
info["gloo_cuda"] = C.install_gloo_cuda_route()
info["world_rides_gloo"] = C._cuda_rides_gloo(d4.get_group("dp"))

# Axis groups live on their mesh: a mesh freed and another of another
# shape built after it resolve "dp" each to their own ranks.
import gc
a = pp.build_mesh({"dp": 4}, device_type="cpu")
dp_sum = lambda m: par.shard_map(lambda x: par.allreduce_sum(x, "dp"), m,
                                 P(), P())(torch.tensor([float(RANK)]))
s4 = dp_sum(a).tolist()
del a
gc.collect()
b = pp.build_mesh({"dp": 2, "tp": 2}, device_type="cpu")
info["rebuilt"] = [s4, dp_sum(b).tolist(),
                   [list(k) for k in getattr(b, C._GROUPS_ATTR)],
                   hasattr(C, "_GROUPS")]
info["pg_of_tp"] = C.axis_group("tp", b) is b.get_group("tp")
hvd.shutdown()
info["route_after_shutdown"] = C._ROUTE_LIB is None
if RANK == 0:
    np.savez(os.environ["OUT"], **res)
print("INFO " + json.dumps(info), flush=True)
"""


def _jax_case(case, inputs, grads=True):
    name, axes, src, ins, outs, key, grad = case
    mesh = jmesh.build_mesh(dict(axes), devices=jax.devices()[:4])
    env = {"par": jcollectives, "P": JP, "adasum": j_adasum,
           "hadasum": j_hadasum}
    fn = jax.jit(jcollectives.shard_map(eval(src, env), mesh=mesh,
                                in_specs=eval(ins, env),
                                out_specs=eval(outs, env), check_vma=False))
    x = jnp.asarray(inputs[key])
    out = {name: np.asarray(fn(x))}
    if grad and grads:
        c = jnp.asarray(inputs[name + "_c"])
        out[name + "_grad"] = np.asarray(
            jax.grad(lambda x: jnp.sum(fn(x) * c))(x))
    return out


@pytest.fixture(scope="module")
def collective_runs():
    inputs = _inputs(7)
    rng = np.random.RandomState(8)
    want = {}
    for case in CASES:
        if case[6]:
            shape = _jax_case(case, inputs, grads=False)[case[0]].shape
            inputs[case[0] + "_c"] = rng.randn(*shape).astype(np.float32)
    for case in CASES:
        want.update(_jax_case(case, inputs))
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **inputs)
        out = os.path.join(d, "out.npz")
        results = run_port_workers(
            _PORT_BODY, nproc=4,
            per_rank_env=lambda r: {"HOROVOD_LOCAL_RANK": r % 2,
                                    "HOROVOD_LOCAL_SIZE": 2,
                                    "HOROVOD_CROSS_RANK": r // 2,
                                    "HOROVOD_CROSS_SIZE": 2},
            extra_env={"OMP_NUM_THREADS": "1", "CASES": json.dumps(CASES),
                       "INPUTS": os.path.join(d, "in.npz"), "OUT": out},
            timeout=LAUNCH_TIMEOUT_S)
        for rc, text in results:
            assert rc == 0, "\n".join(t[-2500:] for _, t in results)
        got = dict(np.load(out))
    infos = [json.loads(next(l for l in text.splitlines()
                             if l.startswith("INFO "))[5:])
             for _, text in results]
    return want, got, infos


EXACT = {"allgather", "allgather_axis1", "allgather_untiled", "broadcast",
         "alltoall", "alltoall_split1", "neighbor_shift",
         "neighbor_shift_back", "ppermute_partial", "axis_index",
         "axis_size", "allgather_two_axes", "axis_index_two_axes",
         "alltoallv_counts", "allreduce_min", "allreduce_max"}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_collective_matches_jax(name, collective_runs):
    want, got, _ = collective_runs
    assert got[name].shape == want[name].shape
    if name in EXACT:
        np.testing.assert_array_equal(got[name], want[name])
    elif name.startswith("adasum"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-6)
    if CASES_BY_NAME[name][6]:
        np.testing.assert_allclose(got[name + "_grad"],
                                   want[name + "_grad"], rtol=1e-6,
                                   atol=1e-6)


def test_mesh_layout_matches_jax(collective_runs):
    _, _, infos = collective_runs
    jm = jmesh.build_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    ids = [[d.id for d in row] for row in jm.devices]
    for rank, info in enumerate(infos):
        assert info["names"] == list(jm.axis_names)
        assert info["grid"] == ids == [[0, 1], [2, 3]]
        assert info["coord"] == [rank // 2, rank % 2]
        assert info["default"] == [["dp"], [0, 1, 2, 3]]
        assert info["env"] == [["dp", "tp"], [[0, 1], [2, 3]]]
        # Two hosts of two ranks (the launcher's cross ranks); one host
        # with three ranks beside one with one gives the flat mesh.
        assert info["hier"] == [["cross", "local"], [[0, 1], [2, 3]]]
        assert info["hier_unequal"] == [["cross", "local"],
                                        [[0, 1, 2, 3]]]
        assert info["local"] == [[rank], 1]
        assert info["local_sum"] == [float(rank)]


def test_collective_bytes_are_counted_and_the_route_gathers(
        collective_runs):
    _, _, infos = collective_runs
    for info in infos:
        counted_bytes, counted_calls, full = info["counted"]
        assert counted_bytes["all_reduce"] == 4
        assert counted_calls["all_reduce"] == 1
        assert counted_bytes["all_gather"] == 8
        assert full == list(range(8))
        calls, nbytes, full = info["route"]
        assert (calls, nbytes) == (1, 8)
        assert full == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
        assert info["route_in_place"] == [0, 0, full]
        assert info["gloo_cuda"] is False      # no card here
        assert info["world_rides_gloo"] is True
        # hvd.shutdown() gives the functional all-gather its own kernels.
        assert info["route_after_shutdown"] is True


def test_axis_groups_live_on_their_mesh(collective_runs):
    _, _, infos = collective_runs
    for rank, info in enumerate(infos):
        on_dp4, on_dp2, cached, global_cache = info["rebuilt"]
        assert on_dp4 == [6.0]
        assert on_dp2 == [[2.0, 4.0][rank % 2]]     # ranks 0+2, 1+3
        assert cached == [["dp"]] and global_cache is False
        assert info["pg_of_tp"] is True


@pytest.mark.parametrize("config,rides", [
    ("gloo", True), ("cpu:gloo,cuda:gloo", True),
    ("cpu:gloo,cuda:nccl", False), ("nccl", False)])
def test_route_stages_only_where_gloo_carries_cuda(config, rides,
                                                   monkeypatch):
    import torch.distributed as dist
    seen = []
    monkeypatch.setattr(dist, "get_backend_config",
                        lambda group=None: seen.append(group) or config)
    group = object()
    assert tcollectives._cuda_rides_gloo(group) is rides
    assert seen == [group]
