"""The port's ResNet, MNIST models and ``SyncBatchNorm`` against the JAX
package's.

* ResNet-18 and ResNet-50 (10 classes) from the flax models' variables
  through ``convert_flax_resnet_params``, with every BN scale, bias and
  running statistic drawn at random (so that no zero-initialised scale
  hides a block): the train-mode logits, the ``batch_stats`` that
  forward leaves, and the eval-mode logits on the updated statistics.
  fp32 at 1e-4 and bf16 at 3e-2, each relative to the largest value
  compared.  The bf16 cases take 8 images of 64x64: the last stage's
  statistics then cover 32 values per channel; over fewer, BN amplifies
  bf16's rounding past the gap between flax's own bf16 and fp32 runs.
* flax's ``SAME`` at stride 2 pads (0, 1) on an even size: the port's
  max-pool and stride-2 convolution equal flax's, and torchvision's
  ``padding=1`` does not.
* ``MnistMLP`` and ``MnistCNN`` logits from converted flax parameters
  (fp32, 1e-5), and ``cross_entropy_loss``.
* ``SyncBatchNorm`` at 2 gloo ranks through each package's binding on
  the same numpy inputs: outputs, input/weight/bias gradients and the
  running statistics agree to 1e-5, and equal ``nn.BatchNorm2d`` on the
  two halves concatenated (the weight and bias gradients summed over
  the ranks); at size 1 and in eval mode it is torch's BatchNorm, as in
  the JAX binding.
"""

import os

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from horovod_tpu.models import mnist as jmnist
from horovod_tpu.models import resnet as jresnet
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models import resnet as tresnet

from multiproc import assert_all_ok, run_workers
from test_torch_port_multiproc import WORKER_TIMEOUT_S, run_port_workers


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _randomize(tree, rng, scale, shift):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray((rng.randn(*a.shape) * scale + shift)
                              .astype(np.float32)), tree)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


# (model, image size, batch, flax dtype, port dtype, tolerance)
RESNET_CASES = [
    ("ResNet18", 32, 4, jnp.float32, torch.float32, 1e-4),
    ("ResNet50", 64, 4, jnp.float32, torch.float32, 1e-4),
    ("ResNet18", 64, 8, jnp.bfloat16, torch.bfloat16, 3e-2),
    ("ResNet50", 64, 8, jnp.bfloat16, torch.bfloat16, 3e-2),
]


@pytest.mark.parametrize("name,size,batch,jdt,tdt,tol", RESNET_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[4]}".replace("torch.", "")
                              for c in RESNET_CASES])
def test_resnet_matches_flax(name, size, batch, jdt, tdt, tol):
    rng = np.random.RandomState(5)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    jm = getattr(jresnet, name)(num_classes=10, dtype=jdt)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))

    def draw(a):
        # Kernels at variance 1 / fan_in; BN scales (and the head bias)
        # around 1 and biases around 0, all random.
        if a.ndim == 1:
            return rng.randn(*a.shape) * 0.5 + 1.0
        return rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))

    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(draw(a).astype(np.float32)), shapes["params"])
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray((rng.rand(*a.shape) + 0.5).astype(np.float32)),
        shapes["batch_stats"])
    # Compiled: one XLA program per mode costs less here than the
    # per-primitive compiles of eager flax.
    logits, updated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    eval_logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": updated["batch_stats"]},
        jnp.asarray(x))

    tm = getattr(tresnet, name)(num_classes=10, dtype=tdt, device="cpu")
    sd = tresnet.convert_flax_resnet_params(params, stats)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(_nchw(x), train=True)
        _close(got.numpy(), logits, tol, "train logits")
        want_sd = tresnet.convert_flax_resnet_params(
            params, updated["batch_stats"])
        for key, value in tm.state_dict().items():
            if "running" in key:
                _close(value.numpy(), want_sd[key].numpy(), tol, key)
        tm.eval()
        _close(tm(_nchw(x)).numpy(), eval_logits, tol, "eval logits")


def test_resnet50_has_the_flax_parameter_count():
    jm = jresnet.ResNet50(num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    n_flax = sum(int(np.prod(a.shape)) for a in
                 jax.tree_util.tree_leaves(shapes["params"]))
    tm = tresnet.ResNet50(num_classes=1000, device="meta")
    params = list(tm.parameters())
    assert sum(p.numel() for p in params) == n_flax == 25557032
    assert len(params) == 161


@pytest.mark.parametrize("size", [8, 7])
def test_same_max_pool_matches_flax(size):
    x = np.random.RandomState(6).randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding="SAME"))
    got = tresnet.max_pool_same(_nchw(x), 3, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    torchvision = F.max_pool2d(_nchw(x), 3, 2, padding=1).permute(0, 2, 3, 1)
    gap = np.abs(torchvision.numpy() - want).max()
    if size % 2 == 0:
        assert gap > 0.5          # (1, 1) is not SAME on an even size
    else:
        assert gap == 0.0


def test_same_stride2_conv_matches_flax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    conv = nn.Conv(5, (3, 3), (2, 2), use_bias=False, dtype=jnp.float32)
    variables = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    kernel = np.asarray(variables["params"]["kernel"])
    port = tresnet.Conv(4, 5, 3, 2, dtype=torch.float32)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
        torchvision = F.conv2d(_nchw(x), port.weight, None, 2, 1).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(torchvision - want).max() > 0.1


@pytest.mark.parametrize("size,kernel,stride,want", [
    (112, 3, 2, (0, 1)), (56, 3, 1, (1, 1)), (7, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)), (28, 3, 2, (0, 1))])
def test_same_padding_rule(size, kernel, stride, want):
    assert tresnet.same_padding(size, kernel, stride) == want


@pytest.mark.parametrize("kind", ["MnistMLP", "MnistCNN"])
def test_mnist_matches_flax(kind):
    rng = np.random.RandomState(8)
    x = rng.rand(4, 28, 28, 1).astype(np.float32)
    jm = getattr(jmnist, kind)()
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = _randomize(variables["params"], rng, 0.05, 0.0)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = getattr(tmnist, kind)(device="cpu")
    sd = tmnist.convert_flax_mnist_params({"params": params})
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(_nchw(x)).numpy()
        got_3d = tm(torch.from_numpy(x[..., 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_3d, got, rtol=1e-6, atol=1e-6)
    labels = rng.randint(0, 10, 4)
    np.testing.assert_allclose(
        float(tmnist.cross_entropy_loss(torch.from_numpy(got),
                                        torch.from_numpy(labels))),
        float(jmnist.cross_entropy_loss(jnp.asarray(got),
                                        jnp.asarray(labels))), rtol=1e-6)


# ---------------------------------------------------------------------------
# SyncBatchNorm
# ---------------------------------------------------------------------------

BN_SHAPE = (6, 3, 5, 4)           # per rank: N, C, H, W

_BN_BODY = """
import torch
torch.manual_seed(0)

def draw(rank):
    rng = np.random.RandomState(20 + rank)
    return (rng.randn(*SHAPE).astype(np.float32) * (rank + 1) + rank,
            rng.randn(*SHAPE).astype(np.float32))

x_np, dy_np = draw(RANK)
bn = T.SyncBatchNorm(SHAPE[1], momentum=0.3)
with torch.no_grad():
    bn.weight.copy_(torch.linspace(0.5, 1.5, SHAPE[1]))
    bn.bias.copy_(torch.linspace(-1.0, 1.0, SHAPE[1]))
out = {}
for step in range(2):
    x = torch.from_numpy(x_np * (step + 1)).requires_grad_()
    bn.zero_grad()
    y = bn(x)
    y.backward(torch.from_numpy(dy_np))
    out[f"y{step}"] = y.detach().numpy()
    out[f"dx{step}"] = x.grad.numpy()
    out[f"dw{step}"] = bn.weight.grad.numpy()
    out[f"db{step}"] = bn.bias.grad.numpy()
out["running_mean"] = bn.running_mean.numpy()
out["running_var"] = bn.running_var.numpy()
out["tracked"] = bn.num_batches_tracked.numpy()
bn.eval()
out["eval"] = bn(torch.from_numpy(x_np)).detach().numpy()
np.savez(os.path.join(os.environ["RESULT_DIR"], f"{PKG}-{RANK}.npz"), **out)
print("BODY DONE", RANK)
"""


def _bn_reference(steps=2):
    """nn.BatchNorm2d on the two ranks' inputs concatenated."""
    draws = []
    for rank in range(2):
        rng = np.random.RandomState(20 + rank)
        draws.append((rng.randn(*BN_SHAPE).astype(np.float32) * (rank + 1)
                      + rank, rng.randn(*BN_SHAPE).astype(np.float32)))
    bn = torch.nn.BatchNorm2d(BN_SHAPE[1], momentum=0.3)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, BN_SHAPE[1]))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, BN_SHAPE[1]))
    out = {}
    for step in range(steps):
        x = torch.from_numpy(np.concatenate(
            [d[0] * (step + 1) for d in draws])).requires_grad_()
        bn.zero_grad()
        y = bn(x)
        y.backward(torch.from_numpy(np.concatenate([d[1] for d in draws])))
        out[f"y{step}"] = y.detach().numpy()
        out[f"dx{step}"] = x.grad.numpy()
        out[f"dw{step}"] = bn.weight.grad.numpy()
        out[f"db{step}"] = bn.bias.grad.numpy()
    out["running_mean"] = bn.running_mean.numpy()
    out["running_var"] = bn.running_var.numpy()
    bn.eval()
    out["eval"] = bn(torch.from_numpy(np.concatenate(
        [d[0] for d in draws]))).detach().numpy()
    return out


@pytest.fixture(scope="module")
def sync_bn_runs(tmp_path_factory):
    result_dir = str(tmp_path_factory.mktemp("sync_bn"))
    env = {"RESULT_DIR": result_dir, "OMP_NUM_THREADS": "1"}
    body = f"SHAPE = {BN_SHAPE!r}\n" + _BN_BODY
    jax_results = run_workers(
        "import horovod_tpu.torch as T\nPKG = 'jax'\n" + body, nproc=2,
        timeout=WORKER_TIMEOUT_S, extra_env=env)
    port_results = run_port_workers("T = hvd\nPKG = 'port'\n" + body,
                                    nproc=2, extra_env=env)
    assert_all_ok(jax_results)
    assert_all_ok(port_results)
    runs = {}
    for pkg in ("jax", "port"):
        runs[pkg] = []
        for r in range(2):
            with np.load(os.path.join(result_dir, f"{pkg}-{r}.npz")) as f:
                runs[pkg].append({k: f[k] for k in f.files})
    return runs


SYNC_BN_KEYS = [f"{k}{s}" for s in range(2) for k in ("y", "dx", "dw", "db")
                ] + ["running_mean", "running_var", "eval"]


@pytest.mark.parametrize("key", SYNC_BN_KEYS)
def test_sync_batch_norm_matches_jax_and_batchnorm(key, sync_bn_runs):
    ref = _bn_reference()
    n = BN_SHAPE[0]
    for r in range(2):
        got = sync_bn_runs["port"][r][key]
        np.testing.assert_allclose(got, sync_bn_runs["jax"][r][key],
                                   rtol=1e-5, atol=1e-5)
        if key[:-1] in ("dw", "db"):
            whole = ref[key]
            got = sum(sync_bn_runs["port"][q][key] for q in range(2))
        elif key in ("running_mean", "running_var"):
            whole = ref[key]
        else:
            # eval normalizes with the rank's own running statistics,
            # which are the global ones: the same on both ranks.
            whole = ref[key][r * n:(r + 1) * n]
        np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)
    assert sync_bn_runs["port"][0]["tracked"] == 2


@pytest.fixture(scope="module")
def world_of_one():
    import horovod_tpu.torch as jhvd
    import horovod_tpu_torch.torch as hvd
    jhvd.init()
    hvd.init()
    yield jhvd, hvd
    hvd.shutdown()
    jhvd.shutdown()


@pytest.mark.parametrize("training", [True, False])
def test_sync_batch_norm_at_size_one_is_batchnorm(training, world_of_one):
    jhvd, hvd = world_of_one
    rng = np.random.RandomState(9)
    x_np = rng.randn(*BN_SHAPE).astype(np.float32) * 2 + 1
    dy = torch.from_numpy(rng.randn(*BN_SHAPE).astype(np.float32))
    outs = []
    for make in (hvd.SyncBatchNorm, jhvd.SyncBatchNorm,
                 torch.nn.BatchNorm2d):
        bn = make(BN_SHAPE[1])
        bn.train(training)
        x = torch.from_numpy(x_np).requires_grad_()
        y = bn(x)
        y.backward(dy)
        outs.append([y.detach(), x.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean, bn.running_var])
    for got, jax_ref, torch_ref in zip(*outs):
        assert torch.equal(got, torch_ref)
        assert torch.equal(got, jax_ref)
