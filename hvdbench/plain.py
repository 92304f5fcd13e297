"""Plain PyTorch pieces the references share: seeded draws, where a
reference rounds (:class:`Precision`), gradient clipping and the
optimizers' update rules, written out from their published formulas.  Imports nothing of the port."""

import contextlib
import hashlib
import math

import torch


def seed_of(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by ``tags`` under run seed
    ``seed``: distinct tags give unrelated streams."""
    text = "/".join(str(t) for t in (int(seed),) + tags)
    return int(hashlib.sha256(text.encode()).hexdigest()[:15], 16)


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, *tags))
    return g


def draw_weights(specs, seed: int, device) -> dict:
    """fp32 tensors for ``specs``: ``(name, shape, init, std)`` with init
    ``normal`` (N(0, std^2)), ``ones`` or ``zeros``.  The normal leaves
    come from one ``randn`` on ``device``, split and scaled."""
    normal = [(n, s, std) for n, s, init, std in specs if init == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.randn(total, generator=generator(device, seed, "weights"),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std in normal:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    for name, shape, init, _ in specs:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init != "normal":
            raise ValueError(f"unknown init {init!r} for {name}")
    return {name: out[name] for name, *_ in specs}


@contextlib.contextmanager
def full_fp32():
    """fp32 products in full fp32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _Round(torch.autograd.Function):
    """Round the value on the way forward and its gradient on the way
    back, each through ``fn``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad), None, None


def _scaled(dtype, top):
    """Rounding to ``dtype`` under one per-tensor scale (the tensor's
    largest magnitude onto ``top``), as fp8 training scales a tensor."""
    def fn(x):
        scale = x.abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(dtype).to(x.dtype) * scale
    return fn


def _plain(dtype):
    return lambda x: x.to(dtype).to(torch.float32)


def keep(x):
    return x


def bf16(x):
    """``x`` held in bfloat16, as the port holds it, and its gradient."""
    return _Round.apply(x, _plain(torch.bfloat16), _plain(torch.bfloat16))


# float8 e4m3 for a product's operands (largest finite 448), e5m2 for
# the gradient of its output (57344): the recipe of fp8 training.
_E4M3 = _scaled(torch.float8_e4m3fn, 448.0)
_E5M2 = _scaled(torch.float8_e5m2, 57344.0)


def fp8(x):
    """``x`` held in float8 where the port holds bfloat16, and its
    gradient in e5m2."""
    return _Round.apply(x, _E4M3, _E5M2)


def fp8_operand(x):
    """A matmul's or convolution's operand in float8 e4m3; the gradient
    that reaches it stays in bfloat16."""
    return _Round.apply(x, _E4M3, _plain(torch.bfloat16))


def fp8_product(y):
    """A matmul's or convolution's output, unchanged on the way forward;
    its gradient, the operand of the backward products, in float8 e5m2."""
    return _Round.apply(y, keep, _E5M2)


class Precision:
    """Where a reference rounds.  ``value`` wherever the configuration
    computes in its 16-bit type; ``operand`` on every operand of a
    matmul or convolution that the configuration computes in that type
    (``value`` where not given); ``product`` on such a product's output
    before anything is added to it (unchanged where not given)."""

    def __init__(self, value=keep, operand=None, product=keep):
        self.value = value
        self.operand = operand or value
        self.product = product


# The reference proper; the bf16 witness (the configuration's own
# precision); the controls, one precision below its bf16: fp8 products
# (everything else as configured, the step a faster program would take
# first) and fp8 wherever the configuration computes in bf16.
FP32 = Precision()
BF16 = Precision(bf16)
FP8_PRODUCTS = Precision(bf16, fp8_operand, fp8_product)
FP8 = Precision(fp8)


def clip_(grads: dict, max_norm: float):
    """``torch.nn.utils.clip_grad_norm_``'s rule: scale every gradient by
    max_norm / (total norm + 1e-6) where that is below 1."""
    total = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads.values():
        g.mul_(coef)


class AdamW:
    """Decoupled weight decay (Loshchilov and Hutter), applied first, on
    the leaves ``decay(name)`` picks; bias-corrected moments."""

    def __init__(self, params: dict, lr, betas, eps, weight_decay, decay):
        self.lr, self.betas, self.eps = lr, tuple(betas), eps
        self.wd, self.decay = weight_decay, decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            if self.decay(n, p):
                p.mul_(1 - self.lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[n].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[n], denom, value=-self.lr / bc1)


class SGD:
    """Plain SGD: p -= lr * g."""

    def __init__(self, params: dict, lr):
        self.lr = lr

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        for n, p in params.items():
            p.add_(grads[n], alpha=-self.lr)


def train(params: dict, batches, grads_of, optimizer, clip=None) -> dict:
    """Three (or ``len(batches)``) data-parallel steps from ``params``
    (changed in place).  ``batches[i][r]`` is rank ``r``'s batch of step
    ``i``; ``grads_of(params, batch)`` returns (loss, grads) of one
    rank's batch.  The ranks' gradients are averaged, clipped to ``clip``
    and applied.  Returns each step's loss per rank, each leaf's
    gradient norm as the optimizer got it in step 1, and each leaf's
    change over all the steps."""
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, grad_norms = [], None
    for i, ranks in enumerate(batches):
        total, step_losses = None, []
        for batch in ranks:
            loss, grads = grads_of(params, batch)
            step_losses.append(float(loss))
            if total is None:
                total = grads
            else:
                for n in total:
                    total[n].add_(grads[n])
        for g in total.values():
            g.div_(len(ranks))
        if clip is not None:
            clip_(total, clip)
        if i == 0:
            grad_norms = leaf_norms(total)
        optimizer.step(params, total)
        losses.append(step_losses)
    update = leaf_norms({n: params[n] - start[n] for n in params})
    return {"loss": losses, "grad_norms": grad_norms,
            "update_norms": update}


def leaf_norms(tensors: dict) -> dict:
    """Each tensor's 2-norm, in fp32, as Python floats."""
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                         for n in names]).tolist()
    return dict(zip(names, norms))
