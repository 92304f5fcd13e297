"""Sharded training steps for the flagship models.

Counterpart of :mod:`horovod_tpu.training`, the core training path: one
step per model whose parameters, optimizer state and batch are laid
out over a named mesh (dp / fsdp / tp / sp).  Every parameter is a
``DTensor`` placed by the partition rules
(:mod:`horovod_tpu_torch.parallel.sharding`), so each optimizer moment
takes its parameter's placement; the batch is a ``DTensor`` sharded
over the batch axes; DTensor's propagation inserts the all-gathers,
reduce-scatters and all-reduces where XLA's GSPMD inserts them.  Two
points are explicit: before the forward, parameters sharded over a
non-tensor-parallel axis (fsdp) are gathered over it for use (the
all-gather-on-use of ZeRO-3; its backward reduce-scatters the
gradients), and after the backward each gradient is brought to its
parameter's placement (the data-parallel all-reduce).  Attention runs
on each rank's own shards (``parallel.layers.on_local_shards``), which is
where the flash kernel sees local tensors.

The pipeline x expert-parallel and ring-attention dry runs hold no
DTensor: their bodies run per rank inside ``parallel.shard_map`` on
plain tensors, with the collectives explicit.

This is not the Horovod per-gradient API (``horovod_tpu_torch.torch``).
The steps run eagerly; there is no compiled program.
"""

import dataclasses
import logging
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.func import functional_call

from .models.bert import BertConfig, BertForMaskedLM, mlm_loss
from .parallel.mesh import NamedSharding, P, mesh_shape
from .parallel.sharding import (Rules, bert_partition_rules,
                                gpt_partition_rules, shard_tree)


def factor_mesh_axes(n_devices: int,
                     names: Tuple[str, ...] = ("dp", "tp", "sp"),
                     absorb: str = "dp") -> Dict[str, int]:
    """Factor a device count into 2s over the named axes, in order.

    8 → first three axes get 2; 4 → first two; 2 → first.  Any
    leftover factor — everything beyond one 2 per axis, plus any odd
    factor — is absorbed into ``absorb`` (the data axis by default:
    dp tolerates any size, while tp/sp must divide model/sequence
    dims).  Examples: 16 → dp=4,tp=2,sp=2; 6 → dp=6; 12 → dp=6,tp=2.
    For device counts that are not powers of two a warning notes the
    lopsided absorption.
    """
    if not names:
        raise ValueError("names must be non-empty")
    if absorb not in names:
        raise ValueError(f"absorb={absorb!r} is not one of {names}")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    axes = {name: 1 for name in names}
    rest = n_devices
    for name in names:
        if rest % 2 == 0:
            axes[name] = 2
            rest //= 2
    axes[absorb] *= rest
    if rest > 1 and rest % 2:
        logging.getLogger("horovod_tpu_torch.training").warning(
            "factor_mesh_axes: %d devices has odd factor %d, absorbed "
            "into %r -> %s; pass an explicit axis dict for a different "
            "layout", n_devices, rest, absorb, axes)
    return axes


# ---------------------------------------------------------------------------
# the two explicit points of a sharded step
# ---------------------------------------------------------------------------

def gathered_parameters(model: torch.nn.Module, keep_axes=("tp",)
                        ) -> Dict[str, DTensor]:
    """Each DTensor parameter sharded over a mesh axis not in
    ``keep_axes``, gathered over that axis: what the forward uses in
    place of the parameter (``torch.func.functional_call``).  Its
    backward is the reduce-scatter of the gradient."""
    views = {}
    for name, p in model.named_parameters():
        if not isinstance(p, DTensor):
            continue
        names = p.device_mesh.mesh_dim_names
        want = tuple(Replicate() if n not in keep_axes and pl.is_shard()
                     else pl for n, pl in zip(names, p.placements))
        if want != tuple(p.placements):
            views[name] = p.redistribute(p.device_mesh, want)
    return views


def sync_gradients(model: torch.nn.Module):
    """Bring each DTensor gradient to its parameter's placement: a
    gradient left partial over a batch axis is all-reduced (replicated
    parameter) or reduce-scattered (sharded one)."""
    for p in model.parameters():
        g = p.grad
        if isinstance(g, DTensor) and \
                tuple(g.placements) != tuple(p.placements):
            p.grad = g.redistribute(p.device_mesh, p.placements)


def _replicated_value(loss: torch.Tensor) -> torch.Tensor:
    if isinstance(loss, DTensor):
        return loss.full_tensor().detach()
    return loss.detach()


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The model (its parameters placed on the mesh), its optimizer and
    the step counter: what the JAX package's ``TrainState`` holds."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_bert_pretrain_step(
        config: BertConfig, mesh,
        learning_rate: float = 1e-4,
        rules: Optional[Rules] = None,
        donate: bool = True,
        dropout_seed: int = 0,
) -> Tuple[Callable, NamedSharding]:
    """Returns ``(make_step, batch_sharding)``.

    ``make_step(example_batch)`` returns ``(init_fn, step_fn)``:
    ``init_fn(seed=0, batch=None, state_dict=None)`` builds the model on
    the mesh's device (from ``seed``, or with ``state_dict``'s weights),
    places it by the rules and gives a :class:`TrainState` with AdamW
    (weight decay 0.01 on every parameter, as ``optax.adamw``);
    ``step_fn(state, batch)`` returns ``(state, loss)``.
    ``batch_sharding`` shards a batch over (dp, sp).

    * parameters and moments sharded by the Megatron-style rules
      (tp [+ fsdp]);
    * dropout active whenever the config's rates are non-zero, from a
      generator seeded by ``dropout_seed`` and the step;
    * the loss is the global masked mean: DTensor sums the numerator
      and the denominator over the batch axes before dividing.

    ``donate`` and ``example_batch`` are the JAX signature's (there the
    batch's shapes lay out the compiled state); parameters are updated
    in place either way.
    """
    del donate
    axes = mesh_shape(mesh)
    tp = "tp" if "tp" in axes else None
    rules = rules or bert_partition_rules(
        tp=tp, fsdp="fsdp" if "fsdp" in axes else None)
    deterministic = (config.hidden_dropout == 0.0
                     and config.attention_dropout == 0.0)
    batch_sharding = NamedSharding(mesh, P("dp" if "dp" in axes else None,
                                           "sp" if "sp" in axes else None))

    def make_step(example_batch=None):
        def init_fn(seed: int = 0, batch=None, state_dict=None
                    ) -> TrainState:
            model = BertForMaskedLM(config, device=mesh.device_type,
                                    seed=seed)
            if state_dict is not None:
                model.load_state_dict(state_dict)
            shard_tree(model, mesh, rules)
            opt = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                    weight_decay=0.01)
            return TrainState(model, opt)

        def step_fn(state: TrainState, batch):
            batch = {k: batch_sharding.distribute(v)
                     for k, v in batch.items()}
            model, opt = state.model, state.optimizer
            generator = None
            if not deterministic:
                generator = torch.Generator(batch["input_ids"].device)
                generator.manual_seed(dropout_seed * 2 ** 32 + state.step)
            opt.zero_grad(set_to_none=True)
            logits = functional_call(
                model, gathered_parameters(model, (tp,)),
                (batch["input_ids"],),
                dict(token_type_ids=batch.get("token_type_ids"),
                     attention_mask=batch.get("attention_mask"),
                     deterministic=deterministic, generator=generator))
            loss = mlm_loss(logits, batch["labels"], batch["mask"])
            loss.backward()
            sync_gradients(model)
            opt.step()
            state.step += 1
            return state, _replicated_value(loss)

        return init_fn, step_fn

    return make_step, batch_sharding


def make_bert_batch(batch_size: int, seq_len: int, vocab_size: int,
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX package's batch (same numpy draws) as CPU int32 tensors:
    ``input_ids``, ``labels`` and a 15 % ``mask``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    input_ids = rng.randint(0, vocab_size, (batch_size, seq_len),
                            dtype=np.int32)
    labels = rng.randint(0, vocab_size, (batch_size, seq_len),
                         dtype=np.int32)
    mask = (rng.rand(batch_size, seq_len) < 0.15).astype(np.int32)
    return {"input_ids": torch.from_numpy(input_ids),
            "labels": torch.from_numpy(labels),
            "mask": torch.from_numpy(mask)}


def run_bert_dry_run(n_devices: int, config: Optional[BertConfig] = None,
                     batch_size: int = 8, seq_len: int = 64, *,
                     device_type: Optional[str] = None):
    """One full sharded pretraining step on an ``n_devices``-rank mesh
    with tiny shapes; every rank of the world calls it."""
    from .models.bert import bert_tiny_config
    from .parallel.mesh import build_mesh

    config = config or bert_tiny_config(max_position_embeddings=seq_len)
    mesh = build_mesh(factor_mesh_axes(n_devices), device_type=device_type)
    make_step, _ = make_bert_pretrain_step(config, mesh)
    batch = make_bert_batch(batch_size, seq_len, config.vocab_size)
    init_fn, step_fn = make_step(batch)
    state = init_fn(0, batch)
    state, loss = step_fn(state, batch)
    return float(loss), mesh


# ---------------------------------------------------------------------------
# GPT
# ---------------------------------------------------------------------------

def make_gpt_train_step(config, mesh, learning_rate: float = 1e-2,
                        fsdp: Optional[str] = None):
    """Sharded dp x tp causal-LM training step for the GPT family.
    Returns ``(init_fn, step_fn, batch_sharding)``:
    ``init_fn(seed=0, ids=None, state_dict=None)`` gives ``(model,
    optimizer)`` (Adam, as ``optax.adam``) with the parameters placed by
    ``gpt_partition_rules``; ``step_fn(model, optimizer, ids)`` gives
    ``(model, optimizer, loss)``.  The step is deterministic (no
    dropout), as the JAX step's ``apply``.

    ``fsdp`` names a mesh axis to ZeRO-3-shard parameters and optimizer
    state over; the batch shards along the same axis (that axis is the
    data axis under FSDP): all-gather on use, reduce-scatter of the
    gradients."""
    from .models.gpt import GPTLMHeadModel, lm_loss

    batch_sharding = NamedSharding(mesh, P(fsdp or "dp", None))
    rules = gpt_partition_rules(fsdp=fsdp)

    def init_fn(seed: int = 0, ids=None, state_dict=None):
        model = GPTLMHeadModel(config, device=mesh.device_type, seed=seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        model.eval()
        shard_tree(model, mesh, rules)
        return model, torch.optim.Adam(model.parameters(), lr=learning_rate)

    def step_fn(model, optimizer, ids):
        ids = batch_sharding.distribute(ids)
        optimizer.zero_grad(set_to_none=True)
        logits = functional_call(model, gathered_parameters(model), (ids,))
        loss = lm_loss(logits, ids)
        loss.backward()
        sync_gradients(model)
        optimizer.step()
        return model, optimizer, _replicated_value(loss)

    return init_fn, step_fn, batch_sharding


def _random_ids(batch_size: int, seq_len: int, vocab_size: int
                ) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, vocab_size, (batch_size, seq_len), generator=g)


def run_gpt_fsdp_dry_run(n_devices: int, batch_size: int = 8,
                         seq_len: int = 16, *,
                         device_type: Optional[str] = None):
    """One fsdp x tp ZeRO-3-sharded causal-LM training step on an
    ``n_devices``-rank mesh; every rank of the world calls it."""
    from .models.gpt import gpt_tiny_config
    from .parallel.mesh import build_mesh

    cfg = gpt_tiny_config()
    tp = 2 if n_devices % 2 == 0 else 1
    fsdp = n_devices // tp
    mesh = build_mesh({"fsdp": fsdp, "tp": tp}, device_type=device_type)
    batch_size = -(-max(batch_size, 2 * fsdp) // fsdp) * fsdp
    ids = _random_ids(batch_size, seq_len, cfg.vocab_size)
    init_fn, step_fn, _ = make_gpt_train_step(cfg, mesh, fsdp="fsdp")
    model, opt = init_fn(1, ids)
    model, opt, loss = step_fn(model, opt, ids)
    return float(loss), mesh


def run_gpt_dry_run(n_devices: int, batch_size: int = 8,
                    seq_len: int = 16, *,
                    device_type: Optional[str] = None):
    """One dp x tp sharded causal-LM training step on an
    ``n_devices``-rank mesh with tiny shapes; every rank calls it."""
    from .models.gpt import gpt_tiny_config
    from .parallel.mesh import build_mesh

    cfg = gpt_tiny_config()
    axes = factor_mesh_axes(n_devices)
    dp = axes["dp"] * axes.get("sp", 1)
    mesh = build_mesh({"dp": dp, "tp": axes.get("tp", 1)},
                      device_type=device_type)
    # Round the batch up to a multiple of the dp axis.
    batch_size = -(-max(batch_size, 2 * dp) // dp) * dp
    ids = _random_ids(batch_size, seq_len, cfg.vocab_size)
    init_fn, step_fn, _ = make_gpt_train_step(cfg, mesh)
    model, opt = init_fn(1, ids)
    model, opt, loss = step_fn(model, opt, ids)
    return float(loss), mesh


# ---------------------------------------------------------------------------
# pipeline x expert parallelism, and ring attention
# ---------------------------------------------------------------------------

def pipeline_moe_inputs(axes: Dict[str, int], microbatches: int = 4,
                        tokens: int = 8, dim: int = 16):
    """The pipeline-MoE dry run's inputs, the JAX package's numpy draws
    (``RandomState(0)``): stage kernels ``[S, dim, dim]``, gates ``[S,
    dim, E]``, experts ``[S, E, dim, dim]`` and microbatches ``[M, dp x
    tokens, dim]``, fp32 numpy arrays."""
    import numpy as np
    S, E = axes["pp"], axes["ep"]
    rng = np.random.RandomState(0)
    Ws = rng.randn(S, dim, dim).astype(np.float32) * 0.2
    gate_w = rng.randn(S, dim, E).astype(np.float32)
    expert_W = rng.randn(S, E, dim, dim).astype(np.float32) * 0.2
    x = rng.randn(microbatches, axes["dp"] * tokens,
                  dim).astype(np.float32)
    return Ws, gate_w, expert_W, x


def make_pipeline_moe_step(mesh) -> Callable:
    """The pipeline-MoE dry run's step on a ``{pp, ep, dp}`` mesh:
    ``step(Ws, gate_w, expert_W, x)`` on whole tensors gives ``(loss,
    (dWs, dgate_w, dexpert_W))``, the loss averaged over ep and dp and
    the gradients over dp, whole on every rank.  Each pipeline stage is
    a tanh dense layer, then a Switch-MoE (all-to-all over ep, capacity
    factor 4) added as a residual; microbatches stream GPipe-style over
    pp."""
    from .parallel.collectives import allreduce_mean, shard_map
    from .parallel.moe import moe_ffn
    from .parallel.pipeline import pipeline_apply

    def expert_fn(W, h):
        return torch.tanh(h @ W[0])

    def stage(params, h):
        W, gw, eW = params
        h = torch.tanh(h @ W[0])
        y, _aux = moe_ffn(h, gw[0], expert_fn, eW[0], axis_name="ep",
                          capacity_factor=4.0)
        return h + y

    def grads_fn(Ws, gate_w, expert_W, xm):
        params = tuple(t.detach().requires_grad_()
                       for t in (Ws, gate_w, expert_W))
        out = pipeline_apply(stage, params, xm, axis_name="pp",
                             vary_axes=("ep", "dp"))
        loss = torch.mean(out ** 2)
        grads = torch.autograd.grad(loss, params)
        # Gradient data parallelism over dp.
        grads = tuple(allreduce_mean(g, "dp") for g in grads)
        return allreduce_mean(loss.detach(), ("ep", "dp")), grads

    return shard_map(
        grads_fn, mesh,
        in_specs=(P("pp"), P("pp"), P("pp", "ep"), P(None, "dp")),
        out_specs=(P(), (P("pp"), P("pp"), P("pp", "ep"))))


def run_pipeline_moe_dry_run(n_devices: int, microbatches: int = 4,
                             tokens: int = 8, dim: int = 16, *,
                             device_type: Optional[str] = None):
    """One differentiable pipeline-parallel + expert-parallel training
    step on a {pp, ep, dp} mesh (:func:`make_pipeline_moe_step` on
    :func:`pipeline_moe_inputs`); every rank of the world calls it.
    Returns ``(loss, mesh)``."""
    from .parallel.mesh import build_mesh

    axes = factor_mesh_axes(n_devices, names=("pp", "ep", "dp"))
    mesh = build_mesh(axes, device_type=device_type)
    args = [torch.from_numpy(a).to(mesh.device_type)
            for a in pipeline_moe_inputs(axes, microbatches, tokens, dim)]
    loss, _grads = make_pipeline_moe_step(mesh)(*args)
    return float(loss), mesh


def run_ring_attention_dry_run(n_devices: int, seq_per_dev: int = 8,
                               heads: int = 4, dim: int = 8, *,
                               device_type: Optional[str] = None):
    """Ring attention over an sp-axis mesh: one causal forward+backward
    (the gradient of the mean square output with respect to q) on a
    sequence sharded across every rank; fails on a NaN gradient.
    Returns the mesh."""
    import numpy as np
    from .parallel.attention import ring_attention
    from .parallel.collectives import shard_map
    from .parallel.mesh import build_mesh

    mesh = build_mesh({"sp": n_devices}, device_type=device_type)
    rng = np.random.RandomState(0)
    S = n_devices * seq_per_dev
    q, k, v = (torch.from_numpy(rng.randn(1, S, heads, dim).astype(
        np.float32)).to(mesh.device_type) for _ in range(3))

    def grad_q(q, k, v):
        q = q.detach().requires_grad_()
        loss = torch.mean(
            ring_attention(q, k, v, axis_name="sp", causal=True) ** 2)
        return torch.autograd.grad(loss, q)[0]

    g = shard_map(grad_q, mesh, in_specs=(P(None, "sp"),) * 3,
                  out_specs=P(None, "sp"))(q, k, v)
    assert not torch.isnan(g).any(), \
        "ring attention produced NaN gradients"
    return mesh
