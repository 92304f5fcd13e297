"""Expert parallelism: Switch-style top-1 MoE dispatch over a mesh axis.

Counterpart of :mod:`horovod_tpu.parallel.moe`: capacity-bucketed
one-hot dispatch → :func:`~.collectives.alltoall` to the expert owners →
expert FFN → all-to-all back → gate-weighted combine, inside
:func:`~.collectives.shard_map`.  One expert per ``ep``-axis rank;
tokens over capacity are dropped (standard Switch semantics).  Dispatch
and combine run in fp32, and every step is differentiable through the
all-to-alls' autograd rules.
"""

from typing import Callable

import torch
import torch.nn.functional as F

from .collectives import allreduce_mean, alltoall, axis_size


def top1_dispatch(gate_logits: torch.Tensor, capacity: int):
    """Build the Switch dispatch/combine tensors for top-1 routing.

    ``gate_logits``: [T, E].  Returns (dispatch [T, E, C] one-hot,
    combine [T, E, C] gate-weighted, aux_loss scalar), all fp32.  An
    ``argmax`` tie goes to the first maximum, as in JAX.
    """
    T, E = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)                          # [T]
    gate = probs.amax(dim=-1)                              # [T]
    onehot = F.one_hot(expert, E).float()                  # [T, E]
    # Position of each token within its expert's bucket.
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0       # [T, E]
    keep = (pos < capacity) & (onehot > 0)
    pos_oh = F.one_hot(pos.clamp(0, capacity - 1).long(),
                       capacity).float()                   # [T, E, C]
    dispatch = pos_oh * keep[..., None].float()
    combine = dispatch * gate[:, None, None]
    # Load-balancing auxiliary loss (Switch eq. 4):
    # aux = E * sum_i f_i * P_i, where f_i is the fraction of tokens
    # routed to expert i and P_i the mean router probability for it.
    density = onehot.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * E
    return dispatch, combine, aux


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, expert_fn: Callable,
            expert_params, axis_name: str = "ep",
            capacity_factor: float = 2.0):
    """Expert-parallel MoE layer body (call inside shard_map).

    Per rank: ``x`` [T, D] local tokens, ``expert_params`` the ONE
    local expert's parameters, ``gate_w`` [D, E] replicated gating
    weights with E == axis size.  Returns ([T, D], aux_loss averaged
    over the axis).
    """
    n = axis_size(axis_name)
    T, D = x.shape
    capacity = max(1, int(capacity_factor * T / n))

    logits = x @ gate_w                                    # [T, E]
    dispatch, combine, aux = top1_dispatch(logits, capacity)

    # [T,E,C] x [T,D] -> [E, C, D]: tokens bucketed per target expert.
    buckets = torch.einsum("tec,td->ecd", dispatch, x.float())
    # Exchange: rank e receives its expert's bucket from every peer
    # -> [n, C, D] (peer-major).
    received = alltoall(buckets, axis_name, split_axis=0, concat_axis=0)
    out = expert_fn(expert_params, received.reshape(n * capacity, D))
    out = out.reshape(n, capacity, D)
    # Route results back to the token owners.
    returned = alltoall(out, axis_name, split_axis=0, concat_axis=0)
    y = torch.einsum("tec,ecd->td", combine, returned.float())
    return y.to(x.dtype), allreduce_mean(aux, axis_name)
