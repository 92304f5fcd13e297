"""Expert parallelism: Switch-style top-1 MoE dispatch over a mesh axis,
and a dropless top-k expert layer that holds a range of the experts.

Counterpart of :mod:`horovod_tpu.parallel.moe`: capacity-bucketed
one-hot dispatch → :func:`~.collectives.alltoall` to the expert owners →
expert FFN → all-to-all back → gate-weighted combine, inside
:func:`~.collectives.shard_map`.  One expert per ``ep``-axis rank;
tokens over capacity are dropped (standard Switch semantics).  Dispatch
and combine run in fp32, and every step is differentiable through the
all-to-alls' autograd rules.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..common.timeline import span
from ..ops import moe_gemm
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


# ---------------------------------------------------------------------------
# Dropless top-k experts, told which experts this rank holds
# ---------------------------------------------------------------------------

class _Fp32Linear(torch.autograd.Function):
    """``x W^T`` in fp32 from a 16-bit ``x``, saving ``x`` as it came
    (the fp32 copy is made again in the backward, not kept)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return torch.matmul(x.float(), weight.float().t())

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = torch.matmul(dy, weight.float()).to(x.dtype)
        dw = torch.matmul(dy.t(), x.float()).to(weight.dtype)
        return dx, dw


def topk_route(logits: torch.Tensor, k: int,
               expert_bias: Optional[torch.Tensor] = None,
               norm_topk_prob: bool = True,
               routed_scaling_factor: float = 1.0):
    """Sigmoid routing over all experts: ``logits`` [T, E] (fp32) ->
    (experts [T, k], weights [T, k] fp32).  The top ``k`` of the scores
    plus ``expert_bias`` are chosen (the bias picks, it does not weigh);
    their unbiased scores are the weights, normalised by their sum +
    1e-6 when ``norm_topk_prob``, times ``routed_scaling_factor``."""
    scores = torch.sigmoid(logits.float())
    pick = scores if expert_bias is None else scores + expert_bias.float()
    experts = torch.topk(pick, k, dim=-1).indices
    weights = scores.gather(1, experts)
    if norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-6)
    return experts, weights * routed_scaling_factor


def dispatch(experts: torch.Tensor, weights: torch.Tensor, held: range,
             rows: int):
    """Lay out the assignments to the held experts for the grouped
    products, on the device and without a synchronisation.  ``experts``,
    ``weights`` [T, k] from :func:`topk_route`; ``rows`` is the layout's
    fixed length, :func:`layout_rows`.  Returns (counts [len(held)] int64,
    offsets [len(held) + 1] int32, row_token [rows] int64, row_weight
    [rows] fp32): expert ``held[e]``'s assignments fill rows
    ``offsets[e] ..``, in token order, each row naming its token and its
    weight; every other row (the padding to a whole tile and the unused
    tail) names token T, a zero row, with weight 0."""
    T, k = experts.shape
    E = len(held)
    flat = experts.reshape(-1)
    mine = (flat >= held.start) & (flat < held.stop)
    # Bucket E gathers the assignments to experts held elsewhere.
    key = torch.where(mine, flat - held.start, torch.full_like(flat, E))
    order = torch.argsort(key, stable=True)
    key_sorted = key.gather(0, order)
    counts = torch.zeros(E + 1, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    counts = counts[:E]
    offsets = moe_gemm.padded_offsets(counts)
    first = torch.cumsum(counts, 0) - counts  # of each expert, unpadded
    e = key_sorted.clamp(max=E - 1)
    j = torch.arange(T * k, device=flat.device)
    pos = torch.where(key_sorted < E,
                      offsets.long().gather(0, e) + j - first.gather(0, e),
                      torch.full_like(j, rows))
    row_token = torch.full((rows + 1,), T, dtype=torch.int64,
                           device=flat.device)
    row_token.scatter_(0, pos, order // k)
    row_weight = weights.new_zeros(rows + 1).scatter(
        0, pos, weights.reshape(-1).gather(0, order))
    return counts, offsets, row_token[:rows], row_weight[:rows]


def layout_rows(tokens: int, k: int, held: int) -> int:
    """Rows of :func:`dispatch`'s layout: the most assignments the held
    experts can get, each expert padded to a whole tile."""
    align = moe_gemm.ALIGN
    most = tokens * min(k, held)
    return -(-most // align) * align + held * align


def _swiglu_grads(h13, dact, inter):
    """d(silu(h1) * h3) / d(h1, h3) times ``dact``, in fp32, as one
    [R, 2I] tensor in ``h13``'s type."""
    h1, h3 = h13[:, :inter].float(), h13[:, inter:].float()
    s = torch.sigmoid(h1)
    dact = dact.float()
    d1 = dact * h3 * s * (1.0 + h1 * (1.0 - s))
    d3 = dact * h1 * s
    return torch.cat([d1, d3], dim=1).to(h13.dtype)


def _stack13(w1, w3, dtype):
    """[E, 2I, H] in ``dtype``: w1's rows, then w3's."""
    E, inter, H = w1.shape
    out = torch.empty(E, 2 * inter, H, dtype=dtype, device=w1.device)
    out[:, :inter].copy_(w1)
    out[:, inter:].copy_(w3)
    return out


class _ExpertFFN(torch.autograd.Function):
    """The held experts' SwiGLU ``w2(silu(w1 x) * w3 x)`` over
    :func:`dispatch`'s layout and the weighted scatter-add back to the
    tokens, in ``x``'s type with fp32 sums.  Saves ``x``, the layout and
    ``[w1 x, w3 x]``; the gathered rows and the activation are made again
    in the backward."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2, row_weight, row_token, offsets):
        T, H = x.shape
        inter = w1.shape[1]
        with span("moe.experts"):
            xg = torch.cat([x, x.new_zeros(1, H)]).index_select(0, row_token)
            h13 = moe_gemm.grouped_rows(xg, _stack13(w1, w3, x.dtype),
                                        offsets)
            act = F.silu(h13[:, :inter]) * h13[:, inter:]
            y = moe_gemm.grouped_rows(act, w2.to(x.dtype), offsets)
        with span("moe.combine"):
            out = torch.zeros(T + 1, H, dtype=torch.float32, device=x.device)
            out.index_add_(0, row_token, y.float() * row_weight[:, None])
        ctx.save_for_backward(x, w1, w3, w2, row_weight, row_token, offsets,
                              h13)
        return out[:T].to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, w1, w3, w2, row_weight, row_token, offsets, h13 = \
            ctx.saved_tensors
        T, H = x.shape
        inter = w1.shape[1]
        dt = x.dtype
        with span("moe.bwd"):
            xg = torch.cat([x, x.new_zeros(1, H)]).index_select(0, row_token)
            act = F.silu(h13[:, :inter]) * h13[:, inter:]
            dg = torch.cat([dout.to(dt), dout.new_zeros(1, H, dtype=dt)]
                           ).index_select(0, row_token)
            # g = dout[token] . w2, before the routing weight: it gives
            # both the weight's gradient and the activation's.
            g = moe_gemm.grouped_rows(
                dg, w2.to(dt).transpose(1, 2).contiguous(), offsets)
            d_weight = (g.float() * act.float()).sum(dim=1)
            dact = (g.float() * row_weight[:, None]).to(dt)
            dy = (dg.float() * row_weight[:, None]).to(dt)
            dw2 = moe_gemm.grouped_k(dy.t().contiguous(),
                                     act.t().contiguous(), offsets)
            dh13 = _swiglu_grads(h13, dact, inter)
            dw13 = moe_gemm.grouped_k(dh13.t().contiguous(),
                                      xg.t().contiguous(), offsets)
            dxg = moe_gemm.grouped_rows(
                dh13, _stack13(w1, w3, dt).transpose(1, 2).contiguous(),
                offsets)
            dx = torch.zeros(T + 1, H, dtype=torch.float32, device=x.device)
            dx.index_add_(0, row_token, dxg.float())
        return (dx[:T].to(dt), dw13[:, :inter].to(w1.dtype),
                dw13[:, inter:].to(w3.dtype), dw2.to(w2.dtype), d_weight,
                None, None)


class DroplessMoE(nn.Module):
    """A top-k, dropless expert layer that holds the experts ``held`` of
    ``num_experts`` (all of them by default) and routes over all of them:
    each token's ``k`` experts are picked by sigmoid score plus
    ``expert_bias`` (a buffer, not trained here; None without
    ``use_expert_bias``) and weighed by their
    unbiased scores (:func:`topk_route`); this layer computes the part of
    the result its own experts give, ``sum_j w_j w2_j(silu(w1_j x) * w3_j
    x)`` over the chosen held experts.  The rest of the sum is another
    rank's; on one rank nothing is exchanged.

    The router runs in fp32; the experts in the input's type through the
    grouped products of :mod:`..ops.moe_gemm`, with no host
    synchronisation in the forward or the backward.  Parameters:
    ``gate.weight`` [num_experts, H] and the held experts' stacked
    ``w1``, ``w3`` [len(held), I, H] and ``w2`` [len(held), H, I]."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, k: int, held: Optional[range] = None,
                 norm_topk_prob: bool = True,
                 routed_scaling_factor: float = 1.0,
                 use_expert_bias: bool = True):
        super().__init__()
        held = range(num_experts) if held is None else held
        if held.step != 1 or not 0 <= held.start < held.stop <= num_experts:
            raise ValueError(f"held experts {held} are not a range inside "
                             f"0 .. {num_experts}")
        self.held, self.k = held, k
        self.norm_topk_prob = norm_topk_prob
        self.routed_scaling_factor = routed_scaling_factor
        self.gate = nn.Linear(hidden_size, num_experts, bias=False)
        self.register_buffer("expert_bias", torch.zeros(num_experts)
                             if use_expert_bias else None)
        E = len(held)
        self.w1 = nn.Parameter(torch.empty(E, intermediate_size, hidden_size))
        self.w3 = nn.Parameter(torch.empty(E, intermediate_size, hidden_size))
        self.w2 = nn.Parameter(torch.empty(E, hidden_size, intermediate_size))
        for w in (self.w1, self.w3, self.w2):
            nn.init.normal_(w, std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [T, H] -> [T, H] in ``x``'s type."""
        with span("moe.route"):
            logits = _Fp32Linear.apply(x, self.gate.weight)
            experts, weights = topk_route(
                logits, self.k, self.expert_bias, self.norm_topk_prob,
                self.routed_scaling_factor)
        with span("moe.dispatch"):
            rows = layout_rows(x.shape[0], self.k, len(self.held))
            counts, offsets, row_token, row_weight = dispatch(
                experts, weights, self.held, rows)
        return _ExpertFFN.apply(x, self.w1, self.w3, self.w2, row_weight,
                                row_token, offsets)
