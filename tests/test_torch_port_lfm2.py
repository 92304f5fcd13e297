"""The port's LFM2-MoE (``horovod_tpu_torch.models.lfm2``) and its
dropless expert layer (``parallel/moe.py``) against the plain fp32
reference ``tests/plain_lfm2.py`` on seeded random weights, at a tiny
size on the CPU: the model's logits, loss and gradients, the expert
shares of expert parallelism, routing, the short convolution's
causality, the grouped products' plain path, and the benchmark's copy of
the reference.  The CUDA kernels are held against the plain path on the
card by ``tests/test_torch_port_cuda.py``."""

import json
import os

import pytest
import torch

from horovod_tpu_torch.models import gpt, lfm2
from horovod_tpu_torch.ops import moe_gemm
from horovod_tpu_torch.parallel import moe

import plain_lfm2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPES = ["conv", "conv", "full_attention", "conv", "conv", "full_attention"]
# The tiny shape: hidden 64, 4 query and 2 key/value heads of 16, two
# dense layers, 8 of 32 experts held, top 4.
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=6,
            num_attention_heads=4, num_key_value_heads=2, layer_types=TYPES,
            num_dense_layers=2, num_experts=32, num_experts_per_tok=4,
            use_expert_bias=True, norm_topk_prob=True,
            routed_scaling_factor=1.0, conv_L_cache=3, conv_bias=False,
            norm_eps=1e-5, rope_theta=1e6, max_position_embeddings=128)
HELD = range(8, 16)


def _model(dtype=torch.float32, attention_impl="plain", held=HELD, seed=0):
    cfg = lfm2.LFM2MoEConfig.from_dict(TINY, experts_held=held, dtype=dtype,
                                       attention_impl=attention_impl,
                                       initializer_range=0.2)
    model = lfm2.LFM2MoEForCausalLM(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("expert_bias"):
                b.copy_(0.3 * torch.randn(b.shape, generator=g))
    return model


def _ids(B=2, S=24, seed=0):
    return torch.randint(0, TINY["vocab_size"], (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _leaves(model):
    """Parameters (requiring grad) and buffers, by ``state_dict`` name."""
    w = {n: p.detach().clone().requires_grad_(True)
         for n, p in model.named_parameters()}
    w.update({n: b.clone() for n, b in model.named_buffers()})
    return w


# fp32 on both sides; the sums run in other orders (the expert layer
# sums a token's experts in a scatter-add, attention in another
# association), so the loss agrees to 1e-6 of itself, the logits to
# 2e-5 of their largest, and every gradient to 1e-4 of its largest
# entry (a 1 ulp change of fp32 moves a sum of 64 terms by ~1e-6).
@pytest.mark.parametrize("attention_impl", ["plain", "flash"])
def test_port_matches_plain_reference_in_fp32(attention_impl):
    model = _model(attention_impl=attention_impl)
    ids = _ids()
    w = _leaves(model)
    logits = model(ids)
    loss = gpt.lm_loss(logits, ids)
    loss.backward()
    ref_logits = plain_lfm2.forward(w, ids, TINY, HELD)
    ref_loss = plain_lfm2.loss_of(w, ids, TINY, HELD)
    ref_loss.backward()
    scale = ref_logits.abs().max()
    assert (logits - ref_logits).abs().max() <= 2e-5 * scale
    assert abs(loss.item() - ref_loss.item()) <= 1e-6 * ref_loss.item()
    grads = dict(model.named_parameters())
    assert set(grads) == {n for n, t in w.items() if t.requires_grad}
    for name, p in grads.items():
        ref = w[name].grad
        assert ref is not None and p.grad is not None, name
        tol = 1e-4 * ref.abs().max() + 1e-12
        assert (p.grad - ref).abs().max() <= tol, name


def test_expert_shares_sum_to_the_uncut_layer():
    """Four ranks' expert layers, each holding 8 of the 32 experts and
    routing over all 32, give parts that add up to the whole layer of
    the reference (fp32: 1e-5 of the output's largest entry)."""
    H, Im, E = TINY["hidden_size"], TINY["moe_intermediate_size"], 32
    g = torch.Generator().manual_seed(3)
    full = {"layers.2.feed_forward.gate.weight": 0.3 * torch.randn(E, H,
                                                                   generator=g),
            "layers.2.feed_forward.expert_bias": 0.3 * torch.randn(E,
                                                                   generator=g),
            "layers.2.feed_forward.w1": 0.2 * torch.randn(E, Im, H, generator=g),
            "layers.2.feed_forward.w3": 0.2 * torch.randn(E, Im, H, generator=g),
            "layers.2.feed_forward.w2": 0.2 * torch.randn(E, H, Im, generator=g)}
    x = torch.randn(40, H, generator=g)
    d = plain_lfm2.dims(TINY)
    whole = plain_lfm2.experts(full, "layers.2.", x, d, range(E))
    parts = []
    for lo in range(0, E, 8):
        layer = moe.DroplessMoE(H, Im, E, 4, range(lo, lo + 8))
        with torch.no_grad():
            layer.gate.weight.copy_(full["layers.2.feed_forward.gate.weight"])
            layer.expert_bias.copy_(full["layers.2.feed_forward.expert_bias"])
            for n in ("w1", "w3", "w2"):
                getattr(layer, n).copy_(
                    full["layers.2.feed_forward." + n][lo:lo + 8])
        parts.append(layer(x))
    assert (sum(parts) - whole).abs().max() <= 1e-5 * whole.abs().max()
    assert all(p.abs().max() > 0 for p in parts)


def test_routing_picks_by_biased_score_and_weighs_by_unbiased():
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    bias = torch.tensor([0.0, 0.0, 0.0, 5.0])
    experts, weights = moe.topk_route(logits, 2, bias, norm_topk_prob=False,
                                      routed_scaling_factor=2.0)
    assert experts.tolist() == [[3, 0]]
    scores = torch.sigmoid(logits)[0]
    assert torch.allclose(weights[0], 2.0 * scores[[3, 0]])
    _, normed = moe.topk_route(logits, 2, bias)
    assert torch.allclose(normed[0], scores[[3, 0]]
                          / (scores[[3, 0]].sum() + 1e-6))


def test_dispatch_lays_out_held_rows_in_tiles():
    experts = torch.tensor([[9, 3], [9, 10], [3, 9]])
    weights = torch.tensor([[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]])
    rows = moe.layout_rows(3, 2, 4)
    counts, offsets, token, weight = moe.dispatch(experts, weights,
                                                  range(8, 12), rows)
    a = moe_gemm.ALIGN
    assert counts.tolist() == [0, 3, 1, 0]
    assert offsets.tolist() == [0, 0, a, 2 * a, 2 * a]
    assert token[:4].tolist() == [0, 1, 2, 3]   # expert 9: tokens 0, 1, 2
    assert token[a:a + 2].tolist() == [1, 3]    # expert 10: token 1
    assert weight[:3].tolist() == pytest.approx([0.1, 0.3, 0.6])
    assert weight[a].item() == pytest.approx(0.4)
    assert weight.sum().item() == pytest.approx(1.4)


def test_short_conv_is_causal():
    model = _model()
    conv = model.layers[0].conv
    x = torch.randn(1, 12, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(5))
    y = conv(x)
    x2 = x.clone()
    x2[0, 7] += 1.0
    y2 = conv(x2)
    assert torch.equal(y[0, :7], y2[0, :7])
    assert (y[0, 7:10] - y2[0, 7:10]).abs().amax(-1).min() > 0
    assert torch.equal(y[0, 10:], y2[0, 10:])    # three taps reach t + 2


def _layout(counts):
    counts = torch.tensor(counts)
    offsets = moe_gemm.padded_offsets(counts)
    return counts.tolist(), offsets, int(offsets[-1]) + moe_gemm.ALIGN


# Empty and uneven experts; each product against a per-expert loop over
# the experts' own rows (the padding rows are zero, as the layer makes
# them).  fp32 both sides, one product each: 1e-5.
@pytest.mark.parametrize("product", ["y", "dx", "dw"])
@pytest.mark.parametrize("counts", [[5, 0, 130, 1], [0, 0, 0], [256, 3]])
def test_grouped_products_plain_path_matches_a_per_expert_loop(product,
                                                               counts):
    counts, offsets, R = _layout(counts)
    E, N, K = len(counts), 24, 16
    g = torch.Generator().manual_seed(7)
    x = torch.zeros(R, K)
    dy = torch.zeros(R, N)
    bounds = offsets.tolist()
    for e, c in enumerate(counts):
        x[bounds[e]:bounds[e] + c] = torch.randn(c, K, generator=g)
        dy[bounds[e]:bounds[e] + c] = torch.randn(c, N, generator=g)
    w = torch.randn(E, N, K, generator=g)
    rows = [slice(bounds[e], bounds[e] + counts[e]) for e in range(E)]
    if product == "y":
        got = moe_gemm.grouped_rows(x, w, offsets)
        want = [x[r] @ w[e].t() for e, r in enumerate(rows)]
        got = [got[r] for r in rows]
    elif product == "dx":
        got = moe_gemm.grouped_rows(dy, w.transpose(1, 2).contiguous(),
                                    offsets)
        want = [dy[r] @ w[e] for e, r in enumerate(rows)]
        got = [got[r] for r in rows]
    else:
        got = moe_gemm.grouped_k(dy.t().contiguous(), x.t().contiguous(),
                                 offsets)
        want = [dy[r].t() @ x[r] for r in rows]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("held", [range(0, 8), range(24, 32)])
def test_dispatch_places_every_held_assignment_once(held):
    T, k = 50, 4
    g = torch.Generator().manual_seed(held.start)
    experts, weights = moe.topk_route(torch.randn(T, 32, generator=g), k)
    rows = moe.layout_rows(T, k, len(held))
    counts, offsets, token, weight = moe.dispatch(experts, weights, held,
                                                  rows)
    bounds = offsets.tolist()
    for e, c in enumerate(counts.tolist()):
        got = {(t, w) for t, w in zip(token[bounds[e]:bounds[e] + c].tolist(),
                                      weight[bounds[e]:bounds[e] + c].tolist())}
        want = {(t, weights[t, j].item())
                for t, j in (experts == held.start + e).nonzero().tolist()}
        assert len(got) == c and got == want
    assert sum(counts.tolist()) == int(((experts >= held.start)
                                        & (experts < held.stop)).sum())
    # Every other row names the zero row T with weight 0.
    used = torch.zeros(rows, dtype=torch.bool)
    for e, c in enumerate(counts.tolist()):
        used[bounds[e]:bounds[e] + c] = True
    assert (token[~used] == T).all() and (weight[~used] == 0).all()


def test_config_reads_the_published_keys():
    with open(os.path.join(REPO, "hvdbench", "configs", "lfm2_8b_a1b",
                           "config.json")) as f:
        published = json.load(f)
    cfg = lfm2.LFM2MoEConfig.from_dict(published, num_experts=32,
                                       experts_held=range(0, 8))
    assert cfg.layer_types == tuple(published["layer_types"])
    assert [i for i, t in enumerate(cfg.layer_types)
            if t == "full_attention"] == [2, 6, 10, 14, 18, 21]
    assert (cfg.num_dense_layers, cfg.num_experts_per_tok,
            cfg.moe_intermediate_size, cfg.head_dim) == (2, 4, 1792, 64)
    assert cfg.use_expert_bias and cfg.norm_topk_prob
    assert cfg.rope_theta == 1e6 and cfg.held == range(0, 8)
    with torch.device("meta"):
        model = lfm2.LFM2MoEForCausalLM(cfg, device="meta")
    held = sum(p.numel() for p in model.parameters())
    assert 2.5e9 < held < 2.6e9


def _bench_cfg():
    cfg = dict(TINY, num_experts=len(HELD), initializer_range=0.2,
               deployment={"num_experts_published": 32,
                           "experts_held": [HELD.start, HELD.stop]},
               training={"lr": 6e-4, "betas": [0.9, 0.95], "eps": 1e-8,
                         "weight_decay": 0.1, "grad_clip": 1.0})
    return cfg


@pytest.mark.parametrize("remat", [False, True])
def test_benchmark_reference_copy_matches_plain(remat):
    from hvdbench import spec
    ref = spec.load_module(os.path.join(
        REPO, "hvdbench", "configs", "lfm2_8b_a1b", "reference.py"),
        "test_lfm2_bench_reference")
    cfg = _bench_cfg()
    w = ref.make_weights(cfg, 11, torch.device("cpu"))
    ids = _ids(B=1, S=20, seed=4)
    a = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    b = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    la = ref.loss_of(a, ids, cfg, remat=remat)
    lb = plain_lfm2.loss_of(b, ids, TINY, HELD)
    la.backward()
    lb.backward()
    # The same operations in the same order: equal to fp32 round-off.
    assert abs(la.item() - lb.item()) <= 1e-6 * lb.item()
    for n in w:
        assert torch.allclose(a[n].grad, b[n].grad, rtol=1e-5,
                              atol=1e-6 * b[n].grad.abs().max()), n


def test_port_loads_the_benchmark_reference_weights_by_name():
    from hvdbench import spec
    ref = spec.load_module(os.path.join(
        REPO, "hvdbench", "configs", "lfm2_8b_a1b", "reference.py"),
        "test_lfm2_bench_reference")
    model = _model()
    names = {n for n, _ in model.named_parameters()}
    assert names == {n for n, *_ in ref.weight_specs(_bench_cfg())}
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert all(shapes[n] == tuple(s) for n, s, *_ in
               ref.weight_specs(_bench_cfg()))
