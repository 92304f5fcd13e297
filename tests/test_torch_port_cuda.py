"""The port on the card: the CUDA flash kernel against its plain version,
the model's flash path against its einsum path, and no quiet fallback
when the kernel cannot be built.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_cuda.py -m cuda -q
"""

import dataclasses
import sys
import time

import pytest
import torch

from horovod_tpu_torch import kernels
from horovod_tpu_torch.models import gpt
from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    # fp32 references at 1e-4 need full fp32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, bh, sq, skv, d, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(bh, s, d, device=device, generator=g).to(dtype)
                 for s in (sq, skv, skv))


# bf16/fp16 at 3e-2: the kernel rounds P to the input type before P.V.
# fp32 at 1e-4: both sides accumulate in fp32, in another order.
@pytest.mark.parametrize("bh,sq,skv,d,dtype,causal,tol", [
    (96, 1024, 1024, 64, torch.bfloat16, True, 3e-2),
    (4, 1000, 1000, 64, torch.float32, False, 1e-4),
    (3, 40, 72, 16, torch.float32, True, 1e-4),
    (2, 130, 77, 32, torch.float16, False, 3e-2),
    (2, 200, 200, 128, torch.float32, True, 1e-4),
    (2, 100, 60, 128, torch.bfloat16, True, 3e-2),
    (4, 1000, 1000, 64, torch.bfloat16, False, 3e-2),
    (2, 1000, 777, 128, torch.float16, True, 3e-2),
    (1, 129, 129, 64, torch.bfloat16, True, 3e-2),
    (3, 64, 300, 128, torch.bfloat16, False, 3e-2),
    (2, 200, 1000, 64, torch.float16, True, 3e-2),
])
def test_cuda_kernel_matches_plain(cuda, bh, sq, skv, d, dtype, causal,
                                   tol):
    q, k, v = _qkv(cuda, bh, sq, skv, d, dtype)
    body = fa._body_for(dtype, d)
    before, before_body = fa.launches, dict(fa.launches_by_body)
    got = fa.flash_attention_cuda(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert fa.launches_by_body == {
        b: n + (b == body) for b, n in before_body.items()}
    ref = fa.flash_attention_reference(q, k, v, d ** -0.5, causal)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_wgmma_and_mma_bodies_agree_at_gpt_shape(cuda):
    q, k, v = _qkv(cuda, 96, 1024, 1024, 64, torch.bfloat16)
    wg = fa.flash_attention_cuda(q, k, v, 0.125, True, body=fa.BODY_WGMMA)
    mma = fa.flash_attention_cuda(q, k, v, 0.125, True, body=fa.BODY_MMA)
    torch.cuda.synchronize()
    torch.testing.assert_close(wg.float(), mma.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_body_with_a_negative_scale(cuda, causal):
    # A negative scale sends every tile through the masked path.
    q, k, v = _qkv(cuda, 2, 300, 260, 64, torch.bfloat16)
    got = fa.flash_attention_cuda(q, k, v, -0.2, causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, -0.2, causal)
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("bh,sq,skv,d,dtype", [
    (2, 100, 0, 64, torch.bfloat16),
    (0, 100, 100, 64, torch.bfloat16),
    (2, 0, 100, 128, torch.float16),
    (0, 40, 72, 16, torch.float32),
])
def test_work_without_a_kernel_counts_no_launch(cuda, bh, sq, skv, d, dtype):
    # No key (every row's l is 0, so the output is 0) or an empty output:
    # the output is complete without a kernel, and no launch is counted.
    q, k, v = _qkv(cuda, bh, sq, skv, d, dtype)
    before, before_body = fa.launches, dict(fa.launches_by_body)
    got = fa.flash_attention_cuda(q, k, v, d ** -0.5, True)
    torch.cuda.synchronize()
    assert fa.launches == before and fa.launches_by_body == before_body
    assert got.shape == (bh, sq, d) and not got.any()


def test_body_that_does_not_take_the_input_raises(cuda):
    q, k, v = _qkv(cuda, 1, 8, 8, 32, torch.bfloat16)
    with pytest.raises(RuntimeError, match="wgmma body"):
        fa.flash_attention_cuda(q, k, v, 0.25, True, body=fa.BODY_WGMMA)


def test_device_trace_names_the_flash_kernel(cuda, tmp_path):
    """One flash call under start_xla_trace/stop_xla_trace: the Chrome
    trace holds the wgmma kernel with its device time."""
    from horovod_tpu_torch import profile_step
    from horovod_tpu_torch.common import timeline
    q, k, v = _qkv(cuda, 96, 1024, 1024, 64, torch.bfloat16)
    fa.flash_attention_cuda(q, k, v, 0.125, True)   # built and warm
    torch.cuda.synchronize()
    timeline.start_xla_trace(str(tmp_path))
    try:
        fa.flash_attention_cuda(q, k, v, 0.125, True)
        torch.cuda.synchronize()
    finally:
        path = timeline.stop_xla_trace()
    by_name = profile_step.device_ms_by_name(path)
    flash = [n for n in by_name if "flash_fwd_wgmma_kernel" in n]
    assert len(flash) == 1 and by_name[flash[0]] > 0, by_name
    assert profile_step.ms_by_category(by_name)["flash_fwd"] > 0


def test_every_device_trace_in_a_row_holds_the_card(cuda, tmp_path):
    """A hundred traces in a row in this process, each around one flash
    call: every one holds the kernel (such a trace once came back
    without its device event)."""
    from horovod_tpu_torch import profile_step
    from horovod_tpu_torch.common import timeline
    q, k, v = _qkv(cuda, 96, 1024, 1024, 64, torch.bfloat16)
    fa.flash_attention_cuda(q, k, v, 0.125, True)
    torch.cuda.synchronize()
    kernels_per_trace = []
    for i in range(100):
        timeline.start_xla_trace(str(tmp_path / str(i)))
        try:
            fa.flash_attention_cuda(q, k, v, 0.125, True)
            torch.cuda.synchronize()
        finally:
            path = timeline.stop_xla_trace()
        by_name = profile_step.device_ms_by_name(path)
        kernels_per_trace.append(
            sum(1 for n in by_name if "flash_fwd_wgmma_kernel" in n))
    assert kernels_per_trace == [1] * 100, kernels_per_trace


def test_tiny_gpt_flash_matches_einsum_on_card(cuda):
    cfg = gpt.gpt_tiny_config(dtype=torch.float32, dropout=0.0)
    einsum = gpt.GPTLMHeadModel(cfg, device=cuda, seed=0).eval()
    flash = gpt.GPTLMHeadModel(
        dataclasses.replace(cfg, attention_impl="flash"), device=cuda,
        seed=0).eval()
    flash.load_state_dict(einsum.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    before = fa.launches
    with torch.no_grad():
        ref, got = einsum(ids), flash(ids)
    assert fa.launches - before == cfg.num_layers
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_broken_build_raises_on_cuda_tensors(cuda, tmp_path, monkeypatch):
    (tmp_path / "flash_attn_fwd.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(kernels, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_loaded", {})
    x = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa.flash_attention_cuda(x, x, x, 0.25, True)


# ---------------------------------------------------------------------------
# The fusion pack/unpack kernel (kernels/fusion_buffer.cu): bit-equal to
# its plain version on the same CUDA tensors.
# ---------------------------------------------------------------------------
_FUSION_DTYPES = [torch.uint8, torch.int8, torch.uint16, torch.int16,
                  torch.int32, torch.int64, torch.float16, torch.float32,
                  torch.float64, torch.bool, torch.bfloat16]


def _fusion_inputs(device, dtype, seed=0):
    """Tensors of one dtype: ragged lengths, a 0-d and a 0-element
    tensor, and views one element off a 16-byte boundary."""
    g = torch.Generator().manual_seed(seed)

    def make(n):
        if dtype == torch.bool:
            return torch.randint(0, 2, (n,), generator=g).bool()
        if dtype.is_floating_point:
            return torch.randn(n, generator=g).to(dtype)
        return torch.randint(0, 100, (n,), generator=g).to(dtype)

    base = make(5000).to(device)
    return [make(1000).to(device).view(10, 100), make(1).to(device)[0],
            make(0).to(device), base[1:4002], make(37).to(device),
            base[3:3 + 333].view(3, 111), make(65536 + 3).to(device)]


@pytest.mark.parametrize("dtype", _FUSION_DTYPES)
@pytest.mark.parametrize("factor", [1.0, 0.5, 3.0])
def test_fusion_kernel_is_bit_equal_to_plain(cuda, dtype, factor):
    from horovod_tpu_torch.ops import fusion_buffer as fb
    tensors = _fusion_inputs(cuda, dtype)
    before, plain = dict(fb.launches), dict(fb.plain_calls)
    got = fb.pack(tensors, factor)
    want = fb.pack_plain(tensors, factor)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    outs = [torch.empty(t.shape, dtype=dtype, device=cuda) for t in tensors]
    refs = [torch.empty(t.shape, dtype=dtype, device=cuda) for t in tensors]
    fb.unpack(got, outs, factor)
    fb.unpack_plain(want, refs, factor)
    torch.cuda.synchronize()
    assert all(torch.equal(o, r) for o, r in zip(outs, refs))
    assert fb.launches == {"pack": before["pack"] + 1,
                           "unpack": before["unpack"] + 1}
    assert fb.plain_calls == plain


def test_fusion_kernel_takes_more_tensors_than_one_launch(cuda):
    from horovod_tpu_torch.ops import fusion_buffer as fb
    _, _, max_entries = fb._kernel_lib()
    g = torch.Generator(device=cuda).manual_seed(3)
    tensors = [torch.randn(i + 1, device=cuda, generator=g)
               for i in range(2 * max_entries + 5)]
    before = dict(fb.launches)
    flat = fb.pack(tensors, 0.25)
    outs = [torch.empty_like(t) for t in tensors]
    fb.unpack(flat, outs, 4.0)
    torch.cuda.synchronize()
    assert torch.equal(flat, fb.pack_plain(tensors, 0.25))
    assert all(torch.equal(o, t) for o, t in zip(outs, tensors))
    assert fb.launches["pack"] - before["pack"] == 3
    assert fb.launches["unpack"] - before["unpack"] == 3


def test_fusion_kernel_refuses_mixed_or_strided_inputs(cuda):
    from horovod_tpu_torch.ops import fusion_buffer as fb
    x = torch.ones(4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fb.pack([x.t()], 1.0)
    with pytest.raises(ValueError, match="one dtype and device"):
        fb.pack([x, x.half()], 1.0)


def test_nccl_backend_in_a_world_of_one(cuda):
    # NCCL takes a one-rank communicator on one card; every collective
    # of the backend runs once on CUDA tensors.
    import socket
    import types

    import torch.distributed as dist

    from horovod_tpu_torch.common.env import Knobs, RankInfo
    from horovod_tpu_torch.ops import dist_ops
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group(dist_ops.process_group_backend("nccl"),
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        state = types.SimpleNamespace(rank_info=RankInfo(), knobs=Knobs())
        be = dist_ops.TorchDistBackend(state, "nccl")
        assert be.name == "nccl"
        for check, ok in dist_ops.world1_checks(be, cuda).items():
            assert ok, check
    finally:
        dist.destroy_process_group()


def test_runtime_stream_waits_for_the_producer(cuda):
    # The runtime runs a response on its own stream after the event the
    # submit recorded on the caller's stream: a producer still queued
    # behind a long kernel is seen finished.
    import horovod_tpu_torch.torch as hvd
    hvd.init()
    try:
        x = torch.zeros(1 << 20, device=cuda)
        torch.cuda._sleep(100_000_000)
        x.add_(1.0)
        y = hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0, name="order")
        assert y.is_cuda and torch.equal(y, torch.full_like(x, 2.0))
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# The launcher on the card: the slot plan decides the transport.
# ---------------------------------------------------------------------------
_TRANSPORT_WORKER = """
import json
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import basics
hvd.init()
transport = basics._state().transport
cards = hvd.allgather_object(torch.cuda.current_device())
cpu = hvd.allreduce(torch.ones(4) * (hvd.rank() + 1), op=hvd.Sum, name="cpu")
cuda = None
# NCCL refuses two ranks on one card: a CUDA collective runs over NCCL
# only where every rank has a card of its own.
if transport == "gloo" or len(set(cards)) == len(cards):
    cuda = hvd.allreduce(torch.ones(4, device="cuda") * (hvd.rank() + 1),
                         op=hvd.Sum, name="cuda").tolist()
print("RESULT " + json.dumps({
    "rank": hvd.rank(), "local_size": hvd.local_size(),
    "transport": transport, "backend": basics._state().backend.name,
    "cards": cards, "cpu": cpu.tolist(), "cuda": cuda}), flush=True)
hvd.shutdown()
"""


@pytest.mark.parametrize("hosts", ["localhost:2", "localhost:1,127.0.0.1:1"])
def test_launcher_transport_follows_the_slot_plan(cuda, tmp_path, hosts):
    # Two ranks on one host share the card unless the host has two: gloo.
    # One rank on each of two host names of this machine: both take card
    # 0, and the ranks agree on gloo (dist_ops.world_transport).
    import json

    from test_torch_port_multiproc import launcher_env, run_port_launcher
    script = tmp_path / "worker.py"
    script.write_text(_TRANSPORT_WORKER)
    rc, out = run_port_launcher(
        ["-np", "2", "-H", hosts, sys.executable, str(script)],
        launcher_env(),
        timeout=300)
    assert rc == 0, out[-3000:]
    res = {}
    for line in out.splitlines():
        _, sep, rest = line.partition("<stdout>:")
        if sep and rest.startswith("RESULT "):
            r = json.loads(rest[len("RESULT "):])
            res[r["rank"]] = r
    assert sorted(res) == [0, 1], out[-3000:]
    local_size = 2 if hosts == "localhost:2" else 1
    n = torch.cuda.device_count()
    cards = [0, 1 % n] if hosts == "localhost:2" else [0, 0]
    want = "nccl" if local_size <= n and cards[0] != cards[1] else "gloo"
    for r in res.values():
        assert r["local_size"] == local_size
        assert r["transport"] == r["backend"] == want
        assert r["cpu"] == [3.0] * 4
        if r["cuda"] is not None:
            assert r["cuda"] == [3.0] * 4
    if want == "gloo":
        assert all(r["cuda"] is not None for r in res.values())


# ---------------------------------------------------------------------------
# Elastic: state kept on the card across a restore, and the process group
# destroyed and made again as an elastic reset does.
# ---------------------------------------------------------------------------
def test_torch_state_restores_a_cuda_model_bit_exact_on_its_card(cuda):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.torch.elastic import TorchState
    hvd.init()
    try:
        cfg = gpt.gpt_tiny_config(dtype=torch.bfloat16,
                                  attention_impl="flash")
        model = gpt.GPTLMHeadModel(cfg, seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            named_parameters=model.named_parameters())
        g = torch.Generator(device=cuda).manual_seed(0)
        ids = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                            generator=g)

        def step():
            opt.zero_grad()
            gpt.lm_loss(model(ids), ids).backward()
            opt.step()

        step()
        state = TorchState(model, opt, step=1)
        want = {k: v.clone() for k, v in model.state_dict().items()}
        want_opt = {i: {k: v.clone() for k, v in st.items()}
                    for i, st in opt.state_dict()["state"].items()}
        step()
        state.step = 2
        state.restore()
        card = torch.cuda.current_device()
        for k, v in model.state_dict().items():
            assert v.device == torch.device("cuda", card), k
            assert torch.equal(v, want[k]), k
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                assert torch.equal(v.cpu(), want_opt[i][k].cpu()), (i, k)
                if k != "step":
                    assert v.device == torch.device("cuda", card), (i, k)
        assert state.step == 1
        # sync in a world of one keeps everything where it was.
        state.sync()
        assert all(torch.equal(v, want[k])
                   for k, v in model.state_dict().items())
    finally:
        hvd.shutdown()


def test_torch_state_durable_items_copy_the_card_and_restore_to_it(
        cuda, tmp_path):
    # durable_state_dict() hands the checkpoint writer host numpy equal
    # to the committed values on the card; a restore through the
    # manager puts them back on the card.
    import numpy as np
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.checkpoint import DurableCheckpointer
    from horovod_tpu_torch.torch.elastic import TorchState
    hvd.init()
    try:
        cfg = gpt.gpt_tiny_config(dtype=torch.bfloat16,
                                  attention_impl="flash")

        def build(seed):
            model = gpt.GPTLMHeadModel(cfg, seed=seed)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            return model, opt

        model, opt = build(0)
        g = torch.Generator(device=cuda).manual_seed(0)
        ids = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                            generator=g)
        opt.zero_grad()
        gpt.lm_loss(model(ids), ids).backward()
        opt.step()
        state = TorchState(model, opt, step=1)
        items = state.durable_state_dict()
        for k, v in model.state_dict().items():
            got = items["torch/arg.0/" + k]
            assert isinstance(got, np.ndarray) and v.is_cuda, k
            assert np.array_equal(got, v.cpu().numpy()), k
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                got = items[f"torch/arg.1/state/{i}/{k}"]
                assert np.array_equal(got, v.cpu().numpy()), (i, k)
        ck = DurableCheckpointer(state, str(tmp_path))
        ck.commit()
        assert ck.wait(60)
        ck.close()

        model2, opt2 = build(1)
        state2 = TorchState(model2, opt2, step=0)
        ck2 = DurableCheckpointer(state2, str(tmp_path))
        assert ck2.maybe_restore() == 0
        ck2.close()
        card = torch.device("cuda", torch.cuda.current_device())
        assert state2.step == 1
        for k, v in model2.state_dict().items():
            assert v.device == card, k
            assert torch.equal(v, model.state_dict()[k]), k
        for i, st in opt2.state_dict()["state"].items():
            for k, v in st.items():
                assert torch.equal(v.cpu(),
                                   opt.state_dict()["state"][i][k].cpu())
                if k != "step":
                    assert v.device == card, (i, k)
    finally:
        hvd.shutdown()


def test_nccl_group_is_remade_three_times_through_basics(cuda,
                                                         monkeypatch):
    # The part of an elastic reset one card can run on the NCCL path:
    # basics makes a one-rank NCCL group at a fresh store port, every
    # collective is exact in it, shutdown destroys it, three times over.
    import socket

    import torch.distributed as dist

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import dist_ops
    cards = []
    for _ in range(3):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        monkeypatch.setenv("HOROVOD_TPU_COORDINATOR",
                           f"127.0.0.1:{s.getsockname()[1]}")
        s.close()
        basics.init()
        state = basics._state()
        try:
            state.process_group_owned = basics._init_process_group(state)
            assert state.process_group_owned and state.transport == "nccl"
            state.backend = dist_ops.TorchDistBackend(state, "nccl")
            for check, ok in dist_ops.world1_checks(state.backend,
                                                    cuda).items():
                assert ok, check
            cards.append(torch.cuda.current_device())
        finally:
            basics.shutdown()
        assert not dist.is_initialized()
    assert len(set(cards)) == 1


def test_sharded_gpt_step_on_the_card_matches_the_unsharded_model(cuda):
    # The sharded step at world one (a one-rank gloo group, a {"dp": 1}
    # mesh on the card): DTensor parameters, the flash kernel on local
    # shards, and the same loss and gradients as the plain model.
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from horovod_tpu_torch import training
    from horovod_tpu_torch.parallel import build_mesh
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("cpu:gloo,cuda:gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        cfg = gpt.gpt_tiny_config(dtype=torch.float32,
                                  attention_impl="flash")
        init_fn, step_fn, _ = training.make_gpt_train_step(
            cfg, build_mesh({"dp": 1}))
        model, opt = init_fn(3)
        ref = gpt.GPTLMHeadModel(cfg, seed=3).eval()
        ids = torch.randint(0, cfg.vocab_size, (4, 64),
                            generator=torch.Generator().manual_seed(1))
        ref_loss = gpt.lm_loss(ref(ids.cuda()), ids.cuda())
        ref_loss.backward()
        fa.launches = 0
        model, opt, loss = step_fn(model, opt, ids)
        torch.cuda.synchronize()
        assert fa.launches == cfg.num_layers
        assert abs(loss.item() - ref_loss.item()) <= 1e-5 * ref_loss.item()
        refs = dict(ref.named_parameters())
        for name, p in model.named_parameters():
            assert isinstance(p, DTensor) and p.device.type == "cuda"
            torch.testing.assert_close(p.grad.full_tensor(),
                                       refs[name].grad, rtol=1e-4,
                                       atol=1e-6, msg=name)
    finally:
        dist.destroy_process_group()


def test_gather_route_stages_only_where_gloo_carries_cuda(cuda):
    # The host route of the functional all-gather stages a CUDA tensor
    # through the host on a world that carries CUDA tensors over gloo and
    # leaves it to a world that carries them itself (NCCL).
    import socket

    import torch.distributed as dist

    from horovod_tpu_torch.ops import dist_ops
    from horovod_tpu_torch.parallel import collectives
    x = torch.arange(6.0, device="cuda").reshape(3, 2)
    ops = torch.ops._c10d_functional
    for backend, staged in (("cpu:gloo,cuda:gloo", 1),
                            (dist_ops.process_group_backend("nccl"), 0)):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
        try:
            collectives._register_route("CUDA")
            calls = collectives.route_calls
            out = ops.wait_tensor(ops.all_gather_into_tensor(
                x, 1, dist.group.WORLD.group_name))
            torch.cuda.synchronize()
            assert out.is_cuda and torch.equal(out, x), backend
            assert collectives.route_calls - calls == staged, backend
        finally:
            collectives.remove_gloo_cuda_route()
            dist.destroy_process_group()


def test_bert_base_flash_forward_matches_einsum(cuda):
    from horovod_tpu_torch.models import bert
    cfg = bert.bert_base_config(dtype=torch.float32, hidden_dropout=0.0,
                                attention_dropout=0.0)
    einsum = bert.BertForMaskedLM(cfg, seed=0)
    flash = bert.BertForMaskedLM(
        dataclasses.replace(cfg, attention_impl="flash"), seed=0)
    ids = torch.randint(0, cfg.vocab_size, (2, 512), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    fa.launches = 0
    with torch.no_grad():
        want, got = einsum(ids), flash(ids)
    torch.cuda.synchronize()
    assert fa.launches == cfg.num_layers
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_resnet18_on_the_card_matches_the_cpu(cuda, dtype, tol):
    # cuDNN against the CPU's convolutions, TF32 off; relative to the
    # largest logit (bf16: rounding of the two convolution orders).
    from horovod_tpu_torch.models import resnet
    torch.backends.cudnn.allow_tf32 = False
    cpu = resnet.ResNet18(num_classes=10, dtype=dtype, device="cpu", seed=4)
    card = resnet.ResNet18(num_classes=10, dtype=dtype, seed=4)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(8, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = cpu(x, train=True)
        got = card(x.to(cuda), train=True).cpu()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    for (name, a), b in zip(card.state_dict().items(),
                            cpu.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol, msg=name)


def test_sync_batch_norm_at_size_one_on_cuda_tensors(cuda):
    # At size 1 the module is torch's BatchNorm; the sync function itself
    # reduces its float64 moments through the runtime on the card.
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common.basics import global_process_set
    from horovod_tpu_torch.torch.sync_batch_norm import _SyncBatchNormFn
    hvd.init()
    try:
        g = torch.Generator(cuda).manual_seed(3)
        x = torch.randn(8, 4, 6, 6, device=cuda, generator=g) * 2 + 1
        dy = torch.randn(8, 4, 6, 6, device=cuda, generator=g)
        sync, ref = hvd.SyncBatchNorm(4).to(cuda), \
            torch.nn.BatchNorm2d(4).to(cuda)
        outs = []
        for bn in (sync, ref):
            xi = x.clone().requires_grad_()
            y = bn(xi)
            y.backward(dy)
            outs.append((y, xi.grad, bn.weight.grad, bn.running_var))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        xi = x.clone().requires_grad_()
        w = torch.linspace(0.5, 1.5, 4, device=cuda).requires_grad_()
        b = torch.zeros(4, device=cuda).requires_grad_()
        y, _, _ = _SyncBatchNormFn.apply(xi, w, b, 1e-5, global_process_set,
                                         9999)
        y.backward(dy)
        xr = x.clone().requires_grad_()
        wr, br = w.detach().clone().requires_grad_(), \
            b.detach().clone().requires_grad_()
        yr = torch.nn.functional.batch_norm(xr, None, None, wr, br,
                                            training=True, eps=1e-5)
        yr.backward(dy)
        assert y.is_cuda and xi.grad.is_cuda
        torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(xi.grad, xr.grad, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(w.grad, wr.grad, rtol=1e-4, atol=1e-4)
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_a_one_rank_mesh_is_reference(cuda, causal):
    import socket

    import torch.distributed as dist

    from horovod_tpu_torch.parallel import (build_mesh, reference_attention,
                                            ring_attention, shard_map)
    from horovod_tpu_torch.parallel.mesh import P
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("cpu:gloo,cuda:gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        g = torch.Generator(cuda).manual_seed(5)
        q, k, v = (torch.randn(2, 256, 4, 64, device=cuda, generator=g)
                   for _ in range(3))
        got = shard_map(lambda a, b, c: ring_attention(
            a, b, c, axis_name="sp", causal=causal), build_mesh({"sp": 1}),
            P(None, "sp"), P(None, "sp"))(q, k, v)
        want = reference_attention(q, k, v, causal=causal)
        assert got.is_cuda
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The sparse engine and the serving replica on the card: bit for bit the
# CPU path (the ordered scatter keeps np.add.at's order where index_add_
# would add by atomics), and whole snapshots under concurrent reads.
# ---------------------------------------------------------------------------
def _sparse_run(device, dedupe, monkeypatch):
    import numpy as np

    from horovod_tpu_torch.sparse import EmbeddingBag, ShardedEmbedding
    monkeypatch.setenv("HOROVOD_SPARSE_DEDUPE", dedupe)
    t = ShardedEmbedding("cuda.t", 4096, 16, rank=0, size=1, seed=3,
                         device=device)
    bag = EmbeddingBag(ShardedEmbedding("cuda.b", 4096, 16, rank=0, size=1,
                                        seed=4, device=device), mode="mean")
    out = []
    for step in range(4):
        rng = np.random.default_rng(step)
        ids = (rng.zipf(1.3, size=512) - 1) % 4096     # many duplicates
        g = rng.standard_normal((512, 16)).astype(np.float32)
        out.append(t.lookup(ids).cpu())
        t.apply_gradients(torch.from_numpy(g).to(device), lr=0.05)
        offsets = np.arange(0, 512, 2)
        out.append(bag.forward(ids, offsets).cpu())
        bag.backward(torch.from_numpy(g[:256]).to(device), lr=0.05)
    out += [t.local.cpu(), bag.table.local.cpu(),
            torch.from_numpy(t.snapshot_touched())]
    return out


@pytest.mark.parametrize("dedupe", ["1", "0"])
def test_sparse_update_and_bag_on_the_card_equal_the_cpu(cuda, dedupe,
                                                         monkeypatch):
    got = _sparse_run(cuda, dedupe, monkeypatch)
    want = _sparse_run("cpu", dedupe, monkeypatch)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i


def test_ordered_scatter_on_the_card_is_the_cpu_order(cuda):
    from horovod_tpu_torch.sparse.embedding import ordered_scatter
    g = torch.Generator().manual_seed(0)
    target = torch.randn(64, 16, generator=g)
    index = torch.randint(0, 64, (20000,), generator=g)
    values = torch.randn(20000, 16, generator=g) * 1e3
    for op in ("add", "sub"):
        want = ordered_scatter(target.clone(), index, values, op)
        got = ordered_scatter(target.to(cuda), index.to(cuda),
                              values.to(cuda), op)
        assert torch.equal(got.cpu(), want), op


_SERVE_ROWS, _SERVE_DIM, _SERVE_TOUCH = 65536, 16, 4096


def _serve_touched(step):
    import numpy as np
    return np.unique((np.arange(_SERVE_TOUCH) * 131 + step * 997)
                     % _SERVE_ROWS)


def _serve_table_at(step):
    import numpy as np
    t = np.arange(_SERVE_ROWS * _SERVE_DIM, dtype=np.float32).reshape(
        _SERVE_ROWS, _SERVE_DIM) * 1e-3
    for s in range(2, step + 1):
        r = _serve_touched(s)
        t[r] = r.astype(np.float32)[:, None] + s * 1000.0
    return t


def _serve_commit(mgr, step):
    import numpy as np

    from horovod_tpu_torch.checkpoint import RowDelta
    name = "sparse/tbl/rows.r00000"
    plan = mgr.delta_plan()
    if plan is None:            # the first step, or the chain is full
        mgr.save(step, {}, local_items={name: RowDelta(
            np.arange(_SERVE_ROWS), _serve_table_at(step), _SERVE_ROWS)})
    else:
        r = _serve_touched(step)
        vals = np.repeat(r.astype(np.float32)[:, None] + step * 1000.0,
                         _SERVE_DIM, axis=1)
        mgr.save(step, {}, local_items={name: RowDelta(r, vals,
                                                       _SERVE_ROWS)},
                 delta_of=plan)


def test_replica_on_the_card_equals_the_replica_on_the_cpu(cuda, tmp_path):
    import numpy as np

    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.serve import ServingReplica
    mgr = CheckpointManager(str(tmp_path), keep=None)
    try:
        for s in (1, 2):
            _serve_commit(mgr, s)
        on_card = ServingReplica(str(tmp_path), device=cuda)
        on_cpu = ServingReplica(str(tmp_path), device="cpu")
        assert on_card.bootstrap() == on_cpu.bootstrap() == 2
        for s in (3, 4):
            _serve_commit(mgr, s)
        assert on_card.poll_once() == on_cpu.poll_once() == 2
        rng = np.random.default_rng(1)
        ids = (rng.zipf(1.3, size=4096) - 1) % _SERVE_ROWS
        a, b = on_card.lookup("tbl", ids), on_cpu.lookup("tbl", ids)
        assert a[0].is_cuda and a[1] == b[1] == 4
        assert torch.equal(a[0].cpu(), b[0])
        assert torch.equal(b[0], torch.from_numpy(_serve_table_at(4)[ids]))
        offsets = np.sort(rng.integers(0, 4096, size=300))
        offsets[0] = 0
        for mode in ("sum", "mean"):
            a = on_card.embedding_bag("tbl", ids, offsets, mode=mode)[0]
            b = on_cpu.embedding_bag("tbl", ids, offsets, mode=mode)[0]
            assert a.is_cuda and torch.equal(a.cpu(), b), mode
        with pytest.raises(IndexError):
            on_card.lookup("tbl", [_SERVE_ROWS])
    finally:
        mgr.close()


def test_replica_on_the_card_serves_whole_steps_under_concurrent_reads(
        cuda, tmp_path, monkeypatch):
    """A writer commits deltas of 4096 rows of a 65536 x 16 table while
    the tail thread flips snapshots built on the card and four reader
    threads look rows up: every read equals the committed table at its
    own step stamp (a flip before its copies finished would show a row
    of the next step, or of no step).  Then the torn-apply failpoint, on
    the card."""
    import threading

    import numpy as np

    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.common import env, failpoints
    from horovod_tpu_torch.serve import ServingReplica
    monkeypatch.setenv(env.HOROVOD_SERVE_POLL_SECONDS, "0.01")
    mgr = CheckpointManager(str(tmp_path), keep=None)
    rep = None
    try:
        _serve_commit(mgr, 1)
        rep = ServingReplica(str(tmp_path), device=cuda)
        rep.bootstrap()
        rep.start()
        tables, bad, reads = {}, [], [0] * 4
        stop = threading.Event()
        ids = np.unique(np.concatenate(
            [_serve_touched(s)[:64] for s in range(2, 12)]))

        def reader(i):
            while not stop.is_set():
                rows, step = rep.lookup("tbl", ids)
                rows = rows.cpu().numpy()
                want = tables.get(step)
                if want is None:
                    want = tables[step] = _serve_table_at(step)[ids]
                if not np.array_equal(rows, want):
                    bad.append(step)
                reads[i] += 1

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for s in range(2, 12):
            _serve_commit(mgr, s)
        deadline = time.monotonic() + 30
        while rep.freshness()[0] < 11 and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert rep.freshness()[0] == 11
        assert not bad, bad[:10]
        assert min(reads) > 0, reads
        rep.stop()
        _serve_commit(mgr, 12)
        failpoints.configure("serve.delta_apply=drop(1)")
        try:
            assert rep.poll_once() == 0
            rows, step = rep.lookup("tbl", np.arange(_SERVE_ROWS))
            assert step == 11
            assert torch.equal(rows.cpu(),
                               torch.from_numpy(_serve_table_at(11)))
        finally:
            failpoints.reset()
        assert rep.poll_once() == 1
        rows, step = rep.lookup("tbl", np.arange(_SERVE_ROWS))
        assert step == 12 and torch.equal(
            rows.cpu(), torch.from_numpy(_serve_table_at(12)))
    finally:
        if rep is not None:
            rep.stop()
        mgr.close()


def test_tables_and_replica_default_to_the_card(cuda, tmp_path):
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.sparse import ShardedEmbedding
    t = ShardedEmbedding("card", 100, 4, rank=0, size=1)
    assert t.local.is_cuda
    mgr = CheckpointManager(str(tmp_path), keep=None)
    try:
        _serve_commit(mgr, 1)
        plane = serve.start(str(tmp_path), http=False, tail=False)
        try:
            assert plane.replica.device.type == "cuda"
            assert plane.replica.lookup("tbl", [0, 1])[0].is_cuda
        finally:
            plane.stop()
    finally:
        mgr.close()


def _inproc_fit(device, tmp_path, epochs=3, store=None):
    """The port's ``TorchEstimator`` in a world of one in this process
    (``device`` None: the card)."""
    import io
    import os
    import numpy as np
    import pandas as pd
    from horovod_tpu_torch.spark import FilesystemStore
    from horovod_tpu_torch.spark.backend import Backend
    from horovod_tpu_torch.spark.torch import TorchEstimator

    class InprocBackend(Backend):
        def num_processes(self):
            return 1

        def run(self, fn, args=(), extra_env=None):
            env = {"HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
                   "HOROVOD_LOCAL_RANK": "0", "HOROVOD_LOCAL_SIZE": "1",
                   "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1"}
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                return [fn(*args)]
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v

    rng = np.random.RandomState(0)
    x = rng.rand(64, 3).astype(np.float32)
    df = pd.DataFrame({"x": list(x), "y": x @ np.float32([1, -2, 0.5])})
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 1)
    store = store or FilesystemStore(str(tmp_path / str(device)))
    est = TorchEstimator(
        model=net, optimizer=torch.optim.SGD(net.parameters(), lr=0.2,
                                             momentum=0.5),
        loss=torch.nn.MSELoss(), feature_cols=["x"], label_cols=["y"],
        store=store, backend=InprocBackend(), epochs=epochs, batch_size=8,
        run_id="card", device=device)
    model = est.fit(df)
    raw = store.read(store.get_checkpoint_path("card"))
    return model, torch.load(io.BytesIO(raw), weights_only=False), df


def test_estimator_fits_on_the_card_as_on_the_cpu(cuda, tmp_path):
    card, card_ckpt, df = _inproc_fit(None, tmp_path)
    cpu, _, _ = _inproc_fit("cpu", tmp_path)
    assert next(card.getModel().parameters()).is_cuda
    torch.testing.assert_close(torch.tensor(card.history),
                               torch.tensor(cpu.history), atol=1e-5,
                               rtol=1e-5)
    for k, v in cpu.getModel().state_dict().items():
        torch.testing.assert_close(card.getModel().state_dict()[k].cpu(),
                                   v, atol=1e-5, rtol=1e-5)
    out = card.transform(df.head(4))
    assert len(out["y__output"]) == 4


def test_estimator_state_bytes_from_the_card_load_on_the_cpu(cuda,
                                                             tmp_path):
    """The Store's checkpoint saved by a rank on the card holds CPU
    tensors (the JAX package's loader passes no map_location)."""
    _, ckpt, _ = _inproc_fit(None, tmp_path, epochs=1)
    tensors = list(ckpt["model"].values()) + [
        v for s in ckpt["optimizer"]["state"].values() for v in s.values()
        if isinstance(v, torch.Tensor)]
    assert len(tensors) == 4                 # weight, bias, 2 momenta
    assert {t.device.type for t in tensors} == {"cpu"}


# ---------------------------------------------------------------------------
# Keras's torch-backend reducer on the card (needs no Keras).
# ---------------------------------------------------------------------------
_KERAS_REDUCER_BODY = """
import json
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import _keras
from horovod_tpu_torch.ops import fusion_buffer as fb
from horovod_tpu_torch.ops.compression import Compression
hvd.init()
rank, size = hvd.rank(), hvd.size()
g = torch.Generator(device="cuda").manual_seed(3 + rank)
grads = [torch.randn(s, device="cuda", generator=g)
         for s in ((768, 2304), (2304,), (50257, 768), (3, 5))]
fb.launches.update({k: 0 for k in fb.launches})
fb.plain_calls.update({k: 0 for k in fb.plain_calls})
checked = {}
for name, comp, pre in (("average", Compression.none, 1.0),
                        ("predivide", Compression.none, 2.0),
                        ("fp16", Compression.fp16, 1.0)):
    got = _keras._torch_grads_fn(comp, hvd.Average, pre,
                                 hvd.global_process_set)(
        [grads[0], None, grads[1], grads[2], grads[3]])
    assert got[1] is None
    got = [got[0]] + got[2:]
    packed = [comp.compress(t) for t in grads]
    want = [comp.decompress(o, ctx) for o, (_, ctx) in zip(
        hvd.grouped_allreduce([c for c, _ in packed], op=hvd.Sum,
                              prescale_factor=1.0 / pre,
                              postscale_factor=pre / size), packed)]
    checked[name] = all(
        a.device == b.device == t.device and a.dtype == t.dtype and
        torch.equal(a, b) for a, b, t in zip(got, want, grads))
print("RESULT " + json.dumps({
    "rank": rank, "checked": checked, "fusion": dict(fb.launches),
    "plain": dict(fb.plain_calls)}), flush=True)
hvd.shutdown()
"""


def _keras_reducer_results(out):
    import json
    res = {}
    for line in out.splitlines():
        _, _, rest = line.partition("<stdout>:")
        rest = rest or line
        if rest.startswith("RESULT "):
            r = json.loads(rest[len("RESULT "):])
            res[r["rank"]] = r
    return res


@pytest.mark.parametrize("nproc", [1, 2])
def test_keras_torch_reducer_on_the_card(cuda, tmp_path, nproc):
    """``_keras._torch_grads_fn`` on CUDA gradients, in a world of one and
    at two ranks sharing the card: bit-equal to ``grouped_allreduce`` with
    the same op and scales, outputs on the card in the gradients' dtype,
    never packed by the fusion kernel's plain version (a world of one
    scales without packing; two ranks pack with the kernel)."""
    from test_torch_port_multiproc import launcher_env, run_port_launcher
    script = tmp_path / "worker.py"
    script.write_text(_KERAS_REDUCER_BODY)
    rc, out = run_port_launcher(
        ["-np", str(nproc), "-H", f"localhost:{nproc}", sys.executable,
         str(script)], launcher_env(), timeout=300)
    assert rc == 0, out[-3000:]
    res = _keras_reducer_results(out)
    assert sorted(res) == list(range(nproc)), out[-3000:]
    for r in res.values():
        assert r["checked"] == {"average": True, "predivide": True,
                                "fp16": True}, r
        if nproc > 1:
            assert r["fusion"]["pack"] > 0 and r["fusion"]["unpack"] > 0, r
        assert r["plain"] == {"pack": 0, "unpack": 0}, r


def _tool(name, *args, timeout=600):
    """``python -m horovod_tpu_torch.tools.<name> *args`` with its default
    device (the card); returns (exit code, the JSON it printed last)."""
    import json
    import os
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.tools.{name}", *args],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=timeout)
    start = out.stdout.rfind("\n{\n")
    text = out.stdout[start + 1:] if start >= 0 else out.stdout
    return out.returncode, (json.loads(text) if text.startswith("{")
                            else out.stderr)


def test_staging_tool_on_the_card(cuda):
    """The torch lane is a ``cuda:0`` tensor over gloo (two ranks on one
    card), staged through pinned host memory; every sum is exact."""
    rc, data = _tool("measure_torch_staging", "--sizes", "1", "4")
    assert rc == 0, data
    assert data["device"] == "cuda" and data["exact"], data
    lanes = {r["input"]: r for r in data["allreduce"] if r["size_mb"] == 4}
    assert lanes["torch"]["device"] == "cuda:0"
    assert lanes["torch"]["backend"] == \
        "gloo, staged through pinned host memory"
    assert lanes["numpy"]["device"] == "cpu"
    assert sum(data["fusion_launches"].values()) > 0


def test_profiler_tool_on_the_card(cuda, tmp_path):
    """ResNet-50's step on the card, its trace's kernels by category."""
    rc, rep = _tool("profile_resnet", "--batch-size", "16", "--iters", "3",
                    "--warmup", "2", "--trace", str(tmp_path))
    assert rc == 0, rep
    assert rep["device"] == torch.cuda.get_device_name(0)
    assert rep["flops_per_step"] == 3 * 4.1e9 * 16
    assert rep["kernel_histogram"]["convolution"]["launches_per_step"] > 0
    if "H100 80GB HBM3" in rep["device"]:     # the table's one row
        assert rep["peak_bf16_tflops"] == 989.4 and rep["mfu"] > 0


_CHAOS_SCHEDULES = [
    {"index": 0, "spec": "chaos.baseline=delay(0s,times=0)", "seed": 7,
     "kind": "baseline"},
    {"index": 1, "spec": "worker.frame_send=drop(1,after=4,rank=3)",
     "seed": 3, "kind": "fault"},
    {"index": 2, "spec": "runtime.submit=crash(after=3,times=1,rank=5)",
     "seed": 11, "kind": "fault"},
]


@pytest.mark.parametrize("schedule", _CHAOS_SCHEDULES,
                         ids=lambda s: s["kind"] + str(s["index"]))
def test_chaos_schedule_on_the_card_equals_the_cpu(cuda, schedule):
    """The chaos soak's three tier-1 schedules at 8 thread ranks, each
    with its data-plane stream on the card: the outcome, the completed
    ops and the failpoint triggers of the same schedule on the CPU, and
    every result on ``cuda:0`` in float32."""
    from horovod_tpu_torch.tools import chaos_soak as cs
    kw = dict(ranks=8, n_ops=12, hang_timeout_s=30.0, stall_shutdown_s=2.0)
    placed0 = cs.result_placement()
    on_card = cs.run_schedule(dict(schedule), device="cuda", **kw)
    placed = cs.result_placement()
    on_cpu = cs.run_schedule(dict(schedule), device="cpu", **kw)
    for key in ("outcome", "ops_ok"):
        assert on_card[key] == on_cpu[key], (key, on_card, on_cpu)
    assert not on_card["hangs"] and not on_card["incorrect"], on_card
    assert {s: [r["triggers"] for r in rules]
            for s, rules in on_card["failpoint_triggers"].items()} == \
        {s: [r["triggers"] for r in rules]
         for s, rules in on_cpu["failpoint_triggers"].items()}
    grew = {d: {k: n - placed0.get(d, {}).get(k, 0) for k, n in by.items()}
            for d, by in placed.items()}
    assert grew.get("cuda:0", {}).get("yes", 0) > 0, grew
    assert all(n == 0 for d, by in grew.items() for k, n in by.items()
               if (d, k) != ("cuda:0", "yes")), grew


def test_dead_rank_cannot_wedge_a_survivors_stream(cuda):
    """A rank dies with a collective in flight: the survivor's handle
    fails within the exchange timeout, and the card then drains (the
    survivor's stream never waits on an event of the dead rank's)."""
    import threading

    import numpy as np

    from horovod_tpu_torch.tools import chaos_soak as cs
    world = cs.ChaosWorld(3, stall_shutdown_s=2.0, exchange_timeout_s=4.0,
                          device="cuda")
    errors = {}
    try:
        def go(r):
            try:
                world.collective(r, "allreduce", "wedge.t",
                                 np.full((65,), r + 1.0, np.float32), 0,
                                 20.0)
            except Exception as e:   # the death surfaces as an error
                errors[r] = e
        ts = [threading.Thread(target=go, args=(r,)) for r in (0, 1)]
        for t in ts:
            t.start()
        time.sleep(0.2)
        world.kill_rank(2)
        for t in ts:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in ts), "a survivor hung"
        assert sorted(errors) == [0, 1], errors
        done = threading.Event()
        threading.Thread(target=lambda: (torch.cuda.synchronize(),
                                         done.set()), daemon=True).start()
        assert done.wait(10.0), "the card did not drain"
    finally:
        world.close()
