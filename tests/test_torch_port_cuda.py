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
