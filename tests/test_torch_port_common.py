"""The port's runtime pieces against the JAX package's: wire dtypes,
scaling, compression, the async handle API, the timeline, and the
kernel loader's build-cache key."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from horovod_tpu.common import message as ref_message
from horovod_tpu.ops import backend as ref_backend
from horovod_tpu.ops import compression as ref_compression
from horovod_tpu_torch import kernels
from horovod_tpu_torch.common import message
from horovod_tpu_torch.ops import backend
from horovod_tpu_torch.ops import compression

import horovod_tpu_torch.torch as hvd

NUMPY_DTYPES = ["uint8", "int8", "int16", "int32", "int64", "float16",
                "float32", "float64", "bool"]


@pytest.mark.parametrize("name", NUMPY_DTYPES)
def test_wire_dtype_matches_reference(name):
    arr = np.zeros(2, dtype=name)
    t = torch.from_numpy(arr)
    assert message.dtype_of(t) == ref_message.dtype_of(arr)
    assert message.torch_dtype(message.dtype_of(t)) == t.dtype


def test_bfloat16_has_its_wire_dtype():
    t = torch.zeros(2, dtype=torch.bfloat16)
    assert message.dtype_of(t) == ref_message.DataType.BFLOAT16
    assert message.torch_dtype(message.DataType.BFLOAT16) == torch.bfloat16


@pytest.mark.parametrize("name", ["int32", "int64", "uint8", "float32",
                                  "float64"])
@pytest.mark.parametrize("factor", [1.0, 0.5, 3.0, 1.0 / 3.0, -2.5])
def test_scale_matches_reference(name, factor):
    arr = (np.arange(-6, 6) * 7).astype(name)
    exp = ref_backend._scale(arr, factor)
    got = backend._scale(torch.from_numpy(arr), factor)
    assert got.dtype == torch.from_numpy(arr).dtype
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("rows,size", [(10, 3), (2, 4), (0, 2), (9, 1)])
def test_even_row_counts_matches_reference(rows, size):
    assert backend.even_row_counts(rows, size) == \
        ref_backend.even_row_counts(rows, size)


@pytest.mark.parametrize("name", ["float32", "float64", "float16", "int32"])
@pytest.mark.parametrize("algo", ["none", "fp16"])
def test_compression_matches_reference(name, algo):
    arr = (np.linspace(-3, 3, 7) * 1.37).astype(name)
    ref_c = getattr(ref_compression.Compression, algo)
    c = getattr(compression.Compression, algo)
    ref_wire, ref_ctx = ref_c.compress(arr)
    wire, ctx = c.compress(torch.from_numpy(arr))
    np.testing.assert_array_equal(wire.numpy(), np.asarray(ref_wire))
    back = c.decompress(wire, ctx)
    assert back.dtype == torch.from_numpy(arr).dtype
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_c.decompress(ref_wire, ref_ctx)))


@pytest.fixture(scope="module")
def hvd1():
    hvd.init()
    yield hvd
    hvd.shutdown()


def test_async_handles_and_poll(hvd1):
    x = torch.arange(4.0)
    h = hvd1.allreduce_async(x, name="port.async", op=hvd1.Sum)
    out = hvd1.synchronize(h)
    assert hvd1.poll(h)
    assert torch.equal(out, x)
    assert out.data_ptr() != x.data_ptr()


def test_allreduce_is_differentiable(hvd1):
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    hvd1.allreduce(x, op=hvd1.Sum).sum().backward()
    assert torch.equal(x.grad, torch.ones(2))


def test_fp16_compressed_allreduce_restores_dtype(hvd1):
    x = torch.tensor([0.1, 0.2, 0.3])
    out = hvd1.allreduce(x, op=hvd1.Sum,
                         compression=hvd1.Compression.fp16)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.half().float())


def test_world_of_one_queries(hvd1):
    assert (hvd1.rank(), hvd1.size(), hvd1.local_rank()) == (0, 1, 0)
    assert hvd1.join() == 0
    hvd1.barrier()
    from horovod_tpu_torch.common import basics
    assert basics.local_chips() == torch.cuda.device_count()


def test_timeline_records_torch_spans(hvd1, tmp_path):
    path = tmp_path / "timeline.json"
    hvd1.start_timeline(str(path))
    hvd1.allreduce(torch.ones(3), name="port.tl", op=hvd1.Sum)
    hvd1.stop_timeline()
    events = json.loads(path.read_text())
    names = {e.get("name") for e in events if isinstance(e, dict)}
    assert "TORCH_ALLREDUCE" in names


def test_device_trace_of_a_gpt_forward_parses(tmp_path):
    """start_xla_trace/stop_xla_trace (the JAX package's names) around a
    small GPT-2 forward write a Chrome trace into the log dir; on the
    CPU it holds the host ops and no device work."""
    from horovod_tpu_torch import profile_step
    from horovod_tpu_torch.common import timeline
    from horovod_tpu_torch.models import gpt
    cfg = gpt.gpt_tiny_config(dtype=torch.float32)
    model = gpt.GPTLMHeadModel(cfg, device="cpu", seed=0).eval()
    ids = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    timeline.start_xla_trace(str(tmp_path / "trace"))
    try:
        with torch.no_grad():
            model(ids)
    finally:
        path = timeline.stop_xla_trace()
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::layer_norm" in names and "aten::softmax" in names, names
    assert profile_step.device_ms_by_name(path) == {}


def test_device_trace_refuses_a_second_start_and_a_lone_stop(tmp_path):
    from horovod_tpu_torch.common import timeline
    with pytest.raises(RuntimeError, match="no device trace is running"):
        timeline.stop_xla_trace()
    timeline.start_xla_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            timeline.start_xla_trace(str(tmp_path))
    finally:
        timeline.stop_xla_trace()
    with pytest.raises(RuntimeError, match="no device trace is running"):
        timeline.stop_xla_trace()


def test_device_time_is_read_by_kernel_and_category(tmp_path):
    """The reader chip_smoke.py and profile_step share: device work
    (kernels, copies, sets) summed by name and by category; host ops
    and device-side annotations are not work."""
    from horovod_tpu_torch import profile_step
    flash = "void flash_fwd_wgmma_kernel<__nv_bfloat16, 64>(Params)"
    events = [
        {"ph": "X", "cat": "kernel", "name": flash, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": flash, "dur": 25.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16",
         "dur": 40.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 10.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
         "dur": 1000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 500.0},
        {"ph": "i", "cat": "kernel", "name": flash},
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    by_name = profile_step.device_ms_by_name(str(path))
    assert by_name == pytest.approx({flash: 0.075,
                                     "sm90_xmma_gemm_bf16": 0.04,
                                     "Memcpy HtoD": 0.01})
    by_cat = profile_step.ms_by_category(by_name)
    assert list(by_cat) == ["flash_fwd", "matmul_16bit", "other"]
    assert list(by_cat.values()) == pytest.approx([0.075, 0.04, 0.01])


def test_kernel_cache_key_follows_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(kernels, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    first = kernels.library_path("k.cu")
    assert first == kernels.library_path("k.cu")
    src.write_text("// two")
    assert kernels.library_path("k.cu") != first
    assert first.startswith(str(tmp_path / "build" / "k-"))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()


def test_failed_build_raises_and_loads_nothing(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// not built")
    monkeypatch.setattr(kernels, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "nvcc_path", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed to build k.cu"):
        kernels.load("k.cu")
    assert kernels._loaded == {}
    assert not os.path.exists(kernels.library_path("k.cu"))
