"""The port's kernel loader on the CPU: a library is named by its
source's hash, and the build report reads ptxas logs and cuobjdump
output.  Building itself needs nvcc and runs on the card
(``chip_smoke.py``)."""

import pytest

from horovod_tpu_torch import kernels

MANGLED = ("_ZN50_GLOBAL__N__fa680dea_17_flash_attn_fwd_cu_7f987fb922flash_"
           "fwd_wgmma_kernelI13__nv_bfloat16Li64EEEv14CUtensorMap_stS2_S2_"
           "PT_iiiifi")

PTXAS_LOG = f"""nvcc -gencode=arch=compute_90a,code=sm_90a ...
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{MANGLED}' for 'sm_90a'
ptxas info    : Function properties for {MANGLED}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers
ptxas warning : (C7508) setmaxnreg ignored; unable to determine register \
count at entry
"""

SASS = f"""
	code for sm_90a
		Function : {MANGLED}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;    /* 0x0 */
        /*0010*/               @P0 HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;  /* 0x0 */
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R88, R120, gdesc[UR16].tnspB, R88 ;  /* 0x0 */
        /*0030*/                   UTMALDG.3D [UR8], [UR4] ;  /* 0x0 */
        /*0040*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R2 ; /* 0x0 */
		Function : _Z5otherv
        /*0000*/                   EXIT ;    /* 0x0 */
"""


def test_library_and_log_are_named_by_the_source_hash(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(kernels, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = kernels.library_path("k.cu")
    assert first == kernels.library_path("k.cu")
    assert first.startswith(str(tmp_path / "build" / "k-"))
    assert kernels.log_path("k.cu") == first[:-len(".so")] + ".log"
    src.write_text("// two\n")
    assert kernels.library_path("k.cu") != first


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    # A source includes the headers beside it (hopper.cuh): a change to
    # one must rebuild every library.
    monkeypatch.setattr(kernels, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    alone = kernels.library_path("k.cu")
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    first = kernels.library_path("k.cu")
    header.write_text("// two\n")
    assert len({alone, first, kernels.library_path("k.cu")}) == 3


def test_parse_ptxas_log_reads_registers_spills_and_warnings():
    per_kernel, warnings = kernels.parse_ptxas_log(PTXAS_LOG)
    assert per_kernel[MANGLED] == {"spill_bytes": 12, "registers": 168}
    assert per_kernel["_Z5otherv"] == {"spill_bytes": 0, "registers": 40}
    assert len(warnings) == 1 and "C7508" in warnings[0]


@pytest.mark.parametrize("mnemonics,expect", [
    (("HGMMA", "UTMALDG", "SYNCS"), {"HGMMA": 2, "UTMALDG": 1, "SYNCS": 1}),
    (("LDC", "EXIT"), {"LDC": 1, "EXIT": 0}),
])
def test_count_sass_per_kernel(mnemonics, expect):
    counts = kernels.count_sass(SASS, mnemonics)
    assert counts[MANGLED] == expect
    assert sum(counts["_Z5otherv"].values()) == (1 if "EXIT" in mnemonics
                                                 else 0)
