"""The build reports ``chip_smoke.py`` prints for K4 and K4b, and the
row-alignment rule of the bf16 tensor-core instances, checked on the CPU
with recorded tool output (no nvcc, cuobjdump or card needed)."""
import re
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as kfa

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_fwd_kernel_tcILi64EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_fwd_kernel_tcILi64EEEvPK13__nv_bfloat16
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 167 registers, used 1 barriers, 536 bytes cmem[0]
ptxas info    : Compile time = 90.1 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi16EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi16EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8192 bytes smem, 400 bytes cmem[0]
"""

SASS_DUMP = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_119flash_fwd_kernel_tcILi64EEEvPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                             /* 0x00000a00ff017b82 */
        /*0340*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0350*/              @P0  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0360*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
		Function : _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi16EEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R2, R3, R4, R2 ;
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


def test_ptxas_report_reads_each_kernel():
    rep = build.ptxas_report(PTXAS_LOG)
    tc = rep["_ZN12_GLOBAL__N_119flash_fwd_kernel_tcILi64EEEvPK13__nv_bfloat16"]
    assert tc == {"registers": 167, "smem": 0, "spill_stores": 8,
                  "spill_loads": 12}
    cc = rep["_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi16EEEvPKT_"]
    assert cc == {"registers": 40, "smem": 8192, "spill_stores": 0,
                  "spill_loads": 0}
    assert build.ptxas_report("") == {}


def test_sass_counts_count_tensor_core_opcodes(monkeypatch, tmp_path):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=SASS_DUMP)

    monkeypatch.setattr(build, "find_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    counts = build.sass_counts(tmp_path / "lib.so")
    assert calls[0][:2] == ["/cuda/bin/cuobjdump", "-sass"]
    assert counts == {
        "_ZN12_GLOBAL__N_119flash_fwd_kernel_tcILi64EEEvPK13__nv_bfloat16":
            {"HGMMA": 2, "HMMA": 0},
        "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi16EEEvPKT_":
            {"HGMMA": 0, "HMMA": 1}}


def test_build_keeps_the_compiler_report_beside_the_library(monkeypatch,
                                                            tmp_path):
    """A reused library comes back with the log of the build that made
    it, so its registers and spills can still be reported."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    src = build.sources()[0]
    lib = build._library_path(src)
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text(PTXAS_LOG)
    res = build.build_all([src.stem])[src.stem]
    assert res.seconds == 0.0 and res.log == PTXAS_LOG


@pytest.mark.parametrize("offset,stride_extra,ok", [
    (0, 0, True), (4, 0, False), (0, 4, False), (8, 8, True)])
def test_tensor_core_rows_must_be_16_byte_aligned(offset, stride_extra, ok):
    """bf16 rows start every 16 bytes or the wrapper raises; the check
    reads only the data pointer and the strides."""
    wide = torch.zeros(2, 16, 3, 64 + offset + stride_extra,
                       dtype=torch.bfloat16)
    view = wide[..., offset:offset + 64]
    if ok:
        kfa.check_tensor_core_rows({"q": view})
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            kfa.check_tensor_core_rows({"q": view})


def test_flash_sources_hold_the_tensor_core_instances():
    """The bf16 instances the dispatch names exist under the profiled
    name prefixes (flash_fwd_kernel*, flash_bwd_*)."""
    csrc = Path(build.CSRC)
    fwd = (csrc / "flash_attention.cu").read_text()
    bwd = (csrc / "flash_attention_bwd.cu").read_text()
    assert "flash_fwd_kernel_tc(" in fwd and "launch_tc<64>" in fwd
    assert "flash_bwd_dq_tc_kernel(" in bwd
    assert "flash_bwd_dkv_tc_kernel(" in bwd
    assert "wgmma.mma_async" in (csrc / "flash_tc.cuh").read_text()


def test_ssd_sources_hold_the_tensor_core_instances():
    """K5's bf16 instance: its product kernels exist as ``_tc`` kernels
    (the names chip_smoke checks for HGMMA and in the profiled serve),
    each issuing ``wgmma`` through the shared header, and the transposed
    A operand of the state product is a ``wgmma`` of its own."""
    csrc = Path(build.CSRC)
    src = (csrc / "ssd_scan.cu").read_text()
    hdr = (csrc / "flash_tc.cuh").read_text()
    assert '#include "flash_tc.cuh"' in src
    for name, mma in (("ssd_chunk_cb_tc", "tc::mma_ss<64>"),
                      ("ssd_chunk_state_tc", "tc::mma_ss_mn<64>"),
                      ("ssd_chunk_scan_tc", "tc::mma_rs<64>")):
        body = src.split(f"\n{name}(", 1)[1].split("\n}\n", 1)[0]
        assert mma in body, name
    assert "launch_tc<64>" in src and "launch_tc<128>" in src
    mn = hdr.split("void mma_ss_mn<64>", 1)[1].split("\n}\n", 1)[0]
    assert "wgmma.mma_async" in mn and "p, 1, 1, 1, 1;" in mn


def test_ssd_wrapper_picks_the_instance_by_dtype_and_width():
    """bf16 at P 64 with N 64 or 128 takes the tensor-core instance,
    everything else the CUDA-core one; the choice reads dtype and widths
    only."""
    from repro_torch.kernels import ssd_scan as kssd

    def pick(dtype, P, N):
        x = torch.zeros(1, 4, 2, P, dtype=dtype)
        b = torch.zeros(1, 4, 1, N, dtype=dtype)
        return kssd.instance(x, b)

    assert pick(torch.bfloat16, 64, 128) == kssd.TENSOR_CORES
    assert pick(torch.bfloat16, 64, 64) == kssd.TENSOR_CORES
    for args in ((torch.float32, 64, 128), (torch.bfloat16, 32, 128),
                 (torch.bfloat16, 64, 32), (torch.bfloat16, 16, 16)):
        assert pick(*args) == kssd.CUDA_CORES, args


def test_ssd_bwd_sources_hold_the_tensor_core_instance():
    """K5b's bf16 instance: its product kernels exist as ``_tc`` kernels
    (the names chip_smoke checks for HGMMA and in the profiled rounds),
    each issuing the ``wgmma`` forms it is built from, at both state
    widths, and nothing in the file sums with atomics."""
    csrc = Path(build.CSRC)
    src = (csrc / "ssd_scan_bwd.cu").read_text()
    assert '#include "flash_tc.cuh"' in src
    for name, mmas in (
            ("ssd_bwd_states_tc", ("tc::mma_ss_mn<64>",)),
            ("ssd_bwd_dbx_tc", ("tc::mma_ss<64>", "tc::mma_rs<64>",
                                "tc::mma_rs<N>")),
            ("ssd_bwd_dc_tc", ("tc::mma_ss<64>", "tc::mma_rs<N>"))):
        body = src.split(f"\n{name}(", 1)[1].split("\n}\n", 1)[0]
        for mma in mmas:
            assert mma in body, (name, mma)
    assert "launch_tc<64>" in src and "launch_tc<128>" in src
    assert not re.search(r"\batomic[A-Z]\w*\(|\bred\.", src)


def test_ssd_bwd_wrapper_takes_k5s_instance_rule():
    """K5b picks its instance by K5's rule (dtype and widths only) and
    counts the tensor-core launches beside all of them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan_bwd as kssdb
    src = Path(kssdb.__file__).read_text()
    assert "_ssd.instance(x, b)" in src
    assert "check_tensor_core_rows" in src
    kssdb.launches_tc = 3
    ops.reset_launch_counts()
    assert kssdb.launches_tc == 0 and kssdb.launches == 0


def test_chip_smoke_flags_ssd_product_kernels_off_the_tensor_cores():
    """The names chip_smoke's profiled rounds check: any CUDA-core
    product kernel of K5 or K5b fails, the ``_tc`` ones and the kernels
    without products (carries, finalize, sums) pass."""
    import importlib.util
    import sys
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_names",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cs
    try:
        spec.loader.exec_module(cs)
        ok = {f"void (anonymous namespace)::{n}<128>(...)": 1.0
              for n in cs.SSD_TC_KERNELS + cs.SSD_BWD_TC_KERNELS}
        ok.update({"(anonymous namespace)::ssd_bwd_carry_tc(...)": 1.0,
                   "(anonymous namespace)::ssd_bwd_finalize_tc(...)": 1.0,
                   "void (anonymous namespace)::ssd_bwd_group_sum<"
                   "__nv_bfloat16>(...)": 1.0,
                   "(anonymous namespace)::ssd_bwd_dalog(...)": 1.0,
                   "(anonymous namespace)::ssd_state_carry(...)": 1.0})
        cs.check_tc_names(ok, "test", family=cs.SSD_PRODUCT_KERNELS)
        for bad in ("ssd_bwd_chunk_cb<__nv_bfloat16>",
                    "ssd_bwd_chunk_state<__nv_bfloat16, true>",
                    "ssd_bwd_dxdt<__nv_bfloat16>",
                    "ssd_bwd_dcb<__nv_bfloat16, false>",
                    "ssd_chunk_scan<__nv_bfloat16>"):
            with pytest.raises(AssertionError, match="off the tensor"):
                cs.check_tc_names({**ok, bad: 1.0}, "test",
                                  family=cs.SSD_PRODUCT_KERNELS)
    finally:
        sys.modules.pop(spec.name, None)
