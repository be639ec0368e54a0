"""The kernel build's cache key and the launch counters by body, on the
CPU (nothing is compiled here: ``library_path`` only names the library a
source and its headers would build)."""

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ssd


def test_library_path_hashes_source_headers_and_flags(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")          # an edited header
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("k") not in (first, second)


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "ssd_scan", "rg_lru"])
def test_attention_sources_build_with_ptxas_report(name):
    """The redesigned sources (attention, scans) report their resources."""
    assert ("-Xptxas", "-v") == tuple(_build._flags(name)[-2:])
    assert "-v" not in _build._flags("wavg")
    assert any(f.endswith("csrc") for f in _build._flags("wavg"))


def test_ptxas_lines_keep_registers_and_spills():
    log = ("ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
           "ptxas info    : Function properties for k\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 232 registers, used 1 barriers\n"
           "nvcc warning : something else\n")
    assert _build._ptxas_lines(log) == [
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'",
        "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 232 registers, used 1 barriers"]


def test_reset_launch_counts_zeroes_the_body_counters():
    fa.tc_launches, pa.split_launches, ssd.tc_launches = 3, 5, 7
    fa.window_launches = 2
    assert ops.body_launches() == {"flash_attention_tc": 3,
                                   "paged_decode_attention_split": 5,
                                   "ssd_scan_tc": 7,
                                   "flash_attention_window": 2}
    ops.reset_launch_counts()
    assert ops.body_launches() == {"flash_attention_tc": 0,
                                   "paged_decode_attention_split": 0,
                                   "ssd_scan_tc": 0,
                                   "flash_attention_window": 0}
    assert set(ops.launch_counts()) == {
        "flash_attention", "paged_decode_attention", "ssd_scan",
        "rg_lru_scan", "fused_adamw", "weighted_average",
        "quantize_stochastic", "dequantize", "topk_mask"}
