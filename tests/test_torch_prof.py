"""prof.py's check of torch.profiler's kernel records against the launch
counters, on synthetic (name, count) lists: a breakdown is printed only
when every hand kernel the run launched has its device records."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from genrich_tpu_torch import kernels
from genrich_tpu_torch.prof import (_device_ms_by_card, comm_ms_by_card,
                                    cummax_records, record_shortfall)

# a warm main-path run: K1 3 calls, K2 3 (two kernels each), K5 3, K4 3
LAUNCHES = {"coverage_scan": 3, "tile_stats": 3, "fisher_combine": 0,
            "gap_join": 3, "peak_reduce": 3}
RECORDS = [
    ("void coverage_scan_kernel<2, false>(int const*, long, int const*, "
     "float, float*, float*, int*, long)", 3),
    ("tile_stats_table_kernel(float, float, Tables*)", 3),
    ("tile_stats_kernel(float const*, float const*, unsigned char const*, "
     "float, float, Tables const*, float*, long)", 3),
    ("(anonymous namespace)::gap_join_kernel((anonymous namespace)::Rows, "
     "int*, long, (anonymous namespace)::Out)", 3),
    ("peak_reduce_kernel(Rows, long const*, long const*, long, Out)", 3),
    ("Memcpy HtoD (Pageable -> Device)", 20),
]
# the parent's main path, where the gap-join ran as torch.cummax
CUMMAX = [
    ("void at::native::tensor_kernel_scan_innermost_dim_with_indices<long, "
     "long, std::greater_equal<long> >(...)", 12),
    ("void at::native::tensor_kernel_scan_innermost_dim_with_indices<int, "
     "long, std::greater_equal<int> >(...)", 3),
    ("Memcpy HtoD (Pageable -> Device)", 20),
]


def _drop(name, n=1):
    """RECORDS with ``n`` records lost from the kernel named ``name``."""
    return [(k, c - n if k.startswith(name) else c) for k, c in RECORDS]


@pytest.mark.parametrize("records,want", [
    (RECORDS, []),
    (_drop("void coverage_scan_kernel"), [("coverage_scan_kernel", 2, 3)]),
    (_drop("tile_stats_table_kernel"), [("tile_stats_table_kernel", 2, 3)]),
    (_drop("peak_reduce_kernel", 3), [("peak_reduce_kernel", 0, 3)]),
    (_drop("(anonymous namespace)::gap_join_kernel"),
     [("gap_join_kernel", 2, 3)]),
    (RECORDS + [("fisher_combine_kernel(float const*, int, long, float*)",
                 1)], [("fisher_combine_kernel", 1, 0)]),
    (RECORDS + [("(anonymous namespace)::gap_join_first_finish_kernel(int "
                 "const*, long, int const*, int const*, long, long*, long*, "
                 "unsigned char*, long*)", 3)], []),
], ids=["complete", "K1 lost", "K2 table lost", "K4 lost", "K5 lost",
        "extra K3", "K5 first design's finish"])
def test_record_shortfall(records, want):
    assert record_shortfall(records, LAUNCHES) == want


def test_cummax_records():
    """prof.py refuses a device run that still scans with torch.cummax."""
    assert cummax_records(RECORDS) == 0
    assert cummax_records(RECORDS + CUMMAX) == 15
    assert record_shortfall(RECORDS + CUMMAX, LAUNCHES) == []


def test_kernel_names_mangled_and_demangled():
    """The mangled names that graph capture reads and the profiler's
    demangled ones name the same kernels; the table kernel of K2 is not
    its main kernel."""
    assert kernels.is_kernel("_Z20coverage_scan_kernelILi2ELb0EEvPKil",
                             "coverage_scan_kernel")
    assert kernels.is_kernel("_Z17tile_stats_kernelPKfS0_PKhffPK6Tables",
                             "tile_stats_kernel")
    assert not kernels.is_kernel("_Z23tile_stats_table_kernelffP6Tables",
                                 "tile_stats_kernel")
    assert not kernels.is_kernel("tile_stats_table_kernel(float, float)",
                                 "tile_stats_kernel")
    assert kernels.is_kernel("tile_stats_table_kernel(float, float)",
                             "tile_stats_table_kernel")
    assert kernels.is_kernel("_Z15gap_join_kernel4RowsPilPhS1_S_S_",
                             "gap_join_kernel")
    assert kernels.is_kernel(
        "_ZN12_GLOBAL__N_115gap_join_kernelENS_4RowsEPilNS_3OutE",
        "gap_join_kernel")
    assert not kernels.is_kernel("gap_join_finish_kernel(int const*)",
                                 "gap_join_kernel")
    assert not kernels.is_kernel(
        "_ZN12_GLOBAL__N_121gap_join_first_kernelENS_4RowsEPilPhS2_PiS3_",
        "gap_join_kernel")
    assert kernels.KERNELS_PER_CALL["gap_join"] == ("gap_join_kernel",)
    assert sum(len(v) for v in kernels.KERNELS_PER_CALL.values()) == 6


def test_span_annotations_are_not_device_time():
    """The device-side copy of a ``pipeline.*`` span (a CUDA record that
    is a user annotation) spans its kernels' time: it is not counted as
    device time again."""
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, us, card=0, **kw):
        return SimpleNamespace(name=name, device_type=cuda, device_index=card,
                               self_device_time_total=us, **kw)
    events = [ev("coverage_scan_kernel", 300.0),
              ev("ncclDevKernel_AllGather_RING_LL", 50.0, 1),
              ev("pipeline.dispatch.tile_coverage", 400.0,
                 is_user_annotation=True),
              ev("pipeline.fetch.copy nccl", 60.0, 1,
                 is_user_annotation=True),
              SimpleNamespace(name="pipeline.cast", device_index=-1,
                              device_type=torch.autograd.DeviceType.CPU,
                              self_device_time_total=0.0)]
    prof = SimpleNamespace(events=lambda: events)
    assert _device_ms_by_card(prof) == {0: 0.3, 1: 0.05}
    assert comm_ms_by_card(prof) == {1: {"nccl": 0.05, "ptop": 0.0,
                                         "dtod": 0.0}}
