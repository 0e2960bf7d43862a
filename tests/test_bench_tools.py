"""The measuring scripts refuse what they cannot measure: a device other
than the GPU, and a device kind without published peaks."""

import pytest

import bench
import bench_precision
import bench_roofline


def test_bench_refuses_cpu():
    with pytest.raises(SystemExit, match="'cpu'"):
        bench.device_info()


def test_precision_bench_refuses_cpu():
    with pytest.raises(SystemExit, match="'cpu'"):
        bench_precision.main([])


def test_precision_bench_tiny_batch():
    """Both variants compile with their dots at the level named (the
    script asserts it) and run on the same inputs; on the CPU DEFAULT is
    full f32, so the controls barely move."""
    out = bench_precision.measure(batch=8, rounds=1)
    assert out["highest_step_ms"] > 0.0 and out["default_step_ms"] > 0.0
    assert out["first_control_dev_max"] < 1e-3


def test_roofline_peaks_keyed_by_device_kind():
    h100 = bench_roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert h100["f32_flops"] == 67e12 and h100["hbm_bps"] == 3.35e12
    with pytest.raises(KeyError, match="no published peaks"):
        bench_roofline.peaks_for("cpu")
