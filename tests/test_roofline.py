"""Roofline accounting: peaks keyed by device kind, bounds from shapes."""
import pytest

from pytorch_hmm_tpu.roofline import PEAKS, peaks, roofline


def test_h200_peaks_are_the_published_ones():
    p = peaks("NVIDIA H200")
    assert p["hbm_bytes_per_s"] == 4.8e12
    assert p["bf16_flops"] == 989e12
    assert p["tf32_flops"] == 495e12


def test_unknown_device_is_an_error():
    with pytest.raises(KeyError, match="no published peaks"):
        peaks("cpu")
    with pytest.raises(KeyError):
        roofline(1e-3, "Unlisted Device 1", hbm_bytes=1.0)


@pytest.mark.parametrize("kind", sorted(PEAKS))
def test_bound_at_the_bound_is_one(kind):
    # 4.8 GB at 4.8 TB/s is 1 ms: a 1 ms measurement sits at the bound.
    out = roofline(1e-3, kind, hbm_bytes=PEAKS[kind]["hbm_bytes_per_s"] * 1e-3)
    assert out["binding"] == "hbm"
    assert out["bound_ms"] == pytest.approx(1.0)
    assert out["frac_of_bound"] == pytest.approx(1.0)
    assert "mfu_pct" not in out


def test_matmul_bound_and_mfu():
    kind = "NVIDIA H200"
    flops = PEAKS[kind]["bf16_flops"] * 2e-3        # 2 ms at peak
    out = roofline(4e-3, kind, hbm_bytes=1e6, matmul_flops=flops,
                   matmul_rate="bf16_flops")
    assert out["binding"] == "matmul"
    assert out["frac_of_bound"] == pytest.approx(0.5)
    assert out["mfu_pct"] == pytest.approx(50.0)
