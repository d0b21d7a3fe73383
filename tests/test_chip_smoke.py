"""The GPU smoke run's own checks, on the CPU.

chip_smoke.py needs a card to run; what it decides with — the platform
check, the error measure, the fixture assembly — is tested here.
"""

import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_refuses_a_cpu_platform():
    import jax

    with pytest.raises(SystemExit, match="no GPU: JAX platform is cpu"):
        chip_smoke.check_platform(jax.devices())


def test_counts_gpu_devices():
    gpu = types.SimpleNamespace(platform="gpu")
    chip_smoke.check_platform([gpu])
    chip_smoke.check_platform([gpu] * 4, 4)
    with pytest.raises(SystemExit, match="need 4 GPU devices"):
        chip_smoke.check_platform([gpu], 4)
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_platform([gpu, types.SimpleNamespace(platform="cpu")], 2)


def test_rel_err():
    ref = np.array([1.0, 2e-5, 0.0, 4.0])
    assert chip_smoke.rel_err(ref, ref) == 0.0
    a = ref * np.array([1 + 1e-6, 1 + 1e-2, 1.0, 1 - 2e-6])
    assert chip_smoke.rel_err(a, ref) == pytest.approx(1e-2)
    # the floor drops the small entry from the measure
    assert chip_smoke.rel_err(a, ref, floor=1e-4) == pytest.approx(2e-6)
    assert chip_smoke.rel_err(a[:3], ref) == float("inf")
    assert chip_smoke.rel_err(np.where(ref == 0, 1e-30, ref), ref) == float("inf")
    assert chip_smoke.rel_err(np.array([np.nan, 0, 0, 4.0]), ref) == float("inf")


def test_mass_floor():
    h = np.array([[3.0, 1.0], [0.0, 6.0]])
    assert chip_smoke.mass_floor(h, 0.5) == pytest.approx(5.0)
    assert chip_smoke.rel_err(h * 1.1, h, chip_smoke.mass_floor(h, 0.5)) == (
        pytest.approx(0.1)
    )


def test_make_genome_is_the_concatenated_per_chromosome_fixture(tmp_path):
    """Chromosomes made in separate workers join into one fixture that
    reads like make_fixture's own, stream for stream."""
    sys.path.insert(0, os.path.dirname(__file__))
    from helpers.synth import make_fixture

    from colate_tpu.formats.colate_in import read_colate_in

    fix = chip_smoke.make_genome(str(tmp_path / "g"), 2, 400)
    assert fix["chroms"] == ["1", "2"]
    with open(fix["chrfile"]) as fh:
        assert fh.read().split() == ["1", "2"]
    assert sorted(os.listdir(tmp_path / "g")) == [
        "chr.txt", "ref.colate.in", "synth_chr1.mut", "synth_chr2.mut",
        "target.colate.in",
    ]
    for i, c in enumerate(fix["chroms"]):
        one = make_fixture(str(tmp_path / c), chroms=(c,), n_per_chrom=400,
                           seed=chip_smoke.SEED + 13 * i)
        with open(one["mut_prefix"] + f"_chr{c}.mut", "rb") as a, open(
            fix["mut_prefix"] + f"_chr{c}.mut", "rb"
        ) as b:
            assert a.read() == b.read()
        for key in ("target", "reference"):
            whole = read_colate_in(fix[key])
            part = read_colate_in(one[key])
            sel = whole.chrom == c
            np.testing.assert_array_equal(whole.bp[sel], part.bp)
            np.testing.assert_array_equal(whole.daf[sel], part.daf)
