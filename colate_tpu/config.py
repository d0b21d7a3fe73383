"""Global constants and run configuration.

Constants mirror the reference defaults so outputs are comparable:
age-bin discretisation (reference include/coal/coal.cpp:3126-3137),
block size (:3139), EM iteration/convergence rules (:3656, :3822-3825),
initial rate and rate floor (:3636, :3798).
"""

from __future__ import annotations

import dataclasses
import math

# Age-bin discretisation: bin(t) = max(0, round(log(10 t) * C) + 1).
AGE_BIN_C: float = 10.0
NUM_AGE_BINS: int = int(math.log(1e8) * AGE_BIN_C) + 1  # 185

# Genome-position block used for the block bootstrap (30 Mb).
NUM_BASES_PER_BLOCK: int = 30_000_000

# Monte-Carlo draws per mutation in the reference parser (coal.cpp:2085).
NUM_MC_SAMPLES: int = 100

# EM defaults (coal.cpp:3636, 3656, 3798, 3822-3825).
INITIAL_COAL_RATE: float = 1.0 / 20000.0
COAL_RATE_FLOOR: float = 5e-9
EM_MAX_ITER: int = 100_000
EM_MIN_ITER: int = 1000
EM_CONV_RATIO: float = 1.0 - 1e-7

# Host/device EM dispatch threshold for one-shot (CLI) runs: up to this
# many bootstrap replicates the EM runs on the host (ops/em.py:
# run_em_native, linear in B), above it on the device, whose one-shot
# cost is dominated by the compile.  Carried over from the previous
# accelerator; the crossover has not been measured on the H100 yet.
EM_HOST_MAX_B: int = 800

# Normalisation applied to counts when a .colate_mat cache is written
# (coal.cpp:3453).
COLATE_MAT_NORM: float = 1e3

DEFAULT_YEARS_PER_GEN: float = 28.0


def age_bin_centers(num_bins: int = NUM_AGE_BINS, C: float = AGE_BIN_C):
    """Representative age per bin: age_bin[0]=0, age_bin[b]=exp((b-1)/C)/10.

    These are the point ages fed to the EM E-step (coal.cpp:3126-3137).
    """
    import numpy as np

    ages = np.empty(num_bins, dtype=np.float64)
    ages[0] = 0.0
    b = np.arange(1, num_bins, dtype=np.float64)
    ages[1:] = np.exp((b - 1.0) / C) / 10.0
    return ages


def age_bin_edges(num_bins: int = NUM_AGE_BINS, C: float = AGE_BIN_C):
    """Boundaries of the rounding bins.

    bin b (b>=1) collects t with round(log(10 t)*C)+1 == b, i.e.
    t in [exp((b-1.5)/C)/10, exp((b-0.5)/C)/10); bin 0 collects
    t < exp(-0.5/C)/10.  Returns edges[num_bins+1] with edges[0]=0 and
    edges[num_bins] = upper boundary of the last bin (draws above it are
    rejected and resampled by the reference parser).
    """
    import numpy as np

    edges = np.empty(num_bins + 1, dtype=np.float64)
    edges[0] = 0.0
    b = np.arange(1, num_bins + 1, dtype=np.float64)
    edges[1:] = np.exp((b - 1.5) / C) / 10.0
    return edges


def bin_of_age(age, num_bins: int = NUM_AGE_BINS, C: float = AGE_BIN_C):
    """Vectorised bin(t) = max(0, round(log(10 t)*C)+1), clipped to the table.

    Matches the reference's ``std::round`` (half away from zero) for the
    values that occur here (positive arguments near half-integers).
    Out-of-range high bins are CLIPPED to num_bins-1; the reference would
    index out of bounds for ages >= ~9.8e6 generations (undefined
    behaviour, unreachable with realistic inputs).
    """
    import numpy as np

    age = np.asarray(age, dtype=np.float64)
    with np.errstate(divide="ignore"):
        raw = np.floor(np.log(10.0 * age) * C + 0.5).astype(np.int64) + 1
    b = np.where(age > 0, raw, np.iinfo(np.int64).min)
    return np.clip(b, 0, num_bins - 1)


@dataclasses.dataclass
class MutRunConfig:
    """Configuration of a mode=mut run (flag surface of Colate.cpp:11-45)."""

    mut: str = ""
    output: str = ""
    chr_list: list[str] | None = None
    target_tmp: str | None = None
    reference_tmp: str | None = None
    target_bcf: str | None = None
    reference_bcf: str | None = None
    target_bam: str | None = None
    reference_bam: str | None = None
    ref_genome: str | None = None
    target_mask: str | None = None
    reference_mask: str | None = None
    coal: str | None = None
    bins: str | None = None
    target_age: float = 0.0
    reference_age: float = 0.0
    years_per_gen: float = DEFAULT_YEARS_PER_GEN
    num_bootstrap: int = 1
    seed: int | None = None
    filters: str = "20,30,10"
    # engine extensions (not in the reference)
    sampling: str = "analytic"  # "analytic" | "mc_parity"
    # EM working precision: "auto" = f64 on every backend (reference
    # numerics); "float32" opts into the f32 E-step
    em_dtype: str = "auto"  # "auto" | "float64" | "float32"
    # engine-level resume: cache the per-block histograms keyed by an
    # input fingerprint (utils/checkpoint.py); analytic mode only
    checkpoint: bool = False
    # per-chromosome target BAMs <target_bam>_chr<name>.bam — the
    # reference's parse_bamvcf layout (coal.cpp:1229-1510), whose CLI
    # dispatch is dead code there (coal.cpp:3273 commented out)
    per_chr_bam: bool = False
    # shard the bootstrap-EM (and, with binning="sharded", binning) over
    # the first N devices via parallel/mesh.py; None = single-device
    devices: int | None = None
    # analytic-binning backend: "auto" = native C++ f64 host binner with
    # device fallback; "native" = require it; "device" = the f32 XLA
    # slab path; "sharded" = the mesh path (parallel/mesh.py) on
    # max(devices,1) devices — bitwise-identical for any block-aligned
    # mesh size, which the multichip dry run asserts on the CPU
    binning: str = "auto"  # "auto" | "native" | "device" | "sharded"
