"""Smoke run of colate_tpu on NVIDIA GPUs.

Drives mode `mut` end to end through ``colate_tpu.cli.main`` at the
width of a whole-genome deployment — one target against one reference
genome, 22 chromosomes x 2.25M .mut rows (about 22M accepted sites in
30 Mb bootstrap blocks), 1024 bootstrap replicates, epochs from
``--bins 3,7,0.2`` — on random inputs made from a seed.  Every device
kernel of that path runs compiled for the card and is compared with the
repository's plain reference.  All phases run in this one process; only
the fixture generator uses worker processes, which never import JAX.

    python chip_smoke.py               # one card, every phase
    python chip_smoke.py --devices 4   # only the sharded path on four
                                       # cards, and its one-card twin

Exits non-zero, printing no result, when JAX finds no GPU or a phase
fails.  The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 1234
BINS = "3,7,0.2"
WG_CHROMS, WG_ROWS = 22, 2_250_000  # whole genome, ~22M accepted sites
NS_CHROMS, NS_ROWS = 4, 300_000  # the B=1 north-star fixture
BOOTSTRAPS = 1024
TREES, TREE_HAPS, TREE_BINS = 60_000, 200, "2,6,0.25"  # tools/bench_tree.py
LA_ITEMS, LA_HAPS, LA_GROUPS, LA_BINS = 51_000, 20, 2, "2,6,0.5"  # tools/bench_aux.py
TREES_PER_BLOCK = 5000  # models/tree_coal.py:BLOCK_SIZE_TREES

# Tolerances, each with its reason:
# - device f64 EM vs the native f64 EM: the same fixed-point iteration in
#   f64 with reductions in another order (~1e-13 apart); a replicate may
#   stop one iteration apart when its logl ratio sits at the threshold.
EM_F64_RTOL, EM_ITER_SHARE = 1e-8, 0.01
# - f32 vs f64 EM: the tiered contract of tests/test_em_f32.py, its weak
#   tier without the open last epoch.  Where no data reach that epoch its
#   M-step takes a discrete branch: f64 keeps the initial rate (den == 0,
#   num tiny) while the f32 numerator underflows to 0 and the rate fills
#   forward from the epoch below.  Measured alike on the CPU and the GPU
#   (one replicate of 1024 off by 7.5e-2 on a 4 x 300k-row genome).
EM_F32_RTOL_IDENTIFIED, EM_F32_RTOL_WEAK = 1e-4, 2e-2
# - f32 device binning vs the f64 native binner, on bins holding at
#   least 1e-9 of a histogram's mass: per-site f32 rounding, and f32
#   sums over chunks of 262,144 sites (eps * sqrt(262144) ~ 3e-5).
BIN_RTOL, BIN_MASS_SHARE = 3e-5, 1e-9
# - tree and local-ancestry kernels vs their f64 twins: the device sums
#   each block with atomic scatter-adds in a run-dependent order, and
#   evaluates exposures as differences of prefix sums.
TREE_RTOL, TREE_MASS_SHARE = 1e-9, 1e-12
# - .coal values are printed with 6 significant digits.
PRINT_RTOL = 1e-5


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- checks


def check_platform(devices, count: int = 1) -> None:
    """Refuse anything but `count` or more GPU devices."""
    if len(devices) < count:
        raise SystemExit(f"need {count} GPU devices, JAX found {len(devices)}")
    bad = sorted({d.platform for d in devices[:count]} - {"gpu"})
    if bad:
        raise SystemExit(f"no GPU: JAX platform is {', '.join(bad)}")


def rel_err(a, ref, floor: float = 0.0) -> float:
    """Largest |a - ref| / |ref| over the entries with |ref| >= floor;
    inf when shapes differ, when `a` is not finite, or when `a` is
    nonzero at a zero of `ref` that the floor keeps (floor 0)."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    if a.shape != ref.shape or not np.all(np.isfinite(a)):
        return float("inf")
    m = np.abs(ref) >= floor
    if np.any(m & (ref == 0) & (a != 0)):
        return float("inf")
    m &= ref != 0
    if not m.any():
        return 0.0
    return float(np.max(np.abs(a[m] - ref[m]) / np.abs(ref[m])))


def mass_floor(ref, share: float) -> float:
    """Magnitude an entry of `ref` needs to hold `share` of its total."""
    return share * float(np.abs(np.asarray(ref, np.float64)).sum())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


# --------------------------------------------------------------- fixture


def _make_chrom(job) -> None:
    """One chromosome of the fixture (runs in a worker without JAX)."""
    root, chrom, rows, seed = job
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from helpers.synth import make_fixture

    make_fixture(root, chroms=(chrom,), n_per_chrom=rows, seed=seed)


def _workers(jobs: int) -> int:
    """Fixture workers: one per core, at most one per ~4 GB available
    (a 2.25M-row chromosome peaks near 3 GB)."""
    n = os.cpu_count() or 1
    try:
        with open("/proc/meminfo") as fh:
            kb = next(int(ln.split()[1]) for ln in fh
                      if ln.startswith("MemAvailable:"))
        n = min(n, max(1, kb // (4 << 20)))
    except (OSError, StopIteration, ValueError):
        pass
    return max(1, min(n, jobs))


def make_genome(root: str, n_chroms: int, rows: int) -> dict:
    """A tmptmp fixture of `n_chroms` chromosomes made by
    tests/helpers/synth.make_fixture, one chromosome per worker.  A
    .colate.in holds header-less records, so the genome's streams are
    the per-chromosome streams concatenated in chromosome order."""
    chroms = [str(i + 1) for i in range(n_chroms)]
    jobs = [(os.path.join(root, f"part{c}"), c, rows, SEED + 13 * i)
            for i, c in enumerate(chroms)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(_workers(len(jobs))) as pool:
        pool.map(_make_chrom, jobs)
    for name in ("target.colate.in", "ref.colate.in"):
        with open(os.path.join(root, name), "wb") as out:
            for part, *_ in jobs:
                with open(os.path.join(part, name), "rb") as fh:
                    shutil.copyfileobj(fh, out)
    for (part, c, *_) in jobs:
        os.replace(os.path.join(part, f"synth_chr{c}.mut"),
                   os.path.join(root, f"synth_chr{c}.mut"))
        shutil.rmtree(part)
    chrfile = os.path.join(root, "chr.txt")
    with open(chrfile, "w") as fh:
        fh.write("\n".join(chroms) + "\n")
    return dict(
        chroms=chroms, mut_prefix=os.path.join(root, "synth"),
        target=os.path.join(root, "target.colate.in"),
        reference=os.path.join(root, "ref.colate.in"), chrfile=chrfile,
    )


def timed_genome(root: str, n_chroms: int, rows: int) -> dict:
    t0 = time.time()
    fix = make_genome(root, n_chroms, rows)
    say(f"fixture {n_chroms} x {rows} rows: {time.time() - t0:.1f} s")
    return fix


# ------------------------------------------------------------------- CLI


def mut_argv(fix: dict, out: str, *extra: str) -> list[str]:
    return [
        "--mode", "mut", "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"], "--bins", BINS, "--seed", "1", "-o", out,
        *extra,
    ]


def run_cli(argv: list[str]) -> tuple[float, dict]:
    """``colate_tpu.cli.main(argv)`` in this process: (wall seconds,
    its structured log records by event name).  Its log goes to stderr
    only when it fails."""
    from colate_tpu import cli

    os.environ["COLATE_TPU_LOG"] = "json"
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stderr(buf):
            rc = cli.main(argv)
    except BaseException:
        sys.stderr.write(buf.getvalue())
        raise
    wall = time.time() - t0
    if rc != 0:
        sys.stderr.write(buf.getvalue())
    require(rc == 0, f"colate_tpu {' '.join(argv)} exited {rc}")
    events = {}
    for ln in buf.getvalue().splitlines():
        if ln.startswith("{"):
            with contextlib.suppress(ValueError):
                rec = json.loads(ln)
                events[rec.get("event")] = rec
    return wall, events


def stages(events: dict) -> str:
    t = events["mut_done"]["timings"]
    return " ".join(f"{k}={v}" for k, v in t.items())


def read_rates(out: str) -> np.ndarray:
    from colate_tpu.formats.coal import CoalFile

    return CoalFile.read(out + ".coal").rates


# ---------------------------------------------------------------- phases


def phase_device(count: int):
    import jax

    devices = jax.devices()
    check_platform(devices, count)
    d = devices[0]
    say(f"device: {d.device_kind}, {len(devices)} x {d.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    say(smi.stdout.strip())
    os.environ["COLATE_NATIVE_REQUIRED"] = "1"
    from colate_tpu import native

    require(native.load() is not None, "native library build")
    return d


def phase_north_star(fix: dict, work: str) -> None:
    out = os.path.join(work, "ns")
    wall, ev = run_cli(mut_argv(fix, out))
    provider = ev["mut_em"]["provider"]
    rates = read_rates(out)
    say(f"north star B=1: {wall:.2f} s, sites={ev['mut_done']['sites']}, "
        f"em={provider}, {stages(ev)}")
    require(provider == "native", f"B=1 EM provider {provider}")
    require(rates.shape[0] == 1 and np.all(np.isfinite(rates))
            and np.any(rates > 0), "north-star rates")


def wg_counts(fix: dict, work: str):
    """The bootstrap count matrices the CLI's EM sees on `fix`
    (models/mut_em.py: compute_suffstats + the bootstrap of
    finish_from_suffstats, seed 1)."""
    from colate_tpu.config import MutRunConfig
    from colate_tpu.models.mut_em import compute_suffstats, resolve_tmp_inputs
    from colate_tpu.ops.bootstrap import (
        bootstrap_weights, redistribute_emp, weighted_counts,
    )

    cfg = MutRunConfig(
        mut=fix["mut_prefix"], output=os.path.join(work, "counts"),
        chr_list=fix["chroms"], target_tmp=fix["target"],
        reference_tmp=fix["reference"], bins=BINS, seed=1,
        num_bootstrap=BOOTSTRAPS,
    )
    chroms, muts, tm, rm = resolve_tmp_inputs(cfg)
    sh, ns, se, ne, _, nb = compute_suffstats(
        cfg, chroms, muts, tm, rm, 0.0, 0.0, False, None, 1, {},
    )
    w = bootstrap_weights(BOOTSTRAPS, nb, seed=1)
    sc, nc, sec, nec = weighted_counts(w, sh, ns, se, ne)
    return redistribute_emp(sc, sec, nec, age=0.0), nc


def phase_em(fix: dict, work: str, device) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    from colate_tpu.config import INITIAL_COAL_RATE
    from colate_tpu.ops.em import run_em, run_em_native
    from colate_tpu.ops.epochs import epochs_from_bins

    out = os.path.join(work, "wg64")
    argv = mut_argv(fix, out, "--num_bootstraps", str(BOOTSTRAPS))
    cold, _ = run_cli(argv)
    warm, ev = run_cli(argv)
    provider = ev["mut_em"]["provider"]
    say(f"whole genome B={BOOTSTRAPS} f64: cold {cold:.2f} s, warm "
        f"{warm:.2f} s, sites={ev['mut_done']['sites']}, "
        f"blocks={ev['mut_done']['blocks']}, em={provider}, {stages(ev)}")
    require(provider == "jax:float64", f"B={BOOTSTRAPS} EM provider {provider}")
    stats = device.memory_stats() or {}
    say(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    sc, nc = wg_counts(fix, work)
    epochs, _ = epochs_from_bins(BINS, 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)
    t0 = time.time()
    r_dev, _, it_dev = jax.block_until_ready(run_em(
        jnp.asarray(epochs), jnp.asarray(init), jnp.asarray(sc),
        jnp.asarray(nc), dtype="float64",
    ))
    t_dev = time.time() - t0
    t0 = time.time()
    r_nat, _, it_nat = run_em_native(epochs, init, sc, nc)
    t_nat = time.time() - t0
    r_dev, it_dev = np.asarray(r_dev), np.asarray(it_dev)
    err = rel_err(r_dev, r_nat, floor=1e-4)
    n_iter = int(np.sum(it_dev != it_nat))
    say(f"device f64 EM {t_dev:.2f} s vs native {t_nat:.2f} s: max relerr "
        f"{err:.3e} on rates >= 1e-4, {n_iter}/{BOOTSTRAPS} replicates "
        f"with another iteration count")
    require(err <= EM_F64_RTOL, f"device EM relerr {err:.3e} > {EM_F64_RTOL}")
    require(n_iter <= EM_ITER_SHARE * BOOTSTRAPS, "EM iteration counts")
    printed = read_rates(out)
    perr = rel_err(printed, r_dev)
    say(f"CLI .coal vs device EM: max relerr {perr:.3e}")
    require(perr <= PRINT_RTOL, "CLI .coal disagrees with the device EM")

    out32 = os.path.join(work, "wg32")
    argv32 = mut_argv(fix, out32, "--num_bootstraps", str(BOOTSTRAPS),
                      "--em_dtype", "float32")
    cold32, _ = run_cli(argv32)
    warm32, ev32 = run_cli(argv32)
    provider = ev32["mut_em"]["provider"]
    r32 = read_rates(out32)
    e_id = rel_err(r32, printed, floor=1e-4)
    e_weak = rel_err(r32[:, :-1], printed[:, :-1], floor=1e-6)
    e_last = rel_err(r32[:, -1], printed[:, -1], floor=1e-6)
    say(f"whole genome B={BOOTSTRAPS} f32: cold {cold32:.2f} s, warm "
        f"{warm32:.2f} s (f64 warm {warm:.2f} s), em={provider}, "
        f"{stages(ev32)}; vs f64 "
        f"relerr {e_id:.3e} (>= 1e-4), {e_weak:.3e} (>= 1e-6 below the "
        f"last epoch), {e_last:.3e} (last epoch, >= 1e-6)")
    require(provider == "jax:float32", f"f32 EM provider {provider}")
    require(e_id <= EM_F32_RTOL_IDENTIFIED and e_weak <= EM_F32_RTOL_WEAK,
            "f32 EM outside the tiered contract")


def phase_binning(fix: dict, work: str) -> None:
    from colate_tpu.formats.colate_in import read_colate_in
    from colate_tpu.formats.mut import MutTable
    from colate_tpu.pipeline.binning import (
        bin_sites_analytic, bin_sites_analytic_native,
    )
    from colate_tpu.pipeline.join import join_tmptmp

    wall, ev = run_cli(mut_argv(fix, os.path.join(work, "bindev"),
                                "--binning", "device"))
    say(f"--binning device B=1: {wall:.2f} s, {stages(ev)}")
    sites = join_tmptmp(
        fix["chroms"],
        [MutTable.read(f"{fix['mut_prefix']}_chr{c}.mut") for c in fix["chroms"]],
        read_colate_in(fix["target"]), read_colate_in(fix["reference"]),
    )
    t0 = time.time()
    dev = bin_sites_analytic(sites)
    t_dev = time.time() - t0
    t0 = time.time()
    ref = bin_sites_analytic_native(sites)
    t_nat = time.time() - t0
    errs = [rel_err(a, b, mass_floor(b, BIN_MASS_SHARE))
            for a, b in zip(dev, ref)]
    n = len(sites)
    say(f"device binning {n} sites: {t_dev:.2f} s ({n / t_dev:.0f} sites/s), "
        f"native {t_nat:.2f} s; max relerr per histogram "
        + ", ".join(f"{e:.3e}" for e in errs))
    require(max(errs) <= BIN_RTOL, "device binning vs native")


def phase_tree_kernels() -> None:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from helpers.synth_anc import random_trees

    from colate_tpu.models.tree_coal import _populate_numpy_chunk
    from colate_tpu.ops.epochs import epochs_from_bins
    from colate_tpu.ops.la_kernel import (
        la_accumulate_device, la_accumulate_native,
    )
    from colate_tpu.ops.tree_kernel import (
        populate_device, populate_device_sorted, sorted_case_applicable,
    )

    g = np.random.default_rng(SEED)
    T, N = TREES, TREE_HAPS
    _, ages = random_trees(g, T, N)
    coords = ages.astype(np.float32)
    spans = g.uniform(1e3, 1e5, T)
    blocks = (np.arange(T) // TREES_PER_BLOCK).astype(np.int32)
    nb = int(blocks[-1]) + 1
    epochs, _ = epochs_from_bins(TREE_BINS, 28.0, 0.0)
    require(sorted_case_applicable(coords, N), "sorted tree fixture")
    num_ref = np.zeros((nb, epochs.size))
    den_ref = np.zeros((nb, epochs.size))
    for lo in range(0, T, 2000):
        nt, dt = _populate_numpy_chunk(coords[lo:lo + 2000],
                                       spans[lo:lo + 2000], epochs, N)
        np.add.at(num_ref, blocks[lo:lo + 2000], nt)
        np.add.at(den_ref, blocks[lo:lo + 2000], dt)
    for name, fn in (("device", populate_device),
                     ("device-sorted", populate_device_sorted)):
        fn(coords, spans, blocks, epochs, N, nb)  # compile
        t0 = time.time()
        num, den = fn(coords, spans, blocks, epochs, N, nb)
        dt = time.time() - t0
        e = max(rel_err(num, num_ref, mass_floor(num_ref, TREE_MASS_SHARE)),
                rel_err(den, den_ref, mass_floor(den_ref, TREE_MASS_SHARE)))
        say(f"tree populate {name} {T} trees x {N} haplotypes: {dt:.3f} s, "
            f"max relerr vs numpy {e:.3e}")
        require(e <= TREE_RTOL, f"tree populate {name}")

    S, N, G = LA_ITEMS, LA_HAPS, LA_GROUPS
    parent, ages = random_trees(g, S, N)
    M = 2 * N - 1
    # children of each internal node, in index order (each has two)
    order = np.argsort(parent[:, : M - 1], axis=1, kind="stable")
    c1 = order[:, 0::2].astype(np.int32)
    c2 = order[:, 1::2].astype(np.int32)
    lab = g.integers(0, G, (S, N)).astype(np.int32)
    w = g.uniform(1e-6, 1e-4, S)
    la_blocks = (np.arange(S) // TREES_PER_BLOCK).astype(np.int32)
    la_nb = int(la_blocks[-1]) + 1
    la_epochs, _ = epochs_from_bins(LA_BINS, 28.0, 0.0)
    args = (parent.astype(np.int32), ages[:, N:], lab, c1, c2, w, la_blocks,
            la_epochs, G, la_nb)
    la_accumulate_device(*args)  # compile
    t0 = time.time()
    num, den = la_accumulate_device(*args)
    dt = time.time() - t0
    num_ref, den_ref = la_accumulate_native(*args)
    e = max(rel_err(num, num_ref, mass_floor(num_ref, TREE_MASS_SHARE)),
            rel_err(den, den_ref, mass_floor(den_ref, TREE_MASS_SHARE)))
    say(f"local-ancestry device {S} items x {N} haplotypes: {dt:.3f} s, "
        f"max relerr vs native {e:.3e}")
    require(e <= TREE_RTOL, "local-ancestry device kernel")


def phase_sharded(fix: dict, work: str, n: int) -> None:
    from colate_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n)
    check_platform(list(mesh.devices.ravel()), n)
    outs = {}
    for k in (n, 1):
        out = os.path.join(work, f"mesh{k}")
        wall, ev = run_cli(mut_argv(
            fix, out, "--num_bootstraps", str(BOOTSTRAPS),
            "--devices", str(k), "--binning", "sharded",
        ))
        say(f"--devices {k} --binning sharded B={BOOTSTRAPS}: {wall:.2f} s, "
            f"em={ev['mut_em']['provider']}, {stages(ev)}")
        with open(out + ".coal", "rb") as fh:
            outs[k] = fh.read()
    if outs[n] == outs[1]:
        say(f".coal on {n} devices vs 1: byte-identical")
        return
    a, b = read_rates(os.path.join(work, f"mesh{n}")), read_rates(
        os.path.join(work, "mesh1"))
    e_id, e_weak = rel_err(a, b, floor=1e-4), rel_err(a, b, floor=1e-6)
    say(f".coal on {n} devices vs 1: not byte-identical; relerr {e_id:.3e} "
        f"(>= 1e-4), {e_weak:.3e} (>= 1e-6)")
    require(e_id <= PRINT_RTOL and e_weak <= EM_F32_RTOL_WEAK,
            "sharded run vs one device")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the sharded path on this many cards "
                         "and its one-card twin")
    args = ap.parse_args(argv)

    device = phase_device(args.devices)
    work = tempfile.mkdtemp(prefix="colate_smoke_")
    try:
        if args.devices > 1:
            fix = timed_genome(os.path.join(work, "wg"), WG_CHROMS, WG_ROWS)
            phase_sharded(fix, work, args.devices)
        else:
            fix = timed_genome(os.path.join(work, "wg"), WG_CHROMS, WG_ROWS)
            ns = timed_genome(os.path.join(work, "ns"), NS_CHROMS, NS_ROWS)
            phase_north_star(ns, work)
            phase_em(fix, work, device)
            phase_binning(fix, work)
            phase_tree_kernels()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
