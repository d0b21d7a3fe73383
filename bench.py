"""Benchmark: mode `mut` end-to-end sites/s vs the reference binary.

Workload: synthetic tmptmp run (4 chromosomes x 300k mutation rows,
~500k accepted sites) with default bins 3,7,0.2 — the BASELINE.json
north-star configuration.  The reference binary is built from
/root/reference on demand; its wall-clock on the identical inputs in the
same run is the baseline (there are no published numbers, BASELINE.md);
without it vs_baseline is 0.

Besides the north-star it measures the device-scale workloads and
writes every number to BENCH_DETAILS.json in the bench directory:
- bootstrap-batched EM at B=8, 128 and 1024: reference-style sequential
  host EM vs the batched [B,185,E] JAX EM on the device (the reference
  runs bootstraps one at a time, coal.cpp:3675);
- 10M-site analytic binning: host-native vs the slab-streamed device
  kernel;
- whole-genome mode mut at B=1024, device EM vs host EM.

Every section runs in a child process, one at a time, and this parent
never initialises a JAX backend, so one process at a time holds the
device.

Prints ONE json line:
  {"metric": "mut_sites_per_sec", "value": N, "unit": "sites/s", "vs_baseline": N}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

# a silent Python fallback must not masquerade as an engine regression:
# every benched path requires the native library (VERDICT r2 #8)
os.environ.setdefault("COLATE_NATIVE_REQUIRED", "1")

BENCH_DIR = os.path.join(tempfile.gettempdir(), "colate_bench")
WG_DIR = os.path.join(tempfile.gettempdir(), "colate_bench_wg")
N_CHROMS = 4
N_PER_CHROM = 300_000
SEED = 1234
WG_CHROMS = 22
WG_PER_CHROM = 2_250_000  # ~22M accepted sites after filters
WG_BOOTSTRAPS = 1024


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def ensure_fixture():
    from helpers.synth import make_fixture

    marker = os.path.join(BENCH_DIR, "ready.json")
    chroms = [str(i + 1) for i in range(N_CHROMS)]
    if os.path.exists(marker):
        with open(marker) as fh:
            meta = json.load(fh)
        if meta.get("n") == N_PER_CHROM and meta.get("chroms") == chroms:
            log("bench fixture cached")
            fix = dict(
                root=BENCH_DIR,
                chroms=chroms,
                mut_prefix=os.path.join(BENCH_DIR, "synth"),
                target=os.path.join(BENCH_DIR, "target.colate.in"),
                reference=os.path.join(BENCH_DIR, "ref.colate.in"),
                chrfile=os.path.join(BENCH_DIR, "chr.txt"),
            )
            return fix
    log(f"generating bench fixture ({N_CHROMS}x{N_PER_CHROM} rows)...")
    t0 = time.time()
    fix = make_fixture(
        BENCH_DIR, chroms=tuple(chroms), n_per_chrom=N_PER_CHROM, seed=SEED
    )
    fix.pop("mut_tables", None)
    with open(marker, "w") as fh:
        json.dump({"n": N_PER_CHROM, "chroms": chroms}, fh)
    log(f"fixture generated in {time.time() - t0:.1f}s")
    return fix


def ensure_oracle() -> str | None:
    path = "/tmp/refbin/Colate"
    if os.path.exists(path):
        return path
    try:
        subprocess.run(
            ["bash", os.path.join(REPO, "tools", "build_reference_oracle.sh")],
            check=True,
            capture_output=True,
            timeout=600,
        )
        return path if os.path.exists(path) else None
    except Exception as e:  # no toolchain / no reference mount
        log(f"oracle build unavailable: {e}")
        return None


def time_reference(fix, oracle: str) -> tuple[float, float]:
    out = os.path.join(BENCH_DIR, "ref_bench_out")
    for f in (out + ".coal", out + ".colate_mat"):
        if os.path.exists(f):
            os.remove(f)
    cmd = [
        oracle, "--mode", "mut",
        "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"],
        "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"],
        "--bins", "3,7,0.2",
        "--seed", "1",
        "-o", out,
    ]
    # best-of-2: the box has 2 shared vCPUs, single runs are noisy
    best = None
    for _ in range(2):
        for f in (out + ".coal", out + ".colate_mat"):
            if os.path.exists(f):
                os.remove(f)
        t0 = time.time()
        subprocess.run(cmd, check=True, capture_output=True, timeout=3600)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return best, t0


def time_ours(fix) -> tuple[float, int, dict]:
    from colate_tpu.config import MutRunConfig
    from colate_tpu.models.mut_em import run_mut_and_write

    cfg = MutRunConfig(
        mut=fix["mut_prefix"],
        output=os.path.join(BENCH_DIR, "our_bench_out"),
        chr_list=fix["chroms"],
        target_tmp=fix["target"],
        reference_tmp=fix["reference"],
        bins="3,7,0.2",
        seed=1,
        sampling="analytic",
    )
    # warm-up absorbs one-time XLA compiles (shape-stable kernels)
    log("warm-up run...")
    res = run_mut_and_write(cfg)
    # best-of-3 timed runs: the 2 shared vCPUs make single runs noisy
    best = None
    for i in range(3):
        log(f"timed run {i}...")
        t0 = time.time()
        res = run_mut_and_write(cfg)
        dt = time.time() - t0
        if best is None or dt < best[0]:
            best = (dt, res.num_sites, res.timings)
    return best


def _suffstats(fix):
    """Fused-native sufficient statistics for the bench fixture."""
    from colate_tpu.formats.colate_in import read_colate_in
    from colate_tpu.pipeline.join import fused_tmptmp_hists

    files = [f"{fix['mut_prefix']}_chr{c}.mut" for c in fix["chroms"]]
    tgt = read_colate_in(fix["target"])
    ref = read_colate_in(fix["reference"])
    hists, ns, nb = fused_tmptmp_hists(
        fix["chroms"], files, tgt, ref, None, None
    )
    return hists, ns, nb


def bench_em_batched(fix, details: dict, oracle: str | None) -> None:
    """Bootstrap-batched EM: sequential host provider vs batched device EM.

    The reference runs its bootstraps sequentially (coal.cpp:3675); the
    host provider (native/em.cpp) replicates that loop ~20x faster, and
    the JAX path runs all replicates as one [B,185,E] batch on the device.
    """
    import numpy as np

    from colate_tpu.config import INITIAL_COAL_RATE
    from colate_tpu.hostrng import MT19937
    from colate_tpu.ops.bootstrap import (
        bootstrap_weights,
        redistribute_emp,
        weighted_counts,
    )
    from colate_tpu.ops.em import run_em, run_em_native
    from colate_tpu.ops.epochs import epochs_from_bins

    (sh_b, ns_b, se_b, ne_b), num_sites, nb = _suffstats(fix)
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)

    import jax
    import jax.numpy as jnp

    # B=8 sits at the small-B dispatch boundary (host-native vs device);
    # 128/1024 are the device-dominant bootstrap tiers (VERDICT r4 #8)
    for B in (8, 128, 1024):
        # distinct counts per timed repetition: the runtime memoises
        # repeat executions with identical input buffers, so re-timing
        # the same arrays reads ~0
        reps = []
        for seed in (1, 2, 3):
            w = bootstrap_weights(B, nb, rng=MT19937(seed), seed=seed)
            sc_i, nc_i, se, ne = weighted_counts(w, sh_b, ns_b, se_b, ne_b)
            sc_i = redistribute_emp(sc_i, se, ne, age=0.0)
            reps.append((sc_i, nc_i))
        sc, nc = reps[-1]

        t0 = time.time()
        r_h, _, _ = run_em_native(epochs, init, sc, nc)
        t_host = time.time() - t0

        e_j, i_j = jnp.asarray(epochs), jnp.asarray(init)
        t0 = time.time()
        out = run_em(
            e_j, i_j, jnp.asarray(reps[0][0]), jnp.asarray(reps[0][1]),
            dtype="float32",
        )
        jax.block_until_ready(out)
        t_cold = time.time() - t0
        t_dev = None
        # timed inputs were never executed before (no memoised replays);
        # the loop ends on reps[-1], matching r_h above
        for sc_i, nc_i in reps[1:]:
            t0 = time.time()
            out = run_em(
                e_j, i_j, jnp.asarray(sc_i), jnp.asarray(nc_i), dtype="float32"
            )
            jax.block_until_ready(out)
            dt = time.time() - t0
            t_dev = dt if t_dev is None else min(t_dev, dt)
        r_d = np.asarray(out[0])
        # tiered accuracy (tests/test_em_f32.py contract): identified
        # rates are tight; near-floor rates are mid-transient artifacts
        # of the stopping rule and carry no statistical signal
        m_id = r_h >= 1e-4
        m_weak = r_h >= 1e-6
        rel = np.abs(r_d - r_h) / np.maximum(r_h, 1e-300)
        details[f"em_B{B}"] = {
            "host_native_s": round(t_host, 3),
            "device_f32_warm_s": round(t_dev, 4),
            "device_f32_cold_s": round(t_cold, 2),
            "device_speedup_warm": round(t_host / t_dev, 1),
            "f32_relerr_rates_ge_1e4": round(float(rel[m_id].max()), 8)
            if m_id.any()
            else None,
            "f32_relerr_rates_ge_1e6": round(float(rel[m_weak].max()), 6)
            if m_weak.any()
            else None,
        }
        relerr = float(rel[m_weak].max()) if m_weak.any() else 0.0
        log(
            f"EM B={B}: host {t_host:.2f}s, device warm {t_dev:.3f}s "
            f"({t_host / t_dev:.0f}x), cold {t_cold:.1f}s, "
            f"f32 relerr {relerr:.1e}"
        )

    if oracle is not None:
        # reference at B=128: second run reuses <out>.colate_mat so the
        # measured wall-clock is its sequential EM (+ small I/O)
        out = os.path.join(BENCH_DIR, "ref_em_bench")
        for f in (out + ".coal", out + ".colate_mat"):
            if os.path.exists(f):
                os.remove(f)
        cmd = [
            oracle, "--mode", "mut",
            "--mut", fix["mut_prefix"],
            "--target_tmp", fix["target"],
            "--reference_tmp", fix["reference"],
            "--chr", fix["chrfile"],
            "--bins", "3,7,0.2",
            "--seed", "1",
            "--num_bootstraps", "128",
            "-o", out,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=3600)
            t0 = time.time()
            subprocess.run(cmd, check=True, capture_output=True, timeout=3600)
            ref_em = time.time() - t0
            details["em_B128"]["reference_s"] = round(ref_em, 1)
            dev = details["em_B128"]["device_f32_warm_s"]
            details["em_B128"]["device_vs_reference"] = round(ref_em / dev, 1)
            log(
                f"EM B=128 reference (cached-matrix run): {ref_em:.1f}s "
                f"-> device {ref_em / dev:.0f}x"
            )
        except Exception as e:
            log(f"reference B=128 EM bench unavailable: {e}")


def bench_binning(details: dict) -> None:
    """10M-site analytic binning: host-native vs the device slab kernel."""
    import numpy as np

    from colate_tpu.pipeline.binning import (
        bin_sites_analytic,
        bin_sites_analytic_native,
    )
    from colate_tpu.pipeline.join import JoinedSites

    N = 10_000_000
    NB = 125  # a real whole genome: ~103 full 30 Mb blocks + 22 partials
    g = np.random.default_rng(0)
    ab = np.exp(g.uniform(np.log(1e-1), np.log(1e4), N))
    ae = ab * np.exp(g.uniform(0.05, 2.0, N))
    emp = g.uniform(size=N) < 0.1
    ab[emp] = 0.0
    sites = JoinedSites(
        age_begin=ab, age_end=ae,
        w_shared=g.uniform(0, 2, N), w_notshared=g.uniform(0, 2, N),
        block_id=np.sort(g.integers(0, NB, N)).astype(np.int32),
        num_blocks=NB,
    )
    t_host = None
    for _ in range(3):
        t0 = time.time()
        h_host = bin_sites_analytic_native(sites)
        dt = time.time() - t0
        t_host = dt if t_host is None else min(t_host, dt)
    t0 = time.time()
    h_dev = bin_sites_analytic(sites)
    t_cold = time.time() - t0
    t_dev = None
    for _ in range(3):
        t0 = time.time()
        h_dev = bin_sites_analytic(sites)
        dt = time.time() - t0
        t_dev = dt if t_dev is None else min(t_dev, dt)
    relerr = max(
        float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        for a, b in zip(h_dev, h_host)
    )
    entry = {
        "host_native_s": round(t_host, 2),
        "host_sites_per_sec": round(N / t_host, -3),
        "device_warm_s": round(t_dev, 2),
        "device_sites_per_sec": round(N / t_dev, -3),
        "device_cold_s": round(t_cold, 2),
        "f32_max_relerr": round(relerr, 8),
        "winner": "host" if t_host < t_dev else "device",
    }
    details["binning_10M"] = entry
    log(
        f"binning 10M sites: host {t_host:.2f}s ({N / t_host / 1e6:.1f}M/s), "
        f"device warm {t_dev:.2f}s ({N / t_dev / 1e6:.1f}M/s), relerr {relerr:.1e}"
    )


def ensure_wg_fixture():
    """22-chromosome whole-genome-scale tmptmp fixture (~19M accepted
    sites), cached across bench runs."""
    from helpers.synth import make_fixture

    marker = os.path.join(WG_DIR, "ready.json")
    chroms = [str(i + 1) for i in range(WG_CHROMS)]
    fix = dict(
        root=WG_DIR,
        chroms=chroms,
        mut_prefix=os.path.join(WG_DIR, "synth"),
        target=os.path.join(WG_DIR, "target.colate.in"),
        reference=os.path.join(WG_DIR, "ref.colate.in"),
        chrfile=os.path.join(WG_DIR, "chr.txt"),
    )
    if os.path.exists(marker):
        with open(marker) as fh:
            meta = json.load(fh)
        if meta.get("n") == WG_PER_CHROM and meta.get("chroms") == chroms:
            log("whole-genome fixture cached")
            return fix
    log(f"generating whole-genome fixture ({WG_CHROMS}x{WG_PER_CHROM} rows)...")
    t0 = time.time()
    make_fixture(
        WG_DIR, chroms=tuple(chroms), n_per_chrom=WG_PER_CHROM, seed=SEED
    )
    with open(marker, "w") as fh:
        json.dump({"n": WG_PER_CHROM, "chroms": chroms}, fh)
    log(f"whole-genome fixture generated in {time.time() - t0:.1f}s")
    return fix


def bench_whole_genome(fix, details: dict, oracle: str | None) -> None:
    """End-to-end mode mut at whole-genome scale, B=1024 bootstraps —
    the workload where the winning path executes ON THE CHIP.

    Each variant runs twice in its own fresh subprocess (tools/wg_run.py),
    so cold = first invocation carrying every compile, warm = repeat in
    the same process, and max-RSS is per-variant (not the bench process's
    lifetime max, which fixture generation would dominate):
    - device: the default f64 EM, forced onto the device;
    - host: EM forced to the native sequential provider;
    - reference binary, measured at B=128 and extrapolated linearly to
      1024 (its bootstrap EMs are strictly sequential, coal.cpp:3675).
    """
    import numpy as np

    def run(tag, em_dtype, host_max_b):
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "wg_run.py"),
             WG_DIR, tag, em_dtype, str(host_max_b), str(WG_BOOTSTRAPS)],
            capture_output=True, timeout=3600, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(f"wg_run {tag} failed: {r.stderr[-500:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        rates = np.load(os.path.join(WG_DIR, f"wg_{tag}_rates.npy"))
        return out, rates

    dev, r_dev = run("dev", "auto", 0)
    host, r_host = run("host", "auto", 10**9)
    np.testing.assert_allclose(  # device result must agree on real rates
        r_dev[r_host > 1e-4], r_host[r_host > 1e-4], rtol=1e-3,
    )
    t_dev, t_host = dev["warm_s"], host["warm_s"]
    entry = {
        "chroms": WG_CHROMS,
        "num_sites": dev["num_sites"],
        "num_bootstraps": WG_BOOTSTRAPS,
        "device_total_s": t_dev,
        "device_total_cold_s": dev["cold_s"],
        "device_sites_per_sec": round(dev["num_sites"] / t_dev, -3),
        "device_stages": dev["timings"],
        "device_em_provider": dev.get("em_provider"),
        "device_max_rss_mb": dev["max_rss_mb"],
        "host_total_s": t_host,
        "host_stages": host["timings"],
        "host_max_rss_mb": host["max_rss_mb"],
        "winner": "device" if t_dev < t_host else "host",
        "device_vs_host_rate_relerr_identified": float(
            np.max(
                np.abs(r_dev - r_host)[r_host > 1e-4]
                / r_host[r_host > 1e-4]
            )
        ),
    }
    log(
        f"whole genome B={WG_BOOTSTRAPS}: device {t_dev:.1f}s (cold "
        f"{dev['cold_s']:.1f}s, em={dev.get('em_provider')}), host "
        f"{t_host:.1f}s, sites={dev['num_sites']}, "
        f"rss dev {dev['max_rss_mb']:.0f}MB host {host['max_rss_mb']:.0f}MB"
    )

    if oracle is not None:
        # MEASURED reference wall-clock at the same B=1024 — no linear
        # extrapolation (measured 2026-08-20: 381s wall / 364s CPU,
        # vs 1309s under the old linear model; the parse stage is
        # B-independent so linear-in-total overestimates).  Cached per
        # fixture so repeat bench runs skip the ~6.5 min run.
        cache = os.path.join(WG_DIR, "ref_b1024.json")
        meas = None
        if os.path.exists(cache):
            with open(cache) as fh:
                c = json.load(fh)
            if c.get("n") == WG_PER_CHROM and c.get("B") == WG_BOOTSTRAPS:
                meas = c["wall_s"]
        if meas is None:
            out = os.path.join(WG_DIR, "wg_ref")
            for f in (out + ".coal", out + ".colate_mat"):
                if os.path.exists(f):
                    os.remove(f)
            cmd = [
                oracle, "--mode", "mut",
                "--mut", fix["mut_prefix"],
                "--target_tmp", fix["target"],
                "--reference_tmp", fix["reference"],
                "--chr", fix["chrfile"],
                "--bins", "3,7,0.2",
                "--seed", "1",
                "--num_bootstraps", str(WG_BOOTSTRAPS),
                "-o", out,
            ]
            try:
                t0 = time.time()
                subprocess.run(
                    cmd, check=True, capture_output=True, timeout=3600
                )
                meas = time.time() - t0
                with open(cache, "w") as fh:
                    json.dump(
                        {"n": WG_PER_CHROM, "B": WG_BOOTSTRAPS,
                         "wall_s": meas}, fh,
                    )
            except Exception as e:
                log(f"whole-genome reference run unavailable: {e}")
        if meas is not None:
            entry["reference_B1024_s"] = round(meas, 1)
            entry["device_vs_reference"] = round(meas / t_dev, 1)
            log(
                f"whole genome reference B=1024 (measured): {meas:.1f}s "
                f"-> device {meas / t_dev:.0f}x"
            )
    details["whole_genome_B1024"] = entry


def _run_section(section: str, timeout: int) -> dict | None:
    """Run one device-bench section in a fresh subprocess (with one
    retry): a wedged device session or compile request then costs a
    bounded timeout instead of the whole bench run."""
    for attempt in (1, 2):
        try:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--section", section],
                capture_output=True, timeout=timeout, text=True,
            )
            sys.stderr.write(r.stderr[-2000:])
            if r.returncode == 0 and r.stdout.strip():
                return json.loads(r.stdout.strip().splitlines()[-1])
            log(f"section {section} attempt {attempt} rc={r.returncode}")
        except subprocess.TimeoutExpired:
            log(f"section {section} attempt {attempt} timed out ({timeout}s)")
        except Exception as e:
            log(f"section {section} attempt {attempt} failed: {e}")
    return None


def _section_main(section: str) -> None:
    fix = ensure_fixture()
    oracle = "/tmp/refbin/Colate" if os.path.exists("/tmp/refbin/Colate") else None
    details: dict = {}
    if section == "north":
        our_dt, num_sites, timings = time_ours(fix)
        details["north_star"] = {
            "ours_s": round(our_dt, 3),
            "ours_sites_per_sec": round(num_sites / our_dt, 1),
            "num_sites": num_sites,
            "stages": {k: round(v, 3) for k, v in timings.items()},
        }
    elif section == "em":
        bench_em_batched(fix, details, oracle)
    elif section == "binning":
        bench_binning(details)
    elif section == "wg":
        wg_fix = ensure_wg_fixture()
        bench_whole_genome(wg_fix, details, oracle)
    else:
        raise SystemExit(f"unknown section {section}")
    print(json.dumps(details))


def _run_tool(key: str, args: list[str], timeout: int, details: dict) -> None:
    try:
        r = subprocess.run(
            [sys.executable, *args], capture_output=True, timeout=timeout,
            text=True,
        )
        if r.returncode == 0 and r.stdout.strip():
            details[key] = json.loads(r.stdout.strip().splitlines()[-1])
            log(f"{key}: {details[key]}")
        else:
            log(f"{key} bench failed: {r.stderr[-300:]}")
    except Exception as e:
        log(f"{key} bench failed: {e}")


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--section":
        _section_main(sys.argv[2])
        return
    fix = ensure_fixture()
    oracle = ensure_oracle()
    ref_dt = None
    if oracle is not None:
        log("timing reference binary...")
        ref_dt, _ = time_reference(fix, oracle)
        log(f"reference: {ref_dt:.1f}s")

    details: dict = {}
    for section, timeout in (
        ("north", 1200), ("em", 2400), ("wg", 3600), ("binning", 1200)
    ):
        got = _run_section(section, timeout)
        if got is not None:
            details.update(got)
        else:
            log(f"section {section} produced no result")
    # Two BAM sizes: 2M reads / 264 MB and 11M reads / 1.45 GB; fixtures
    # are cached in the bench directory so the large run only pays
    # generation once.
    for key, n_reads, to in (("bam_stream", 2_000_000, 1200),
                             ("bam_stream_11m", 11_000_000, 2400)):
        _run_tool(
            key, [os.path.join(REPO, "tools", "bench_bam_stream.py"),
                  str(n_reads)], to, details,
        )
    _run_tool(
        "tree_mode", [os.path.join(REPO, "tools", "bench_tree.py"), "60000"],
        2400, details,
    )
    _run_tool(
        "aux_modes", [os.path.join(REPO, "tools", "bench_aux.py"), "50000"],
        2400, details,
    )
    os.makedirs(BENCH_DIR, exist_ok=True)
    with open(os.path.join(BENCH_DIR, "BENCH_DETAILS.json"), "w") as fh:
        json.dump(details, fh, indent=1)

    north = details.get("north_star")
    value = north["ours_sites_per_sec"] if north else 0.0
    vs = 0.0
    if north and ref_dt is not None:
        north["reference_s"] = round(ref_dt, 2)
        vs = value * ref_dt / north["num_sites"]
    print(
        json.dumps(
            {
                "metric": "mut_sites_per_sec",
                "value": value,
                "unit": "sites/s",
                "vs_baseline": round(vs, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
