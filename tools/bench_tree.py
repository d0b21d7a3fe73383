"""CoalRate tree-mode bench: 60k trees x 200 haplotypes vs the reference.

The scale is Relate-realistic (hundreds of haplotypes, ~10 KB .anc
lines): the reference re-parses each line with sscanf per node record
(Tree::ReadTree, anc.cpp:19-21), and glibc sscanf strlen-scans the
remaining line on every call, so its parse goes quadratic in line
length exactly where real data lives.

The reference walks each marginal tree sequentially (sscanf line parse +
per-tree age sort/epoch sweep, coal.cpp:164-186, coal_tree.cpp:100-174).
Ours parses .anc with the threaded native tokenizer and runs the
populate sweep as the batched device kernel (ops/tree_kernel.py).

Prints one JSON line with both timings and the rate parity.
Usage: python tools/bench_tree.py [num_trees] (default 60000)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

BENCH_DIR = "/tmp/colate_bench_tree"
REF_COALRATE = "/tmp/refbin/CoalRate"
N_HAP = 200
BINS = "2,6,0.25"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def ensure_fixture(num_trees: int) -> dict:
    import numpy as np

    from helpers.synth_anc import random_trees

    os.makedirs(BENCH_DIR, exist_ok=True)
    prefix = os.path.join(BENCH_DIR, "trees")
    chrfile = os.path.join(BENCH_DIR, "chr.txt")
    marker = os.path.join(BENCH_DIR, "ready.json")
    if os.path.exists(marker):
        with open(marker) as fh:
            meta = json.load(fh)
        if meta.get("T") == num_trees and meta.get("N") == N_HAP:
            log("tree bench fixture cached")
            return dict(prefix=prefix, chrfile=chrfile)
    log(f"generating {num_trees}-tree fixture (N={N_HAP})...")
    t0 = time.time()
    g = np.random.default_rng(4242)
    T, N = num_trees, N_HAP
    M = 2 * N - 1
    parent, ages = random_trees(g, T, N)
    blen = np.where(
        parent >= 0, np.take_along_axis(ages, np.maximum(parent, 0), 1) - ages, 0.0
    )
    # .mut rows: snps_per_tree per tree, increasing positions
    spt = 2
    n = T * spt
    tree_of_row = np.repeat(np.arange(T), spt)
    gaps = g.integers(50, 3000, n)
    pos = 100 + np.cumsum(gaps)
    dist = np.diff(np.append(pos, pos[-1] + 1000))
    start = np.arange(T, dtype=np.int64) * spt

    bs = np.char.mod("%.5f", blen)  # C-level float formatting
    with open(f"{prefix}_chr1.anc", "w") as fh:
        fh.write(f"NUM_HAPLOTYPES {N}\n")
        fh.write(f"NUM_TREES {T}\n")
        for tt in range(T):
            recs = " ".join(
                f"{p}:({b} 1.000 0 0)" for p, b in zip(parent[tt], bs[tt])
            )
            fh.write(f"{start[tt]}: {recs} \n")
    hdr = (
        "snp;pos_of_snp;dist;rs-id;tree_index;branch_indices;is_not_mapping;"
        "is_flipped;age_begin;age_end;ancestral_allele/alternative_allele;"
        "upstream_allele;downstream_allele;"
    )
    branch = g.integers(0, M - 1, n)
    with open(f"{prefix}_chr1.mut", "w") as fh:
        fh.write(hdr + "\n")
        fh.writelines(
            f"{i};{pos[i]};{dist[i]};rs{i};{tree_of_row[i]};{branch[i]} ;0;0;"
            "0;100;A/C;;;\n"
            for i in range(n)
        )
    with open(chrfile, "w") as fh:
        fh.write("1\n")
    with open(marker, "w") as fh:
        json.dump({"T": num_trees, "N": N_HAP}, fh)
    log(f"fixture generated in {time.time() - t0:.1f}s")
    return dict(prefix=prefix, chrfile=chrfile)


def time_reference(fix) -> float | None:
    if not os.path.exists(REF_COALRATE):
        return None
    out = os.path.join(BENCH_DIR, "ref_out")
    cmd = [REF_COALRATE, "--mode", "tree", "-i", fix["prefix"],
           "--chr", fix["chrfile"], "--bins", BINS, "-o", out]
    best = None
    for _ in range(2):
        t0 = time.time()
        subprocess.run(cmd, check=True, capture_output=True, timeout=3600)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return best


def time_ours(fix) -> float:
    from colate_tpu.models.tree_coal import run_tree_mode

    class Args:
        input = fix["prefix"]
        bins = BINS
        chr_file = fix["chrfile"]
        years_per_gen = None
        num_bootstraps = 1
        coal = None
        output = os.path.join(BENCH_DIR, "our_out")

    run_tree_mode(Args())  # warm-up: XLA compile of the populate slabs
    best = None
    for i in range(3):
        t0 = time.time()
        run_tree_mode(Args())
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
        log(f"ours run {i}: {dt:.2f}s")
    return best


def main() -> None:
    import numpy as np

    num_trees = int(sys.argv[1]) if len(sys.argv) > 1 else 60_000
    fix = ensure_fixture(num_trees)
    ref_dt = time_reference(fix)
    if ref_dt is not None:
        log(f"reference CoalRate: {ref_dt:.1f}s")
    our_dt = time_ours(fix)

    result = {
        "metric": "tree_mode_trees_per_sec",
        "num_trees": num_trees,
        "n_hap": N_HAP,
        "ours_s": round(our_dt, 2),
        "trees_per_sec": round(num_trees / our_dt, -1),
        "reference_s": None if ref_dt is None else round(ref_dt, 2),
        "speedup": None if ref_dt is None else round(ref_dt / our_dt, 1),
    }
    if ref_dt is not None:
        from colate_tpu.formats.coal import CoalFile

        ref = CoalFile.read(os.path.join(BENCH_DIR, "ref_out.coal"))
        ours = CoalFile.read(os.path.join(BENCH_DIR, "our_out.coal"))
        m = np.isfinite(ref.rates)
        relerr = float(
            np.max(np.abs(ours.rates[m] - ref.rates[m]) / np.abs(ref.rates[m]))
        )
        result["max_relerr_vs_reference"] = round(relerr, 9)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
