"""Colate-compatible command-line interface.

Flag surface mirrors the reference executables (Colate.cpp:11-45,
CoalRate.cpp:10-27) so existing invocations work unchanged, plus engine
extensions (--sampling, --devices).  Modes are dispatched by --mode like
the reference (Colate.cpp:51-102).
"""

from __future__ import annotations

import argparse
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="colate-tpu",
        description="JAX coalescence-rate engine (Colate-compatible)",
    )
    p.add_argument("--mode", required=True,
                   help="mut, make_tmp, preprocess_mut, print_tmp, compare_tmp, "
                        "count_topo, calc_depth, get_deam, CondCoalRates, tree, "
                        "local_ancestry")
    p.add_argument("--anc", help="filename of file containing trees")
    p.add_argument("--mut", help="filename of file containing mut")
    p.add_argument("--target_bcf")
    p.add_argument("--reference_bcf")
    p.add_argument("--target_mask")
    p.add_argument("--reference_mask")
    p.add_argument("--target_table")
    p.add_argument("--target_bam")
    p.add_argument("--reference_bam")
    p.add_argument("--target_tmp")
    p.add_argument("--reference_tmp")
    p.add_argument("--target_age", type=float, default=0.0)
    p.add_argument("--reference_age", type=float, default=0.0)
    p.add_argument("--ref_genome")
    p.add_argument("--anc_genome")
    p.add_argument("--mask")
    p.add_argument("--mask_cutoff", type=float, default=0.9)
    p.add_argument("--chr", dest="chr_file")
    p.add_argument("--bins")
    p.add_argument("--lineage_bin")
    p.add_argument("--outgroup_tmrca", type=float)
    p.add_argument("--years_per_gen", type=float, default=28.0)
    p.add_argument("--coal")
    p.add_argument("--seed", type=int)
    p.add_argument("--num_bootstraps", type=int, default=1)
    p.add_argument("--filters", default="20,30,10",
                   help="MAPQ,LEN,MAX_MISMATCH for BAM parsing")
    p.add_argument("--strandfilter", action="store_true")
    p.add_argument("--groups")
    p.add_argument("--poplabels")
    p.add_argument("--map")
    p.add_argument("--dist",
                   help="mode tree: per-chromosome <dist>_chr<name>.dist "
                        "files providing (pos, dist) spans instead of the "
                        ".mut dist column (relate_lib AncMutIterators "
                        "3-arg constructor, mutations.cpp:399-465)")
    p.add_argument("-i", "--input")
    p.add_argument("-o", "--output", required=True)
    # engine extensions
    p.add_argument("--sampling", choices=["analytic", "mc_parity"],
                   default="analytic",
                   help="age-histogram mode: analytic expectation (default) "
                        "or bit-exact replay of the reference's MC draws")
    p.add_argument("--em_dtype", choices=["auto", "float64", "float32"],
                   default="auto",
                   help="EM working precision (auto: f64; float32 runs "
                        "the E-step in f32 under the tiered contract of "
                        "tests/test_em_f32.py)")
    p.add_argument("--checkpoint", action="store_true",
                   help="cache per-block histograms to <output>.suffstats.npz "
                        "keyed by an input fingerprint; reruns skip "
                        "parse+binning (analytic mode)")
    p.add_argument("--per_chr_bam", action="store_true",
                   help="mode mut with --target_bam+--reference_bcf: read "
                        "one BAM per chromosome (<target_bam>_chr<name>.bam) "
                        "instead of one multi-contig BAM (the reference's "
                        "parse_bamvcf layout, coal.cpp:1229-1510)")
    p.add_argument("--devices", type=int,
                   help="mode mut: shard bootstrap-EM over the first N "
                        "devices of the default backend (parallel/mesh.py; "
                        "an error if it has fewer); default = "
                        "single-device")
    p.add_argument("--binning",
                   choices=["auto", "native", "device", "sharded"],
                   default="auto",
                   help="mode mut analytic-binning backend: auto (native "
                        "C++ f64 host binner, device fallback), native "
                        "(require it), device (f32 XLA slab), sharded "
                        "(mesh path — bitwise invariant to block-aligned "
                        "mesh size)")
    p.add_argument("--coordinator",
                   help="multi-process mode mut: jax.distributed "
                        "coordinator address host:port (launch one process "
                        "per host with --num_processes/--process_id; "
                        "chromosomes are sharded across processes and the "
                        "sufficient statistics merged over DCN)")
    p.add_argument("--num_processes", type=int,
                   help="total process count for --coordinator runs "
                        "(defaults to the JAX env vars / cloud autodetect)")
    p.add_argument("--process_id", type=int,
                   help="this process's rank for --coordinator runs")
    return p


def _read_chr_list(path: str | None) -> list[str] | None:
    if not path:
        return None
    with open(path) as fh:
        return [ln.strip() for ln in fh if ln.strip()]


def _print_rusage() -> None:
    """End-of-run resource report, same shape as the reference's
    getrusage print (coal.cpp:3852-3861)."""
    try:
        import resource

        u = resource.getrusage(resource.RUSAGE_SELF)
        cpu = u.ru_utime + u.ru_stime
        print(
            f"CPU Time spent: {cpu:.6f}s; Max Memory usage: "
            f"{u.ru_maxrss / 1000.0}Mb.",
            file=sys.stderr,
        )
        print("-" * 57 + "\n", file=sys.stderr)
    except Exception:
        pass


def main(argv: list[str] | None = None) -> int:
    """CLI entry point; prints the rusage report on the way out (once
    per call — no atexit, so repeated library/test invocations don't
    stack handlers).  Input/usage errors print like the reference's
    error blocks (Colate.cpp:51-105) instead of tracebacks."""
    try:
        return _dispatch(argv)
    except (ValueError, FileNotFoundError) as exc:
        # COLATE_TPU_DEBUG=1 keeps the full traceback so internal
        # invariant failures aren't mistaken for bad-input errors
        import os
        import traceback

        if os.environ.get("COLATE_TPU_DEBUG"):
            traceback.print_exc()
        print(
            f"####### error #######\n{type(exc).__name__}: {exc}",
            file=sys.stderr,
        )
        return 1
    finally:
        _print_rusage()


def _dispatch(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    mode = args.mode

    if mode == "mut":
        from colate_tpu.config import MutRunConfig
        from colate_tpu.models.mut_em import run_mut_and_write

        cfg = MutRunConfig(
            mut=args.mut,
            output=args.output,
            chr_list=_read_chr_list(args.chr_file),
            target_tmp=args.target_tmp,
            reference_tmp=args.reference_tmp,
            target_bcf=args.target_bcf,
            reference_bcf=args.reference_bcf,
            target_bam=args.target_bam,
            reference_bam=args.reference_bam,
            ref_genome=args.ref_genome,
            target_mask=args.target_mask,
            reference_mask=args.reference_mask,
            coal=args.coal,
            bins=args.bins,
            target_age=args.target_age,
            reference_age=args.reference_age,
            years_per_gen=args.years_per_gen,
            num_bootstrap=args.num_bootstraps,
            seed=args.seed,
            filters=args.filters,
            sampling=args.sampling,
            em_dtype=args.em_dtype,
            checkpoint=args.checkpoint,
            per_chr_bam=args.per_chr_bam,
            devices=args.devices,
            binning=args.binning,
        )
        if (
            args.coordinator is not None
            or args.num_processes is not None
            or args.process_id is not None
        ):
            # pod/multi-host launch: every process runs this same command;
            # rank 0 writes <output>.coal (parallel/multihost.py)
            from colate_tpu.parallel.multihost import (
                init_distributed,
                run_mut_multihost,
            )

            init_distributed(
                args.coordinator, args.num_processes, args.process_id
            )
            run_mut_multihost(cfg)
            return 0
        run_mut_and_write(cfg)
        return 0

    if mode == "make_tmp":
        from colate_tpu.models.make_tmp import run_make_tmp

        return run_make_tmp(args)

    if mode == "print_tmp":
        from colate_tpu.models.print_tmp import run_print_tmp

        return run_print_tmp(args)

    if mode == "preprocess_mut":
        from colate_tpu.models.preprocess_mut import run_preprocess_mut

        return run_preprocess_mut(args)

    if mode == "compare_tmp":
        from colate_tpu.models.compare_tmp import run_compare_tmp

        return run_compare_tmp(args)

    if mode == "count_topo":
        from colate_tpu.models.compare_tmp import run_count_topo

        return run_count_topo(args)

    if mode in ("tree", "coal"):
        from colate_tpu.models.tree_coal import run_tree_mode

        return run_tree_mode(args)

    if mode == "local_ancestry":
        from colate_tpu.models.local_ancestry import run_local_ancestry

        return run_local_ancestry(args)

    if mode == "CondCoalRates":
        from colate_tpu.models.cond_coal import run_cond_coal

        return run_cond_coal(args)

    if mode == "calc_depth":
        from colate_tpu.models.bam_stats import run_calc_depth

        return run_calc_depth(args)

    if mode == "get_deam":
        from colate_tpu.models.bam_stats import run_get_deam

        return run_get_deam(args)

    print(f"####### error #######\nInvalid or missing mode: {mode}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
