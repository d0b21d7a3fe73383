"""Mode ``mut`` — the primary coalescence-rate estimator.

End-to-end pipeline (reference call stack: coal/coal.cpp:3072-3863):

1. host: columnar join of ``.mut`` tables against target/reference site
   streams (pipeline/join.py);
2. device: expected age-bin histograms per 30 Mb block (pipeline/binning.py);
3. host/device: bootstrap block weights → weighted count matrices
   (ops/bootstrap.py) + empirical-F redistribution;
4. device: vectorised EM over all bootstrap replicates (ops/em.py);
5. host: ``.coal`` writer (formats/coal.py).

The ``.colate_mat`` cache is honoured exactly like the reference
(written for non-tmp inputs, divided by norm=1e3; loaded when present).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

from colate_tpu.config import (
    COLATE_MAT_NORM,
    MutRunConfig,
    NUM_AGE_BINS,
    age_bin_centers,
)
from colate_tpu.formats.coal import write_mut_coal
from colate_tpu.formats.colate_in import read_colate_in
from colate_tpu.formats.colate_mat import read_colate_mat, write_colate_mat
from colate_tpu.formats.fasta import read_mask
from colate_tpu.formats.mut import MutTable
from colate_tpu.hostrng import MT19937
from colate_tpu.ops.bootstrap import bootstrap_weights, redistribute_emp, weighted_counts
from colate_tpu.ops.epochs import epochs_from_bins, epochs_from_coal_file
from colate_tpu.pipeline.binning import (
    bin_sites_analytic,
    bin_sites_analytic_native,
    bin_sites_mc_parity,
)
from colate_tpu.pipeline.join import join_tmptmp


@dataclasses.dataclass
class MutResult:
    epochs: np.ndarray
    rates: np.ndarray  # [B, E]
    logl: np.ndarray
    iterations: np.ndarray
    num_sites: int
    num_blocks: int
    is_ancient: bool
    ep_null: int
    timings: dict
    em_provider: str = ""  # which EM backend ran (native/jax:*/mesh[N]:*)


def resolve_tmp_inputs(cfg: MutRunConfig):
    """Per-chromosome filename resolution (coal.cpp:3289-3312)."""
    if cfg.chr_list:
        chroms = list(cfg.chr_list)
        mut_files = [f"{cfg.mut}_chr{c}.mut" for c in chroms]
        tmask = (
            [f"{cfg.target_mask}_chr{c}.fa" for c in chroms] if cfg.target_mask else None
        )
        rmask = (
            [f"{cfg.reference_mask}_chr{c}.fa" for c in chroms]
            if cfg.reference_mask
            else None
        )
    else:
        chroms = [""]
        mut_files = [cfg.mut]
        tmask = [f"{cfg.target_mask}"] if cfg.target_mask else None
        rmask = [f"{cfg.reference_mask}"] if cfg.reference_mask else None
    return chroms, mut_files, tmask, rmask


def compute_suffstats(
    cfg: MutRunConfig,
    chroms,
    mut_files,
    tmask_files,
    rmask_files,
    age: float,
    ref_age: float,
    parity: bool,
    rng,
    seed: int,
    timings: dict,
):
    """Parse + bin stage of mode mut: dispatch one of the six reference
    parsers over the given chromosome subset and return the per-block
    sufficient statistics ``(sh_b, ns_b, se_b, ne_b, num_sites,
    num_blocks)``.  Block indices are local to the subset (each
    chromosome starts a fresh 30 Mb block, coal.cpp:2113-2120), which is
    what lets the multi-host driver (parallel/multihost.py) concatenate
    per-process block ranges disjointly."""
    nbins = NUM_AGE_BINS
    t0 = time.time()
    num_blocks = 0
    num_sites = 0
    sh_b = ns_b = se_b = ne_b = None
    def per_chr(prefix, ext):
        if prefix is None:
            return None
        if cfg.chr_list:
            return [f"{prefix}_chr{c}{ext}" for c in chroms]
        return [prefix]

    mc_hists = None  # fused split-mode parity histograms
    fused = None  # fused native tmp-mode histograms
    # dispatch order mirrors the reference (coal.cpp:3175-3317)
    if cfg.target_bcf and cfg.reference_bcf:
        from colate_tpu.pipeline.join_vcf import join_vcfvcf

        sites = join_vcfvcf(
            chroms,
            mut_files,
            per_chr(cfg.target_bcf, ".bcf"),
            per_chr(cfg.reference_bcf, ".bcf"),
            tmask_files,
            rmask_files,
            per_chr(cfg.ref_genome, ".fa"),
            age,
            ref_age,
        )
    elif cfg.target_bcf:
        from colate_tpu.pipeline.join_vcf import join_vcf_split

        split_rng = rng if parity else MT19937(seed)
        if parity:
            from colate_tpu.pipeline.binning import GrowableBlockHists

            # grows with the genome: no fixed block cap
            mc_hists = GrowableBlockHists(nbins)
        sites = join_vcf_split(
            chroms,
            mut_files,
            per_chr(cfg.target_bcf, ".bcf"),
            tmask_files,
            per_chr(cfg.ref_genome, ".fa"),
            split_rng,
            age,
            ref_age,
            mc_hists=mc_hists,
        )
    elif cfg.target_bam and cfg.reference_bcf:
        if not cfg.ref_genome:
            raise ValueError("mut with --target_bam requires --ref_genome")
        if cfg.per_chr_bam:
            # the reference's parse_bamvcf layout (one BAM per chr,
            # coal.cpp:1229-1510) — dead code behind its CLI
            # (coal.cpp:3273), reachable here via --per_chr_bam
            from colate_tpu.pipeline.join_bam import join_bamvcf

            sites = join_bamvcf(
                chroms,
                mut_files,
                per_chr(cfg.target_bam, ".bam"),
                per_chr(cfg.reference_bcf, ".bcf"),
                tmask_files,
                rmask_files,
                per_chr(cfg.ref_genome, ".fa"),
                params=cfg.filters,
                age=age,
                ref_age=ref_age,
            )
        else:
            from colate_tpu.pipeline.join_bam import join_onebamvcf

            sites = join_onebamvcf(
                chroms,
                mut_files,
                cfg.target_bam + ".bam",  # coal.cpp:3228
                per_chr(cfg.reference_bcf, ".bcf"),
                tmask_files,
                rmask_files,
                per_chr(cfg.ref_genome, ".fa"),
                params=cfg.filters,
                age=age,
                ref_age=ref_age,
            )
    elif cfg.target_bam and cfg.reference_bam:
        from colate_tpu.pipeline.join_bam import join_onebambam

        if not cfg.ref_genome:
            raise ValueError("mut with --target_bam requires --ref_genome")
        sites = join_onebambam(
            chroms,
            mut_files,
            cfg.target_bam,  # used as-is (coal.cpp:3262)
            cfg.reference_bam,
            tmask_files,
            rmask_files,
            per_chr(cfg.ref_genome, ".fa"),
            params=cfg.filters,
            age=age,
            ref_age=ref_age,
        )
    elif cfg.target_tmp and cfg.reference_tmp:
        from colate_tpu.pipeline.join import (
            fused_tmptmp_stream,
            mut_prefilter_native,
        )

        dedup = len(set(chroms)) == len(chroms)
        sites = None
        tmasks = [read_mask(f) for f in tmask_files] if tmask_files else None
        rmasks = [read_mask(f) for f in rmask_files] if rmask_files else None
        pf = (
            mut_prefilter_native(mut_files, tmasks, rmasks, age)
            if (not parity and dedup and cfg.binning == "auto")
            else None
        )
        if pf is not None:
            # streaming fused pipeline: the .mut prefilter (threaded,
            # native) feeds a chromosome-run streaming join+bin over the
            # two .colate.in FILES — peak memory is one chromosome's
            # columns, not the whole genome (bounded-RSS path for the
            # 7 GB whole-genome workload; the reference streams too,
            # coal.cpp:2125-2145)
            fused = fused_tmptmp_stream(
                pf, chroms, cfg.target_tmp, cfg.reference_tmp, age, ref_age
            )
        if fused is not None:
            (sh_b, ns_b, se_b, ne_b), num_sites, num_blocks = fused
            timings["parse"] = time.time() - t0
            timings["binning"] = 0.0
        else:
            # Python fallback (no native library / parity replay /
            # duplicate chromosome names): staged whole-file decode
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=4) as ex:
                fut_t = ex.submit(read_colate_in, cfg.target_tmp)
                fut_r = ex.submit(read_colate_in, cfg.reference_tmp)
                target = fut_t.result()
                reference = fut_r.result()
            mut_tables = [MutTable.read(f) for f in mut_files]
            sites = join_tmptmp(
                chroms, mut_tables, target, reference, tmasks, rmasks,
                age, ref_age,
            )
    else:
        raise ValueError(
            "mode mut needs target_bcf [+reference_bcf], "
            "target_bam+reference_bcf, target_bam+reference_bam, or "
            "target_tmp+reference_tmp"
        )
    if sites is not None:
        num_sites = len(sites)
        num_blocks = sites.num_blocks
        timings["parse"] = time.time() - t0

        t0 = time.time()
        # every parser forces age=0 (e.g. coal.cpp:597-598, 2073-2074)
        if mc_hists is not None:  # split-mode parity: already binned
            sh_b, ns_b, se_b, ne_b = (h[:num_blocks] for h in mc_hists)
        elif parity:
            sh_b, ns_b, se_b, ne_b = bin_sites_mc_parity(
                sites, rng, age=0.0
            )
        else:
            hists = None
            if cfg.binning == "sharded":
                # the mesh path on max(devices,1) devices — per-block
                # results are bitwise invariant to the (block-aligned)
                # mesh size, so a 1-device run here is the byte oracle
                # for any multi-device run of the same inputs
                from colate_tpu.parallel.mesh import make_mesh, sharded_bin_sites

                mesh = make_mesh(cfg.devices if cfg.devices else 1)
                hists = sharded_bin_sites(
                    mesh, sites.age_begin, sites.age_end, sites.w_shared,
                    sites.w_notshared, sites.block_id, sites.num_blocks,
                    age=0.0,
                )
            elif cfg.binning in ("auto", "native"):
                hists = bin_sites_analytic_native(sites, age=0.0)
                if hists is None and cfg.binning == "native":
                    raise RuntimeError(
                        "binning='native' requested but the native library "
                        "is unavailable"
                    )
            if hists is None:
                hists = bin_sites_analytic(sites, age=0.0)
            sh_b, ns_b, se_b, ne_b = hists
        timings["binning"] = time.time() - t0
    return sh_b, ns_b, se_b, ne_b, num_sites, num_blocks


def resolve_em_dtype(em_dtype: str) -> str:
    """EM working precision for a requested ``--em_dtype``: "auto" is
    float64 on every backend; float32 only when asked for."""
    if em_dtype not in ("auto", "float64", "float32"):
        raise ValueError(f"unknown em_dtype {em_dtype!r}")
    return "float32" if em_dtype == "float32" else "float64"


def run_mut(cfg: MutRunConfig) -> MutResult:
    import jax.numpy as jnp

    from colate_tpu import enable_compilation_cache, enable_x64
    from colate_tpu.ops.em import run_em

    enable_x64()
    enable_compilation_cache()
    timings: dict = {}
    age_bins = age_bin_centers()

    target_age = float(np.float32(cfg.target_age))
    ref_age_y = float(np.float32(cfg.reference_age))
    ypg = float(np.float32(cfg.years_per_gen))
    age = max(target_age, ref_age_y) / ypg
    ref_age = ref_age_y / ypg
    is_ancient = age > 0.0

    B = cfg.num_bootstrap
    seed = cfg.seed if cfg.seed is not None else (int(time.time()) + os.getpid())
    parity = cfg.sampling == "mc_parity"
    rng = MT19937(seed) if parity else None

    mat_path = cfg.output + ".colate_mat"
    num_blocks = 0
    num_sites = 0
    if os.path.exists(mat_path):
        _, shared_counts, notshared_counts = read_colate_mat(mat_path, B)
        timings["parse"] = 0.0
        return finish_from_suffstats(
            cfg, None, None, None, None, 0, 0, timings, rng=rng, seed=seed,
            counts=(shared_counts, notshared_counts),
        )
    else:
        t0 = time.time()
        chroms, mut_files, tmask_files, rmask_files = resolve_tmp_inputs(cfg)

        ckpt = None
        ckpt_fp = None
        ckpt_path = cfg.output + ".suffstats.npz"
        if cfg.checkpoint and not parity:
            # engine-level resume (generalised .colate_mat cache): skip
            # parse+binning when the inputs are unchanged
            from colate_tpu.utils.checkpoint import input_fingerprint, load_suffstats

            ckpt_fp = input_fingerprint(
                list(mut_files)
                + list(tmask_files or [])
                + list(rmask_files or [])
                + [cfg.target_tmp, cfg.reference_tmp, cfg.target_bcf,
                   cfg.reference_bcf, cfg.target_bam, cfg.reference_bam,
                   cfg.ref_genome],
                extra=dict(age=age, ref_age=ref_age),
            )
            ckpt = load_suffstats(ckpt_path, ckpt_fp)
        if ckpt is not None:
            sh_b, ns_b, se_b, ne_b, num_sites = ckpt
            num_blocks = sh_b.shape[0]
            timings["parse"] = time.time() - t0
            timings["binning"] = 0.0
        else:
            sh_b, ns_b, se_b, ne_b, num_sites, num_blocks = compute_suffstats(
                cfg, chroms, mut_files, tmask_files, rmask_files,
                age, ref_age, parity, rng, seed, timings,
            )
            if ckpt_fp is not None:
                from colate_tpu.utils.checkpoint import save_suffstats

                save_suffstats(
                    ckpt_path, ckpt_fp, sh_b, ns_b, se_b, ne_b, num_sites
                )

        return finish_from_suffstats(
            cfg, sh_b, ns_b, se_b, ne_b, num_sites, num_blocks, timings,
            rng=rng, seed=seed,
        )


def finish_from_suffstats(
    cfg: MutRunConfig,
    sh_b,
    ns_b,
    se_b,
    ne_b,
    num_sites: int,
    num_blocks: int,
    timings: dict,
    rng=None,
    seed: int | None = None,
    counts=None,
    write_outputs: bool = True,
) -> MutResult:
    """Bootstrap + EM stage of mode mut, from per-block sufficient
    statistics (or, with ``counts``, from pre-bootstrapped count
    matrices as loaded from a ``.colate_mat`` cache).  Deterministic
    given its inputs and the seed — the multi-host driver relies on
    this to keep ranks bit-identical after the DCN merge.  Multi-host
    callers pass ``write_outputs=False`` on non-zero ranks so the
    ``.colate_mat`` cache is written exactly once (no concurrent writes
    to a shared filesystem)."""
    import jax.numpy as jnp

    from colate_tpu.ops.em import run_em

    age_bins = age_bin_centers()
    target_age = float(np.float32(cfg.target_age))
    ref_age_y = float(np.float32(cfg.reference_age))
    ypg = float(np.float32(cfg.years_per_gen))
    age = max(target_age, ref_age_y) / ypg
    is_ancient = age > 0.0
    parity = cfg.sampling == "mc_parity"
    B = cfg.num_bootstrap
    if seed is None:
        seed = cfg.seed if cfg.seed is not None else (int(time.time()) + os.getpid())
    mat_path = cfg.output + ".colate_mat"

    if counts is not None:
        shared_counts, notshared_counts = counts
    else:
        t0 = time.time()
        weights = bootstrap_weights(B, num_blocks, rng=rng, seed=seed)
        shared_counts, notshared_counts, se, ne = weighted_counts(
            weights, sh_b, ns_b, se_b, ne_b
        )
        shared_counts = redistribute_emp(shared_counts, se, ne, age=age)
        tmp_inputs = cfg.target_tmp is not None and cfg.reference_tmp is not None
        if not tmp_inputs:
            shared_counts = shared_counts / COLATE_MAT_NORM
            notshared_counts = notshared_counts / COLATE_MAT_NORM
            if write_outputs:
                write_colate_mat(
                    mat_path, age_bins, shared_counts, notshared_counts
                )
        timings["bootstrap"] = time.time() - t0

    # ---- epochs + initial rates ----
    if cfg.coal:
        epochs, init_rates, ep_null = epochs_from_coal_file(cfg.coal, age)
    else:
        if not cfg.bins:
            raise ValueError("either --bins or --coal is required")
        epochs, ep_null = epochs_from_bins(cfg.bins, ypg, age)
        from colate_tpu.config import INITIAL_COAL_RATE

        init_rates = np.full(epochs.shape, INITIAL_COAL_RATE)

    # ---- EM ----
    from colate_tpu.utils.progress import log_event, profile_trace

    log_event(
        "mut_suffstats",
        sites=num_sites,
        blocks=num_blocks,
        bootstraps=B,
        sec_parse=round(timings.get("parse", 0.0), 4),
        sec_binning=round(timings.get("binning", 0.0), 4),
        sec_bootstrap=round(timings.get("bootstrap", 0.0), 4),
    )
    t0 = time.time()
    em_dtype = cfg.em_dtype
    from colate_tpu.config import EM_HOST_MAX_B

    if cfg.devices and cfg.devices >= 1 and not parity:
        # explicit mesh run (--devices N, N=1 included): bootstrap
        # replicates are independent EM fixed-points, sharded over the
        # first N devices of the default backend (parallel/mesh.py);
        # replicate-sequential, so every replicate runs the same program
        # whatever N is
        from colate_tpu.parallel.mesh import make_mesh, sharded_run_em

        em_dtype = resolve_em_dtype(em_dtype)
        mesh = make_mesh(cfg.devices)
        rates, logl, iters = sharded_run_em(
            mesh, epochs, init_rates, shared_counts, notshared_counts,
            dtype=em_dtype,
        )
        provider = f"mesh[{mesh.devices.size}]:jax:{em_dtype}"
    elif cfg.checkpoint and not parity:
        # engine-level resume THROUGH the estimator: the EM loop state
        # (it, rates, logl, conv, iters) checkpoints every few thousand
        # iterations, so a killed run resumes mid-EM and writes the
        # identical .coal (ops/em.py:run_em_checkpointed; generalises
        # the reference's post-parse cache seam, coal.cpp:3169-3171)
        import hashlib

        from colate_tpu.ops.em import run_em_checkpointed

        em_dtype = resolve_em_dtype(em_dtype)
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(epochs).tobytes())
        h.update(np.ascontiguousarray(shared_counts).tobytes())
        h.update(np.ascontiguousarray(notshared_counts).tobytes())
        h.update(f"{B}:{em_dtype}".encode())
        fp = h.hexdigest()
        rates, logl, iters = run_em_checkpointed(
            epochs, init_rates, shared_counts, notshared_counts,
            cfg.output + ".emstate.npz", fp, dtype=em_dtype,
        )
        provider = f"jax:{em_dtype}(checkpointed)"
    else:
        out = None
        if em_dtype == "auto" and B <= EM_HOST_MAX_B and not parity:
            # small batches: the host provider (ops/em.py:run_em_native,
            # f64) beats a device EM plus its compile in a one-shot
            # process (see config.EM_HOST_MAX_B).  Parity runs are
            # excluded: the native provider's ~1e-13 deviation from the
            # JAX f64 EM could in rare cases flip the 6th printed
            # significant digit at a rounding boundary, so byte-identity
            # runs always take the JAX f64 path.
            from colate_tpu.ops.em import run_em_native

            out = run_em_native(
                epochs, init_rates, shared_counts, notshared_counts
            )
        if out is not None:
            rates, logl, iters = out
            provider = "native"
        else:
            em_dtype = resolve_em_dtype(em_dtype)
            provider = f"jax:{em_dtype}"
            with profile_trace():  # COLATE_TPU_TRACE=<dir> captures the EM
                rates, logl, iters = run_em(
                    jnp.asarray(epochs),
                    jnp.asarray(init_rates),
                    jnp.asarray(shared_counts),
                    jnp.asarray(notshared_counts),
                    dtype=em_dtype,
                )
    rates = np.asarray(rates)
    logl = np.asarray(logl)
    iters = np.asarray(iters)
    timings["em"] = time.time() - t0
    log_event(
        "mut_em",
        provider=provider,
        iters=int(np.max(iters)),
        sec=round(timings["em"], 4),
    )

    return MutResult(
        epochs=epochs,
        rates=rates,
        logl=logl,
        iterations=iters,
        num_sites=num_sites,
        num_blocks=num_blocks,
        is_ancient=is_ancient,
        ep_null=ep_null,
        timings=timings,
        em_provider=provider,
    )


def run_mut_and_write(cfg: MutRunConfig) -> MutResult:
    res = run_mut(cfg)
    write_mut_coal(
        cfg.output + ".coal",
        res.epochs,
        res.rates,
        is_ancient=res.is_ancient,
        ep_null=res.ep_null,
    )
    from colate_tpu.utils.progress import log_event

    log_event(
        "mut_done",
        sites=res.num_sites,
        blocks=res.num_blocks,
        iters=res.iterations.tolist(),
        timings={k: round(v, 3) for k, v in res.timings.items()},
    )
    return res
