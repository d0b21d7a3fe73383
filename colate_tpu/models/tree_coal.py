"""CoalRate mode ``tree``: genome-wide coalescence rates from Relate trees.

Reference: ``coal()`` driver (coal/coal.cpp:21-204) + ``coal_tree``
(coal_tree.cpp:1-300).  Per marginal tree, the estimator needs the sorted
node ages, the lineage count per inter-event interval, and their overlap
with the epoch grid — the reference sweeps each tree sequentially; here
every tree is a row of dense [num_trees, 2N-1] arrays and the whole
chromosome reduces with one batched epoch-overlap contraction:

    num[block, e]   = Σ_trees span·#{coalescences in epoch e}/1e9
    denom[block, e] = Σ_trees span·Σ_j C(k_j,2)·|interval_j ∩ epoch e|/1e9

Span semantics (AncMutIterators::NextTree, mutations.cpp:616-692): a
tree with mut rows [i0..i1] persists for Σ dist[i0..i1] plus half the
preceding dist minus half of dist[i1] (when neighbours exist); trees
without mutations contribute 0.  The driver narrows the span to float32
(coal.cpp:146) — replicated.

Bootstrap quirks replicated from coal_tree.cpp:180-211: rng is ALWAYS
mt19937 seeded with 1 (the --seed flag is ignored), and the uniform_int
upper bound is num_blocks INCLUSIVE — draws equal to num_blocks fall
outside the count array and are silently dropped.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu.formats.anc import AncFile, node_ages
from colate_tpu.formats.mut import MutTable
from colate_tpu.hostrng import MT19937

BLOCK_SIZE_TREES = 5000  # coal.cpp:140
_INITIAL_BLOCKS = 256  # starting accumulator size; grows on demand


def tree_spans(anc: AncFile, mut: MutTable) -> np.ndarray:
    """[num_trees] float64 genome span per tree (NextTree semantics)."""
    T = anc.num_trees
    spans = np.zeros(T, np.float64)
    tree_of_row = mut.tree
    n = len(mut)
    if n == 0:
        return spans
    # rows are grouped by tree index (nondecreasing)
    first = np.full(T, -1, np.int64)
    last = np.full(T, -1, np.int64)
    uniq, idx_first = np.unique(tree_of_row, return_index=True)
    m = (uniq >= 0) & (uniq < T)
    first[uniq[m]] = idx_first[m]
    # last occurrence
    uniq_r, idx_last_rev = np.unique(tree_of_row[::-1], return_index=True)
    m = (uniq_r >= 0) & (uniq_r < T)
    last[uniq_r[m]] = n - 1 - idx_last_rev[m]
    dist = mut.dist.astype(np.float64)
    csum = np.concatenate([[0.0], np.cumsum(dist)])
    has = first >= 0
    i0 = np.where(has, first, 0)
    i1 = np.where(has, last, 0)
    s = csum[i1 + 1] - csum[i0]
    s += np.where(i0 > 0, dist[np.maximum(i0 - 1, 0)] / 2.0, 0.0)
    s -= np.where(i1 < n - 1, dist[i1] / 2.0, 0.0)
    spans[has] = s[has]
    return spans


def tree_spans_dist(anc: AncFile, mut: MutTable, dist_path: str) -> np.ndarray:
    """[num_trees] float64 spans from a separate ``.dist`` file — the
    AncMutIterators (anc, mut, dist) constructor + NextTree semantics
    (mutations.cpp:399-465, 616-668): the file holds (pos, dist) rows
    (header skipped); the cursor skips file entries below a tree's
    first mutation position, takes the half-dist of the file entry
    preceding it, sums the file dists aligned 1:1 with the tree's
    mutation rows (positions must match — the reference asserts), and
    subtracts half of the last consumed dist when the file continues."""
    with open(dist_path) as fh:
        lines = fh.read().split()
    # header = 2 tokens; rows follow as pos dist pairs
    vals = np.array(lines[2:], np.float64)
    fpos = vals[0::2].astype(np.int64)
    fdist = vals[1::2]

    T = anc.num_trees
    spans = np.zeros(T, np.float64)
    n = len(mut)
    if n == 0 or fpos.size == 0:
        return spans
    tree_of_row = mut.tree
    pos = mut.pos.astype(np.int64)
    # per-row file index; the reference walks the cursor forward and
    # asserts *it_pos == row pos for every row of a tree
    j = np.searchsorted(fpos, pos, side="left")
    if np.any(j >= fpos.size) or np.any(fpos[np.minimum(j, fpos.size - 1)] != pos):
        bad = int(np.nonzero(
            (j >= fpos.size)
            | (fpos[np.minimum(j, fpos.size - 1)] != pos)
        )[0][0])
        raise ValueError(
            f"{dist_path}: no entry for .mut position {int(pos[bad])} "
            "(the reference asserts file/mut position alignment)"
        )
    uniq, first = np.unique(tree_of_row, return_index=True)
    m = (uniq >= 0) & (uniq < T)
    uniq, first = uniq[m], first[m]
    uniq_r, last_rev = np.unique(tree_of_row[::-1], return_index=True)
    mr = (uniq_r >= 0) & (uniq_r < T)
    last = (n - 1 - last_rev[mr])[np.argsort(uniq_r[mr])]
    j0 = j[first]
    j1 = j[last]
    csum = np.concatenate([[0.0], np.cumsum(fdist)])
    s = csum[j1 + 1] - csum[j0]
    s += np.where(j0 > 0, fdist[np.maximum(j0 - 1, 0)] / 2.0, 0.0)
    s -= np.where(j1 + 1 < fpos.size, fdist[j1] / 2.0, 0.0)
    spans[uniq] = s
    return spans


def _populate_numpy_chunk(coords, spans, epochs, N):
    """Per-tree [E] num/denom for one chunk of trees — the host oracle
    for the device kernel (ops/tree_kernel.py), kept in the reference's
    direct interval-overlap form."""
    T, M = coords.shape
    E = epochs.shape[0]
    # stable sort by (coord, node_index): argsort of f32 with index tiebreak
    order = np.argsort(coords, axis=1, kind="stable")  # ties keep index order
    sc = np.take_along_axis(coords.astype(np.float64), order, axis=1)  # [T, M]
    is_leaf = order < N
    lins = np.cumsum(np.where(is_leaf, 1, -1), axis=1)  # [T, M]

    # intervals j=1..M-1: [sc[j-1], sc[j]], k = lins[:, j-1]
    lo = sc[:, :-1]
    hi = sc[:, 1:]
    k = lins[:, :-1].astype(np.float64)
    pairs = k * (k - 1.0) / 2.0  # [T, M-1]

    # epoch overlap of every interval: [T, M-1, E]; epochs bound the sweep —
    # exposure above the last boundary is dropped (coal_tree.cpp:160-174)
    edge_lo = epochs[None, None, :]
    edge_hi = np.concatenate([epochs[1:], [epochs[-1]]])[None, None, :]
    ov = np.clip(
        np.minimum(hi[:, :, None], edge_hi) - np.maximum(lo[:, :, None], edge_lo),
        0.0,
        None,
    )
    ov[:, :, -1] = 0.0  # last epoch: sweep stops at the final boundary
    denom_tree = np.einsum("tm,tme->te", pairs, ov)  # [T, E]

    # coalescence events: internal nodes, assigned to the epoch whose upper
    # boundary first reaches the age (<=); ages above the last boundary drop
    coal_age = sc[:, 1:]
    is_coal = ~is_leaf[:, 1:]
    ep_idx = np.searchsorted(epochs[1:], coal_age.ravel(), side="left").reshape(
        coal_age.shape
    )
    keep = is_coal & (ep_idx <= E - 2)  # events beyond epochs[-1] dropped
    num_tree = np.zeros((T, E), np.float64)
    t_idx = np.broadcast_to(np.arange(T)[:, None], coal_age.shape)
    np.add.at(num_tree, (t_idx[keep], ep_idx[keep]), 1.0)
    w = spans / 1e9
    return num_tree * w[:, None], denom_tree * w[:, None]


# device dispatch threshold: below this many node rows the jit/transfer
# overhead dominates and the vectorised numpy path wins (the kernel's
# equivalence tests pin both paths to the same result either way)
_DEVICE_MIN_NODES = 1 << 18


def accumulate_tree_stats(
    anc: AncFile,
    mut: MutTable,
    epochs: np.ndarray,
    num_blocks_offset: int,
    num: np.ndarray,
    denom: np.ndarray,
    backend: str = "auto",
    dist_file: str | None = None,
) -> int:
    """Add one chromosome's per-block [E] num/denom; returns #blocks used.

    num/denom: [max_blocks, E] accumulators (modified in place).
    backend: "numpy" (host oracle), "device" (batched JAX kernel), or
    "auto" (device for large chromosomes).
    """
    N = anc.n_hap
    T = anc.num_trees
    E = epochs.shape[0]
    spans_f64 = (
        tree_spans_dist(anc, mut, dist_file)
        if dist_file
        else tree_spans(anc, mut)
    )
    spans = np.float32(spans_f64).astype(np.float64)  # driver float
    coords = node_ages(anc)  # [T, M] f32
    M = coords.shape[1]
    nb_local = T // BLOCK_SIZE_TREES + 1

    if backend == "auto":
        # sorted common case (leaves at 0, coalescences age-ordered):
        # the threaded native walk goes first at one-shot CLI scale (the
        # host/device crossover is not yet measured on a GPU)
        try:
            from colate_tpu.ops.tree_kernel import (
                leaf_zero_applicable,
                populate_sorted_native,
            )

            if leaf_zero_applicable(coords, N):
                blocks_local = (np.arange(T) // BLOCK_SIZE_TREES).astype(
                    np.int32
                )
                out = populate_sorted_native(
                    coords, spans, blocks_local, epochs, N, nb_local
                )
                if out is not None:
                    sl = slice(num_blocks_offset, num_blocks_offset + nb_local)
                    num[sl] += out[0]
                    denom[sl] += out[1]
                    return nb_local
        except Exception:
            pass
        backend = "device" if T * M >= _DEVICE_MIN_NODES else "numpy"
    if backend == "device":
        try:
            from colate_tpu.ops.tree_kernel import (
                populate_device,
                populate_device_sorted,
                sorted_case_applicable,
            )
        except Exception:  # jax unavailable: host fallback
            backend = "numpy"
    if backend == "device":
        blocks_local = (np.arange(T) // BLOCK_SIZE_TREES).astype(np.int32)
        if sorted_case_applicable(coords, N):
            # common Relate case (leaves at 0, coalescences age-ordered):
            # the batched sort disappears (ops/tree_kernel.py)
            n_d, d_d = populate_device_sorted(
                coords, spans, blocks_local, epochs, N, nb_local
            )
        else:
            n_d, d_d = populate_device(
                coords, spans, blocks_local, epochs, N, nb_local
            )
        sl = slice(num_blocks_offset, num_blocks_offset + nb_local)
        num[sl] += n_d
        denom[sl] += d_d
        return nb_local

    blocks = num_blocks_offset + np.arange(T) // BLOCK_SIZE_TREES
    # chunk the [t, M, E] overlap tensor to bounded memory
    chunk = max(1, (1 << 24) // max(M * E, 1))
    for i in range(0, T, chunk):
        nt, dt = _populate_numpy_chunk(
            coords[i : i + chunk], spans[i : i + chunk], epochs, N
        )
        np.add.at(num, blocks[i : i + chunk], nt)
        np.add.at(denom, blocks[i : i + chunk], dt)
    return nb_local


def bootstrap_block_weights_tree(num_bootstrap: int, num_blocks: int) -> np.ndarray:
    """coal_tree::init_bootstrap (coal_tree.cpp:180-211): seed fixed at 1,
    inclusive-upper-bound draws, out-of-range draws dropped."""
    rng = MT19937(1)
    w = np.zeros((num_bootstrap, num_blocks), np.float64)
    for i in range(num_bootstrap):
        draws = rng.uniform_int(0, num_blocks, num_blocks)  # [0, num_blocks]!
        draws = draws[draws < num_blocks]
        np.add.at(w[i], draws, 1.0)
    return w


def epochs_from_bins_tree(bins: str, years_per_gen: float) -> np.ndarray:
    """coal() epoch grid (coal.cpp:120-135): 0, 10^lower..<upper step, 10^upper,
    cap — no age splicing, no duplicate-zero quirk."""
    parts = bins.split(",")
    lower = float(np.float32(parts[0]))
    upper = float(np.float32(parts[1]))
    step = float(np.float32(parts[2]))
    log10 = np.log(10.0)
    epochs = [0.0]
    b = lower
    while b < upper:
        epochs.append(np.exp(log10 * b) / years_per_gen)
        b += step
    epochs.append(np.exp(log10 * upper) / years_per_gen)
    epochs.append(max(1e8, 10.0 * epochs[-1]) / years_per_gen)
    return np.array(epochs, np.float64)


def write_tree_coal(path: str, epochs, rates, num_bootstrap: int) -> None:
    """coal_tree::Dump layout (coal_tree.cpp:256-295)."""

    def fmt(x: float) -> str:
        if np.isnan(x):
            return "-nan" if np.signbit(x) else "nan"
        return f"{x:g}"

    with open(path, "w") as fh:
        fh.write(" ".join(str(i) for i in range(num_bootstrap)) + " \n")
        fh.write(" ".join(f"{e:g}" for e in epochs) + " \n")
        for i in range(rates.shape[0]):
            fh.write(f"0 {i} " + " ".join(fmt(r) for r in rates[i]) + " \n")


def run_tree_mode(args) -> int:
    if not args.input or not args.bins:
        print("Needed: input, output, bins.", file=sys.stderr)
        return 2
    ypg = float(np.float32(args.years_per_gen)) if args.years_per_gen else 28.0
    epochs = (
        _epochs_from_coal(args.coal) if args.coal else epochs_from_bins_tree(args.bins, ypg)
    )
    E = epochs.shape[0]
    chroms = ["1"]
    if args.chr_file:
        with open(args.chr_file) as fh:
            chroms = [ln.strip() for ln in fh if ln.strip()]

    from colate_tpu.utils.progress import log_event

    # block accumulators grow on demand (no fixed cap: a chromosome adds
    # T // BLOCK_SIZE_TREES + 1 blocks, unbounded in principle)
    num = np.zeros((_INITIAL_BLOCKS, E), np.float64)
    denom = np.zeros((_INITIAL_BLOCKS, E), np.float64)
    nb = 0
    for c in chroms:
        anc = AncFile.read(f"{args.input}_chr{c}.anc", columns="tree")
        mut = MutTable.read(f"{args.input}_chr{c}.mut")
        dist_file = None
        if getattr(args, "dist", None):
            # engine extension: spans from a separate .dist file (the
            # relate_lib AncMutIterators 3-arg ctor, mutations.cpp:399-465)
            dist_file = f"{args.dist}_chr{c}.dist"
        need = nb + anc.num_trees // BLOCK_SIZE_TREES + 1
        if need > num.shape[0]:
            grow = max(need, 2 * num.shape[0])
            num = np.concatenate([num, np.zeros((grow - num.shape[0], E))])
            denom = np.concatenate(
                [denom, np.zeros((grow - denom.shape[0], E))]
            )
        nb += accumulate_tree_stats(anc, mut, epochs, nb, num, denom,
                                    dist_file=dist_file)
        log_event("tree_chrom", chrom=c, trees=anc.num_trees, blocks=nb)
    B = args.num_bootstraps or 1
    w = bootstrap_block_weights_tree(B, nb)
    num_b = w @ num[:nb]
    den_b = w @ denom[:nb]
    with np.errstate(divide="ignore", invalid="ignore"):
        rates = num_b / den_b
    write_tree_coal(args.output + ".coal", epochs, rates, B)
    log_event("tree_done", blocks=nb, bootstraps=B, out=args.output + ".coal")
    return 0


def _epochs_from_coal(path: str) -> np.ndarray:
    with open(path) as fh:
        lines = fh.read().splitlines()
    return np.array([float(np.float32(x)) for x in lines[1].split()], np.float64)
