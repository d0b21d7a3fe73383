"""Synthetic Relate .anc/.mut pairs: random coalescent marginal trees."""

from __future__ import annotations

import numpy as np

from colate_tpu.formats.anc import AncFile
from colate_tpu.formats.mut import MutTable

REF_COALRATE = "/tmp/refbin/CoalRate"


def random_tree(g, N: int, rate: float = 1e-4):
    """One Kingman-ish tree: returns (parent[2N-1], blen[2N-1], ages[2N-1]).

    Leaves 0..N-1 at age 0; internal nodes N..2N-2 in coalescence order
    (parents always numbered after children, like Relate output)."""
    M = 2 * N - 1
    parent = np.full(M, -1, np.int64)
    ages = np.zeros(M, np.float64)
    active = list(range(N))
    t = 0.0
    nxt = N
    while len(active) > 1:
        k = len(active)
        t += g.exponential(1.0 / (rate * k * (k - 1) / 2.0))
        i, j = g.choice(len(active), size=2, replace=False)
        a, b = active[i], active[j]
        parent[a] = nxt
        parent[b] = nxt
        ages[nxt] = t
        active = [x for x in active if x not in (a, b)] + [nxt]
        nxt += 1
    blen = np.zeros(M, np.float64)
    for u in range(M - 1):
        blen[u] = ages[parent[u]] - ages[u]
    return parent, blen, ages


def random_trees(g, T: int, N: int, rate: float = 1e-4):
    """Vectorised Kingman topologies: parent [T, 2N-1] + node ages [T, 2N-1].

    All T trees advance one coalescence per step (N-1 steps of O(T)
    vector work) — :func:`random_tree` is fine at test scale but takes
    minutes at 60k trees.  Leaves are 0..N-1 at age 0; internal node
    N+s is the s-th coalescence, so internal ages are nondecreasing."""
    M = 2 * N - 1
    parent = np.full((T, M), -1, np.int64)
    ages = np.zeros((T, M), np.float64)
    rows = np.arange(T)
    act = np.tile(np.arange(N), (T, 1))  # active lineage ids per slot
    t = np.zeros(T, np.float64)
    for s in range(N - 1):
        k = N - s
        t += g.exponential(1.0 / (rate * k * (k - 1) / 2.0), T)
        i = g.integers(0, k, T)
        j = g.integers(0, k - 1, T)
        j += j >= i
        a, b = act[rows, i], act[rows, j]
        new = N + s
        parent[rows, a] = new
        parent[rows, b] = new
        ages[:, new] = t
        lo, hi = np.minimum(i, j), np.maximum(i, j)
        act[rows, lo] = new
        act[rows, hi] = act[:, k - 1]
    return parent, ages


def make_anc_mut(
    prefix: str,
    chrom: str,
    N: int = 10,
    num_trees: int = 37,
    snps_per_tree: int = 20,
    seed: int = 0,
    skip_trees: tuple = (),
    sample_ages=None,
):
    """Write <prefix>_chr<chrom>.anc/.mut; some trees can have no SNPs."""
    g = np.random.default_rng(seed)
    M = 2 * N - 1
    parent = np.empty((num_trees, M), np.int32)
    blen = np.empty((num_trees, M), np.float64)
    start = np.zeros(num_trees, np.int64)
    snp = 0
    rows_tree, rows_pos = [], []
    bp = 100
    for t in range(num_trees):
        p, b, _ = random_tree(g, N)
        parent[t] = p
        blen[t] = b
        start[t] = snp
        if t not in skip_trees:
            for _ in range(int(g.integers(max(1, snps_per_tree // 2), snps_per_tree + 1))):
                rows_tree.append(t)
                rows_pos.append(bp)
                bp += int(g.integers(50, 3000))
                snp += 1
    anc = AncFile(
        n_hap=N,
        sample_ages=(
            None if sample_ages is None else np.asarray(sample_ages, np.float64)
        ),
        start_pos=start,
        parent=parent,
        branch_length=blen,
        num_events=np.ones((num_trees, M), np.float32),
        snp_begin=np.zeros((num_trees, M), np.int32),
        snp_end=np.zeros((num_trees, M), np.int32),
    )
    anc.write(f"{prefix}_chr{chrom}.anc")

    n = len(rows_tree)
    pos = np.array(rows_pos, np.int64)
    dist = np.diff(np.append(pos, pos[-1] + 1000)).astype(np.int64)
    bases = np.array(list("ACGT"))
    anc_al = bases[g.integers(0, 4, n)]
    der_al = bases[(np.searchsorted(bases, anc_al) + g.integers(1, 4, n)) % 4]
    tbl = MutTable(
        header="snp;pos_of_snp;dist;rs-id;tree_index;branch_indices;is_not_mapping;"
        "is_flipped;age_begin;age_end;ancestral_allele/alternative_allele;"
        "upstream_allele;downstream_allele;",
        snp_id=np.arange(n, dtype=np.int64),
        pos=pos,
        dist=dist,
        rs_id=np.array([f"rs{i}" for i in range(n)], dtype=object),
        tree=np.array(rows_tree, np.int64),
        branch=[[int(g.integers(0, M - 1))] for _ in range(n)],
        num_branches=np.ones(n, np.int64),
        flipped=np.zeros(n, np.int64),
        age_begin=np.zeros(n, np.float64),
        age_end=np.full(n, 100.0, np.float64),
        mutation_type=np.array([f"{a}/{d}" for a, d in zip(anc_al, der_al)], object),
        rest=np.array([""] * n, dtype=object),
    )
    tbl.write(f"{prefix}_chr{chrom}.mut")
    return anc, tbl
