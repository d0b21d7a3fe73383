"""Device kernel for the tree-based rate estimator (coal_tree::populate).

The reference walks each marginal tree sequentially: sort the 2N-1 node
ages, sweep the lineage count k(t), and accumulate per-epoch
coalescence counts and pair exposure (coal_tree.cpp:100-174).  Here a
whole chromosome of trees is one batched program over [T, M] arrays:

- sort every row once (``jnp.argsort`` stable, index tiebreak like the
  reference's pre-sorted coordinate/index pairs);
- the per-epoch exposure is NOT materialised as a [T, M, E] overlap
  tensor; instead the cumulative pair exposure
  ``G(t) = \\int_0^t C(k(s),2) ds`` is a piecewise-linear function with
  breakpoints at the sorted node ages, so per tree we build its prefix
  values (one cumsum) and evaluate it at the E epoch edges with a
  row-wise ``searchsorted`` — O(M log M + E) per tree and [T, M]
  memory, which XLA maps to the VPU as pure vector code;
- coalescence counts per epoch are differences of the cumulative
  internal-node count at the same edges (boundary semantics match the
  reference's epoch assignment: an event at exactly ``epochs[e+1]``
  belongs to epoch ``e``, and events past the final boundary drop,
  coal_tree.cpp:148-158);
- per-tree [E] rows are weighted by span/1e9 and segment-summed into
  the 5000-tree bootstrap blocks on device.

Everything accumulates in f64 (the estimator's golden tests compare
rates to the reference at 1e-5 rtol over ~1e5-tree sums; f32
accumulation loses that).  Trees stream through fixed-size slabs so
compile counts stay bounded.
"""

from __future__ import annotations

import functools

import numpy as np

_TREE_SLAB = 65536  # trees per compiled slab (one dispatch per chromosome)


def _slab_bucket(n: int) -> int:
    b = 4096
    while b < n:
        b *= 4
    return min(b, _TREE_SLAB)


@functools.lru_cache(maxsize=32)
def _populate_fn(S: int, M: int, N: int, E: int, nseg: int):
    import jax
    import jax.numpy as jnp

    def fn(coords, spans, blocks, epochs):
        # coords [S, M] f32; spans [S] f64; blocks [S] i32; epochs [E] f64
        order = jnp.argsort(coords, axis=1, stable=True)
        sc = jnp.take_along_axis(coords, order, axis=1).astype(jnp.float64)
        is_leaf = order < N
        k = jnp.cumsum(jnp.where(is_leaf, 1, -1), axis=1)  # lineage count [S,M]
        kf = k[:, :-1].astype(jnp.float64)
        pairs = kf * (kf - 1.0) * 0.5  # C(k,2) on [sc[j], sc[j+1]]  [S,M-1]
        seg = sc[:, 1:] - sc[:, :-1]
        zero = jnp.zeros((S, 1), jnp.float64)
        # G at breakpoint sc[j]; slope after sc[j] is pairs[j] (0 past root)
        cumG = jnp.concatenate([zero, jnp.cumsum(pairs * seg, axis=1)], axis=1)
        slope = jnp.concatenate([pairs, zero], axis=1)  # [S,M]
        ccnt = jnp.cumsum(~is_leaf, axis=1).astype(jnp.float64)  # [S,M]

        # last breakpoint <= edge (edge-equal ages included): a fused
        # compare-and-count over the M axis — cheaper to compile and run
        # than a vmapped searchsorted scan
        idx = (
            jnp.sum(
                sc[:, :, None] <= epochs[None, None, :], axis=1, dtype=jnp.int32
            )
            - 1
        )  # [S, E]
        valid = idx >= 0
        idxc = jnp.clip(idx, 0, M - 1)
        take = lambda a: jnp.take_along_axis(a, idxc, axis=1)
        g_at = take(cumG) + take(slope) * (epochs[None, :] - take(sc))
        g_at = jnp.where(valid, g_at, 0.0)
        c_at = jnp.where(valid, take(ccnt), 0.0)

        w = (spans / 1e9)[:, None]  # divide, not *1e-9: bit parity with host
        num_t = jnp.diff(c_at, axis=1)  # [S, E-1]: epochs 0..E-2
        # epoch 0 collects EVERY event with age <= epochs[1], including
        # age <= epochs[0] (zero-branch-length trees coalesce at exactly
        # 0); a plain difference c_at(edge1)-c_at(edge0) would drop those
        # while the host oracle (searchsorted(epochs[1:], 'left')) and the
        # reference sweep (coords <= *it_epochs) count them in epoch 0
        num_t = num_t.at[:, 0].set(c_at[:, 1])
        num_t = num_t * w
        den_t = jnp.diff(g_at, axis=1) * w
        num = jax.ops.segment_sum(num_t, blocks, num_segments=nseg)
        den = jax.ops.segment_sum(den_t, blocks, num_segments=nseg)
        pad = jnp.zeros((nseg, 1), jnp.float64)  # final epoch: sweep stops
        return (
            jnp.concatenate([num, pad], axis=1),
            jnp.concatenate([den, pad], axis=1),
        )

    return jax.jit(fn)


@functools.lru_cache(maxsize=32)
def _populate_sorted_fn(S: int, K: int, N: int, E: int, nseg: int):
    """Sorted fast path: contemporaneous leaves (age 0) + internal
    nodes already in age order — the overwhelmingly common Relate case
    (GetCoordinates numbers coalescences by age).  The merged node
    order is then [all N leaves, internal nodes by index], so the sort
    disappears: the lineage count after internal event i is N-i and the
    sweep reduces to one cumsum over the K=N-1 internal ages."""
    import jax
    import jax.numpy as jnp

    # slope after breakpoint i (i=0: below first event) = C(N-i, 2)
    kk = N - np.arange(K + 1, dtype=np.float64)
    slope_np = kk * (kk - 1.0) * 0.5  # [K+1]

    def fn(ia, spans, blocks, epochs):
        # ia [S, K] f32 internal ages (nondecreasing); spans [S] f64
        sc0 = jnp.concatenate(
            [jnp.zeros((S, 1), jnp.float64), ia.astype(jnp.float64)], axis=1
        )  # [S, K+1] breakpoints
        slope = jnp.asarray(slope_np)  # [K+1]
        cumG = jnp.concatenate(
            [
                jnp.zeros((S, 1), jnp.float64),
                jnp.cumsum(slope[None, :-1] * jnp.diff(sc0, axis=1), axis=1),
            ],
            axis=1,
        )  # [S, K+1]

        idx = (
            jnp.sum(
                sc0[:, :, None] <= epochs[None, None, :], axis=1,
                dtype=jnp.int32,
            )
            - 1
        )  # [S, E] last breakpoint <= edge
        valid = idx >= 0
        idxc = jnp.clip(idx, 0, K)
        g_at = (
            jnp.take_along_axis(cumG, idxc, axis=1)
            + slope[idxc] * (epochs[None, :] - jnp.take_along_axis(sc0, idxc, axis=1))
        )
        g_at = jnp.where(valid, g_at, 0.0)
        c_at = jnp.where(valid, idx, 0).astype(jnp.float64)  # events <= edge

        w = (spans / 1e9)[:, None]
        num_t = jnp.diff(c_at, axis=1)
        num_t = num_t.at[:, 0].set(c_at[:, 1])  # epoch-0 collects age<=edge1
        num_t = num_t * w
        den_t = jnp.diff(g_at, axis=1) * w
        num = jax.ops.segment_sum(num_t, blocks, num_segments=nseg)
        den = jax.ops.segment_sum(den_t, blocks, num_segments=nseg)
        pad = jnp.zeros((nseg, 1), jnp.float64)
        return (
            jnp.concatenate([num, pad], axis=1),
            jnp.concatenate([den, pad], axis=1),
        )

    return jax.jit(fn)


def sorted_case_applicable(coords: np.ndarray, n_hap: int) -> bool:
    """True when every leaf age is 0 and internal ages are nondecreasing
    per tree (ties allowed) — the stable merged order then equals
    [leaves, internals] and :func:`_populate_sorted_fn` applies."""
    N = n_hap
    leaf = coords[:, :N]
    ia = coords[:, N:]
    if leaf.size == 0 or ia.size == 0:
        return False
    return bool((leaf == 0.0).all() and (ia[:, 1:] >= ia[:, :-1]).all())


def leaf_zero_applicable(coords: np.ndarray, n_hap: int) -> bool:
    """True when every leaf age is 0 (contemporaneous samples) — the
    native populate (which stably sorts internal ages itself) applies.
    Ages recomputed from branch lengths carry tiny float inversions, so
    this is the practical gate; :func:`sorted_case_applicable` is the
    stricter sort-free device gate."""
    N = n_hap
    leaf = coords[:, :N]
    return leaf.size > 0 and coords.shape[1] > N and bool((leaf == 0.0).all())


def populate_device_sorted(
    coords: np.ndarray,
    spans: np.ndarray,
    blocks: np.ndarray,
    epochs: np.ndarray,
    n_hap: int,
    num_blocks: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-case populate (see _populate_sorted_fn); caller must have
    checked :func:`sorted_case_applicable`."""
    from colate_tpu import enable_compilation_cache, enable_x64

    enable_x64()
    enable_compilation_cache()
    T, M = coords.shape
    N = int(n_hap)
    K = N - 1
    E = epochs.shape[0]
    nseg = max(int(num_blocks), 1)
    num = np.zeros((nseg, E), np.float64)
    den = np.zeros((nseg, E), np.float64)
    ep = np.asarray(epochs, np.float64)
    ia_all = coords[:, N:]
    i = 0
    while i < T:
        n = min(_TREE_SLAB, T - i)
        S = _slab_bucket(n)
        c = np.zeros((S, K), np.float32)
        c[:n] = ia_all[i : i + n]
        s = np.zeros(S, np.float64)
        s[:n] = spans[i : i + n]
        b = np.zeros(S, np.int32)
        b[:n] = blocks[i : i + n]
        fn = _populate_sorted_fn(S, K, N, E, nseg)
        num_d, den_d = fn(c, s, b, ep)
        num += np.asarray(num_d)
        den += np.asarray(den_d)
        i += n
    return num, den


def populate_sorted_native(
    coords: np.ndarray,
    spans: np.ndarray,
    blocks: np.ndarray,
    epochs: np.ndarray,
    n_hap: int,
    num_blocks: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """C++ twin of the sorted fast path (native/em.cpp:
    cn_tree_populate_sorted): one monotone walk per tree, threaded over
    contiguous tree ranges — the one-shot host path (models/tree_coal.py
    tries it first).  Returns None when the native library is
    unavailable."""
    import ctypes

    from colate_tpu import native

    lib = native.load()
    if lib is None:
        return None
    T, M = coords.shape
    N = int(n_hap)
    K = N - 1
    E = epochs.shape[0]
    nseg = max(int(num_blocks), 1)
    num = np.zeros((nseg, E), np.float64)
    den = np.zeros((nseg, E), np.float64)
    if T == 0:
        return num, den
    ia = np.ascontiguousarray(coords[:, N:], np.float32)
    sp = np.ascontiguousarray(spans, np.float64)
    bl = np.ascontiguousarray(blocks, np.int32)
    ep = np.ascontiguousarray(epochs, np.float64)
    pp = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.cn_tree_populate_sorted(
        T, K, N, pp(ia), pp(sp), pp(bl), pp(ep), E, nseg, 0,
        pp(num), pp(den),
    )
    return num, den


def populate_device(
    coords: np.ndarray,
    spans: np.ndarray,
    blocks: np.ndarray,
    epochs: np.ndarray,
    n_hap: int,
    num_blocks: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched coal_tree::populate on the default JAX backend.

    coords: [T, 2N-1] f32 node ages; spans: [T] f64 genome span per tree;
    blocks: [T] block index of each tree; epochs: [E] f64.
    Returns ([num_blocks, E], [num_blocks, E]) f64 num/denom sums.
    """
    from colate_tpu import enable_compilation_cache, enable_x64

    enable_x64()
    enable_compilation_cache()
    T, M = coords.shape
    E = epochs.shape[0]
    nseg = max(int(num_blocks), 1)
    num = np.zeros((nseg, E), np.float64)
    den = np.zeros((nseg, E), np.float64)
    ep = np.asarray(epochs, np.float64)
    i = 0
    while i < T:
        n = min(_TREE_SLAB, T - i)
        S = _slab_bucket(n)
        c = np.zeros((S, M), np.float32)
        c[:n] = coords[i : i + n]
        s = np.zeros(S, np.float64)
        s[:n] = spans[i : i + n]  # zero span => padded rows contribute 0
        b = np.zeros(S, np.int32)
        b[:n] = blocks[i : i + n]
        fn = _populate_fn(S, M, int(n_hap), E, nseg)
        num_d, den_d = fn(c, s, b, ep)
        num += np.asarray(num_d)
        den += np.asarray(den_d)
        i += n
    return num, den
