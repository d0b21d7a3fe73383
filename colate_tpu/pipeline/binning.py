"""Site-evidence → per-block age-bin histograms.

The reference draws 100 uniform ages per mutation in [age_begin, age_end]
and scatter-adds weights into 185 log-age bins (coal/coal.cpp:2260-2295).
Two implementations:

- :func:`bin_sites_analytic` (default): the *exact expectation* of that
  Monte-Carlo histogram — each site spreads its weight over the bins its
  age interval overlaps, conditional on landing inside the bin table
  (the reference resamples out-of-table draws).  This removes parser
  stochasticity entirely and runs as one dense vectorised pass on the
  device (elementwise + a one-hot contraction over blocks) instead of
  100 transcendental draws per site.

- :func:`bin_sites_mc_parity`: bit-exact replay of the reference's draw
  sequence (libstdc++ mt19937, see hostrng.py) for golden-file tests.

Semantics shared by both (coal.cpp:2244-2298):
- sites with age_begin <= age (==0 for tmp inputs) route their *shared*
  mass into the empirical matrix row keyed by bin(age_end) and their
  *notshared* mass both into that matrix and into the notshared
  histogram (ages drawn over [0, age_end], draws below `age` clamped);
- other sites add shared and notshared mass at the same sampled-age bin,
  with out-of-table draws rejected and redrawn.

Returns histograms in float64 [num_blocks, num_age_bins] plus the
[num_blocks, num_age_bins] emp matrices (row bin1=0 of the reference's
[bins x bins] matrix — the only row it ever populates: coal.cpp:2249-2256
force age_begin2=0.0 so bin_index1 is always 0).
"""

from __future__ import annotations

import numpy as np

from colate_tpu.config import (
    NUM_AGE_BINS,
    NUM_MC_SAMPLES,
    age_bin_edges,
    bin_of_age,
)
from colate_tpu.hostrng import MT19937
from colate_tpu.pipeline.join import JoinedSites


# Loud upper bound on the block axis (the reference allocates 500 fixed
# blocks and silently overruns past them, coal.cpp:3141 — we fail loudly
# instead).  The device kernel's segment-sum buckets num_blocks to a few
# static sizes so compiles stay bounded; 30 Mb blocks put a whole human
# genome at ~120 blocks, so the cap is ~500x headroom.
MAX_BLOCKS = 65536
_BLOCK_BUCKETS = (128, 1024, 8192, MAX_BLOCKS)

# Sites stream to the device in slabs (2 packed transfers each) and the
# kernel fori-loops over fixed-size chunks on device, bounding the
# [chunk, 186] intermediates.
_CHUNK = 262144
_SLAB = 16 * _CHUNK  # 4.2M sites, ~113 MB packed


def _next_bucket(n: int) -> int:
    b = 1024
    while b < n:
        b *= 2
    return min(b, _SLAB)


def _block_bucket(nb: int) -> int:
    for b in _BLOCK_BUCKETS:
        if nb <= b:
            return b
    raise ValueError(f"num_blocks={nb} exceeds MAX_BLOCKS={MAX_BLOCKS}")


# pooled pack buffers keyed by bucket size: (f32 [4,m], int32 [3,m],
# f64 scratch [m], bool scratch [m]), pre-faulted on first use.  Worst
# case the pool holds the slab bucket plus one tail bucket (~230 MB).
_pack_pool: dict[int, tuple] = {}


def _pack_buffers(m: int):
    buf = _pack_pool.get(m)
    if buf is None:
        f = np.zeros((4, m), np.float32)
        ints = np.zeros((3, m), np.int32)
        s64 = np.zeros(m, np.float64)
        b8 = np.zeros(m, bool)
        _pack_pool[m] = buf = (f, ints, s64, b8)
    return buf


def bin_sites_analytic_native(sites: JoinedSites, age: float = 0.0):
    """Native (C++) analytic binning: O(sites) range-adds + prefix sums,
    exact f64 (io.cpp:cn_bin_analytic).  Returns None when the native
    library is unavailable; semantics match :func:`bin_sites_analytic`
    (which computes the same expectation in f32 on the device and stays
    the path for mesh-sharded runs)."""
    import ctypes

    from colate_tpu import native
    from colate_tpu.config import AGE_BIN_C

    lib = native.load()
    if lib is None:
        return None
    nb = sites.num_blocks
    n = len(sites)
    nbins = NUM_AGE_BINS
    edges = np.ascontiguousarray(age_bin_edges())
    ab = np.ascontiguousarray(sites.age_begin, np.float64)
    ae = np.ascontiguousarray(sites.age_end, np.float64)
    ws = np.ascontiguousarray(sites.w_shared, np.float64)
    wn = np.ascontiguousarray(sites.w_notshared, np.float64)
    blk = np.ascontiguousarray(sites.block_id, np.int32)
    outs = [np.zeros((max(nb, 1), nbins), np.float64) for _ in range(4)]
    p = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.cn_bin_analytic(
        n, p(ab), p(ae), p(ws), p(wn), p(blk), max(nb, 1), nbins, p(edges),
        float(age), AGE_BIN_C, *[p(o) for o in outs]
    )
    return tuple(o[:nb] for o in outs)


def bin_sites_analytic(sites: JoinedSites, age: float = 0.0):
    """Expected histograms over the MC sampling (device-friendly math).

    NOTE: tmp-mode parsing forces age=0 (coal.cpp:2073-2074) — `age` is
    accepted for the direct-BCF/BAM parsers which pass the real sample age.

    Data flow: everything the kernel needs in full precision — the emp
    flag (f64 `age_begin <= age`) and the emp bin index (f64 log-edge
    rounding, must match the reference's `bin_of_age`) — is precomputed
    on host, so the host→device payload is 28 bytes/site of f32/int32.
    The device does the [n, 185] overlap
    expectation in f32 (analytic mode is an expectation of the
    reference's 100-draw MC; per-site f32 rounding is far inside that
    approximation — the bit-exact path is bin_sites_mc_parity) and
    reduces over blocks with a sorted segment-sum; per-chunk partials
    accumulate into f64 on host."""
    nb = sites.num_blocks
    nseg = _block_bucket(max(nb, 1))  # raises past MAX_BLOCKS
    n = len(sites)
    nbins = NUM_AGE_BINS

    ab64 = np.asarray(sites.age_begin, np.float64)
    ae64 = np.asarray(sites.age_end, np.float64)

    acc = [np.zeros((nseg, nbins), np.float64) for _ in range(4)]
    pending = []  # [nseg, 4*nbins] device partials, one per slab (async)
    for lo in range(0, max(n, 1), _SLAB):
        hi = min(lo + _SLAB, n)
        m = _next_bucket(max(hi - lo, 1))  # power-of-2 bucket (<= _SLAB)
        c = hi - lo
        # pooled, pre-faulted buffers: two packed transfers per slab
        # (f32 + int32), with the f64-exact precompute (emp flag, emp bin
        # index) fused into the pack via out= ops — fresh page allocation
        # costs ~12 ms/MB on lazily-faulted VM memory, so the hot path
        # allocates nothing after warm-up
        f, ints, s64, b8 = _pack_buffers(m)
        np.copyto(f[0, :c], ab64[lo:hi], casting="unsafe")
        np.copyto(f[1, :c], ae64[lo:hi], casting="unsafe")
        np.copyto(f[2, :c], sites.w_shared[lo:hi], casting="unsafe")
        np.copyto(f[3, :c], sites.w_notshared[lo:hi], casting="unsafe")
        # emp flag from the f64 inputs (age_begin <= age)
        np.less_equal(ab64[lo:hi], age, out=b8[:c])
        np.copyto(ints[0, :c], b8[:c], casting="unsafe")
        # bin(age_end) with the reference's f64 log-edge rounding
        # (config.bin_of_age): floor(log(10*ae)*10+0.5)+1, ae==0 -> 0
        sl = s64[:c]
        np.multiply(ae64[lo:hi], 10.0, out=sl)
        np.maximum(sl, 1e-300, out=sl)
        np.log(sl, out=sl)
        np.multiply(sl, 10.0, out=sl)
        np.add(sl, 0.5, out=sl)
        np.floor(sl, out=sl)
        np.add(sl, 1.0, out=sl)
        np.clip(sl, 0, nbins - 1, out=sl)  # -inf (ae==0) clips to 0
        np.copyto(ints[1, :c], sl, casting="unsafe")
        np.copyto(ints[2, :c], sites.block_id[lo:hi], casting="unsafe")
        if m > c:
            # padding sites carry zero weight and the top block id: they
            # leave every histogram untouched and keep ids nondecreasing
            f[0, c:] = 1.0
            f[1, c:] = 2.0
            f[2:, c:] = 0.0
            ints[:2, c:] = 0
            ints[2, c:] = nseg - 1
        pending.append(_bin_analytic_jit(f, ints, nseg, np.float32(age)))
        if len(pending) > 2:
            h = np.asarray(pending.pop(0), np.float64)
            for i in range(4):
                acc[i] += h[:, i * nbins : (i + 1) * nbins]
    for out in pending:
        h = np.asarray(out, np.float64)
        for i in range(4):
            acc[i] += h[:, i * nbins : (i + 1) * nbins]
    return tuple(a[:nb] for a in acc)


def _overlap_probs(a, b, edges):
    """P(U[a,b] in bin k) for each bin: [n, num_bins]; divides by (b-a)."""
    import jax.numpy as jnp

    lo = edges[:-1][None, :]
    hi = edges[1:][None, :]
    a_ = a[:, None]
    b_ = b[:, None]
    width = jnp.maximum(b_ - a_, 1e-300)
    ov = jnp.clip(jnp.minimum(b_, hi) - jnp.maximum(a_, lo), 0.0, None)
    return ov / width


def _chunk_hist(ab, ae, w_shared, w_notshared, emp8, bin2, block_id, num_seg, age32):
    """One chunk's stacked [num_seg, 4*nbins] f32 histogram.

    All inputs arrive f32/int32 (the host precomputes the f64-exact emp
    flag and emp bin index — see bin_sites_analytic); the wide [n, nbins]
    overlap expectation runs in f32 (analytic mode is itself an expectation
    of the reference's 100-draw MC; see bin_sites_analytic).
    Works with or without jax_enable_x64."""
    import jax
    import jax.numpy as jnp

    nbins = NUM_AGE_BINS
    f32 = jnp.float32
    edges32 = jnp.asarray(age_bin_edges(), f32)
    is_emp = emp8 > 0

    # --- regular sites: conditional on bin <= nbins-1 (resampling) ---
    # clamping draws below `age` up to `age` is only in the emp branch;
    # in the regular branch draws below `age` are rejected (skip=true)
    # and redrawn, so the distribution is U[max(age_begin,age), age_end]
    # conditional on landing in-table.  (For tmp inputs age==0: no-op.)
    a_reg = jnp.maximum(ab, age32)
    p = _overlap_probs(a_reg, ae, edges32)  # [n, nbins] f32
    norm = jnp.sum(p, axis=1, keepdims=True)
    p = jnp.where(norm > 0, p / jnp.maximum(norm, f32(1e-30)), f32(0.0))
    w_s = jnp.where(is_emp, f32(0.0), w_shared)
    w_n_reg = jnp.where(is_emp, f32(0.0), w_notshared)

    # --- emp sites: T = max(U[age_begin, age_end], age), no resampling.
    # Distribute via the clamped CDF: F_T(e) = cdf_U(e) if e > age else 0,
    # so mass below `age` collapses into the bin containing `age`.
    # (age==0 is the common case: plain uniform over [0, age_end].) ---
    width = jnp.maximum(ae - ab, f32(1e-30))
    cdf_u = jnp.clip((edges32[None, :] - ab[:, None]) / width[:, None], 0.0, 1.0)
    f_t = jnp.where(edges32[None, :] > age32, cdf_u, f32(0.0))
    p_emp = f_t[:, 1:] - f_t[:, :-1]
    # out-of-table mass (beyond the last edge) is clipped into the last
    # bin — the reference would write out of bounds there (see
    # config.bin_of_age); unreachable with realistic ages.
    p_emp = p_emp.at[:, -1].add(1.0 - f_t[:, -1])
    w_n_emp = jnp.where(is_emp, w_notshared, f32(0.0))

    # --- emp matrices: keyed by the host-computed f64-exact bin(age_end)
    oh_bin2 = (
        bin2[:, None] == jnp.arange(nbins, dtype=jnp.int32)[None, :]
    ).astype(f32)
    w_se = jnp.where(is_emp, w_shared, f32(0.0))
    w_ne = jnp.where(is_emp, w_notshared, f32(0.0))

    # --- block reduction: one one-hot matmul for all four
    # [num_seg, nbins] outputs instead of scatters (num_seg is bucketed
    # small: 128 covers a whole human genome of 30 Mb blocks); HIGHEST
    # keeps the f32 contraction out of reduced-precision matrix units ---
    M = jnp.concatenate(
        [
            p * w_s[:, None],
            p * w_n_reg[:, None] + p_emp * w_n_emp[:, None],
            oh_bin2 * w_se[:, None],
            oh_bin2 * w_ne[:, None],
        ],
        axis=1,
    )  # [n, 4*nbins]
    oh_blk = (
        block_id[:, None] == jnp.arange(num_seg, dtype=block_id.dtype)[None, :]
    ).astype(f32)
    return jnp.einsum("nk,nc->kc", oh_blk, M, precision=jax.lax.Precision.HIGHEST)


def _make_bin_analytic():
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnums=(2,))
    def fn(f, ints, num_seg, age):
        # f [4, m] f32 (age_begin, age_end, w_shared, w_notshared);
        # ints [3, m] int32 (emp flag, emp bin2, block id); m is a
        # power-of-2 bucket.  The chunk loop runs ON DEVICE so a slab
        # costs two host->device transfers total; the per-chunk partials
        # accumulate into one stacked [num_seg, 4*nbins] f32 output the
        # caller reads back once per slab.
        m = f.shape[1]
        age32 = age.astype(jnp.float32) if hasattr(age, "astype") else jnp.asarray(age, jnp.float32)
        if m <= _CHUNK:
            return _chunk_hist(
                f[0], f[1], f[2], f[3], ints[0], ints[1], ints[2], num_seg, age32
            )
        n_chunks = m // _CHUNK  # m is a power-of-2 multiple of _CHUNK

        def body(i, acc):
            fs = jax.lax.dynamic_slice_in_dim(f, i * _CHUNK, _CHUNK, axis=1)
            es = jax.lax.dynamic_slice_in_dim(ints, i * _CHUNK, _CHUNK, axis=1)
            return acc + _chunk_hist(
                fs[0], fs[1], fs[2], fs[3], es[0], es[1], es[2], num_seg, age32
            )

        acc0 = jnp.zeros((num_seg, 4 * NUM_AGE_BINS), jnp.float32)
        return jax.lax.fori_loop(0, n_chunks, body, acc0)

    return fn


_bin_analytic_cache = None


def _bin_analytic_jit(*args):
    global _bin_analytic_cache
    if _bin_analytic_cache is None:
        _bin_analytic_cache = _make_bin_analytic()
    return _bin_analytic_cache(*args)


class GrowableBlockHists:
    """Four [blocks, nbins] block-histogram accumulators that grow on
    demand — no fixed block cap (a 30 Mb-block genome of any size fits).

    Iterating yields the four current arrays (shared, notshared,
    shared_emp, notshared_emp), so callers that unpack a 4-tuple work
    unchanged; callers that know the upcoming block range call
    :meth:`ensure` first."""

    def __init__(self, nbins: int = NUM_AGE_BINS, initial_blocks: int = 512):
        self.arrays = [
            np.zeros((initial_blocks, nbins), np.float64) for _ in range(4)
        ]

    def ensure(self, blocks: int) -> None:
        cur = self.arrays[0].shape[0]
        if blocks <= cur:
            return
        grow = max(blocks, 2 * cur)
        self.arrays = [
            np.concatenate([a, np.zeros((grow - cur, a.shape[1]))])
            for a in self.arrays
        ]

    def __iter__(self):
        return iter(self.arrays)


def mc_bin_site(
    shared, notshared, shared_emp, notshared_emp,
    blk: int, ab: float, ae: float, ws: float, wn: float,
    rng: MT19937, age: float = 0.0,
    ws_mc: float | None = None, wn_mc: float | None = None,
) -> None:
    """Replay the reference's per-site sampling (coal.cpp:2244-2298) into
    preallocated [>=blk+1, num_age_bins] histograms, consuming `rng` in
    the reference's exact order.

    ws_mc/wn_mc are the per-draw weights in the reference's exact fp
    grouping x*DAF_ref/(N_ref*100.0); they default to ws/100 (one extra
    rounding — only visible under exact cancellation)."""
    nbins = NUM_AGE_BINS
    if ws_mc is None:
        ws_mc = ws / NUM_MC_SAMPLES
    if wn_mc is None:
        wn_mc = wn / NUM_MC_SAMPLES
    if ab <= age:
        bin2 = int(bin_of_age(ae))
        shared_emp[blk, bin2] += ws
        notshared_emp[blk, bin2] += wn
        # 100 unconditional draws over [ab, ae] (ab<=age), clamped up to age
        u = rng.uniform01(NUM_MC_SAMPLES)
        t = u * (ae - ab) + ab
        t = np.maximum(t, age)
        b = bin_of_age(t)
        np.add.at(notshared[blk], b, wn_mc)
    else:
        accepted = 0
        while accepted < NUM_MC_SAMPLES:
            u = rng.uniform01(NUM_MC_SAMPLES - accepted)
            t = u * (ae - ab) + ab
            with np.errstate(divide="ignore"):
                raw_bin = (
                    np.floor(np.log(10.0 * np.maximum(t, 1e-300)) * 10.0 + 0.5)
                ).astype(np.int64) + 1
            raw_bin = np.where(t > 0, np.maximum(raw_bin, 0), 0)
            keep = (t >= age) & (raw_bin < nbins)
            b = raw_bin[keep]
            np.add.at(shared[blk], b, ws_mc)
            np.add.at(notshared[blk], b, wn_mc)
            accepted += int(keep.sum())


def bin_sites_mc_parity(sites: JoinedSites, rng: MT19937, age: float = 0.0):
    """Bit-exact replay of the reference's sampling loop (coal.cpp:2244-2298).

    Draw order: sites in genome order; per site 100 uniforms (with
    rejection-redraw for out-of-table bins in the non-emp branch).
    Returns the same four [num_blocks, num_age_bins] float64 arrays.
    """
    nb = sites.num_blocks
    nbins = NUM_AGE_BINS
    shared = np.zeros((nb, nbins), np.float64)
    notshared = np.zeros((nb, nbins), np.float64)
    shared_emp = np.zeros((nb, nbins), np.float64)
    notshared_emp = np.zeros((nb, nbins), np.float64)

    ws_mc, wn_mc = sites.mc_weights()
    for i in range(len(sites)):
        mc_bin_site(
            shared, notshared, shared_emp, notshared_emp,
            int(sites.block_id[i]), sites.age_begin[i], sites.age_end[i],
            sites.w_shared[i], sites.w_notshared[i], rng, age,
            ws_mc=ws_mc[i], wn_mc=wn_mc[i],
        )
    return shared, notshared, shared_emp, notshared_emp
