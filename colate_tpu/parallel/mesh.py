"""Device-mesh execution of the mut pipeline.

The reference is strictly single-core (SURVEY §2.9); the parallel axes
live in the data model.  Mapping onto a 1-D device mesh (axis "d"):

- **binning** (throughput-bound): sites are sharded along the genome
  axis on block boundaries; every device reduces its shard into a full
  [num_blocks, 185] histogram and the partials are merged with one
  ``psum`` — the classic data-parallel sufficient-statistic reduction.
- **EM** (latency-bound, tiny tensors): the bootstrap axis is sharded —
  replicates are independent EM fixed-points, so B replicates run
  embarrassingly parallel across devices, then ``all_gather``.

Both are expressed with ``shard_map`` over a 1-D ``jax.sharding.Mesh``
so the same code runs on one device, the cards of one host, or several
hosts (the mesh simply gets more devices; cross-host merges ride the
same psum).
"""

from __future__ import annotations

import functools

import numpy as np

from colate_tpu.config import NUM_AGE_BINS, age_bin_edges


def make_mesh(n_devices: int | None = None):
    """1-D mesh over the first ``n_devices`` devices of the default
    backend.  Raises ValueError when the backend has fewer.

    COLATE_MESH_BACKEND names another backend to draw the devices from:
    "cpu" pins the virtual multi-device CPU platform
    (``--xla_force_host_platform_device_count``), which the multichip
    dry run (__graft_entry__.py) and the tests use so that every mesh
    size draws from the same pool."""
    import os

    import jax
    from jax.sharding import Mesh

    backend = os.environ.get("COLATE_MESH_BACKEND")
    devs = jax.local_devices(backend=backend) if backend else jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"mesh of {n_devices} devices requested but backend "
                f"{devs[0].platform!r} has {len(devs)}"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("d",))


def _pad_to(x: np.ndarray, n: int, fill=0):
    if x.shape[0] == n:
        return x
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad])


def _balanced_cuts(allowed: np.ndarray, total: int, nd: int) -> np.ndarray:
    """[nd+1] nondecreasing boundaries drawn from the `allowed` cut
    points (which must start at 0 and end at `total`), each nearest to
    its even-split target."""
    bounds = np.zeros(nd + 1, np.int64)
    bounds[nd] = total
    for d in range(1, nd):
        target = (total * d) // nd
        i = int(np.searchsorted(allowed, target, "left"))
        if i >= allowed.size:
            i = allowed.size - 1
        elif i > 0 and target - allowed[i - 1] <= allowed[i] - target:
            i -= 1
        bounds[d] = allowed[i]
    return np.maximum.accumulate(bounds)


def _block_aligned_site_bounds(blk: np.ndarray, nd: int) -> np.ndarray:
    """[nd+1] site-index device boundaries that only cut at block-id
    changes, balancing site counts.  With nondecreasing ids this puts
    every block wholly on one device, so the per-device histogram
    partials are disjoint and the psum merge is exact (+0 elsewhere) —
    the same argument the multihost chromosome partition makes
    (parallel/multihost.py)."""
    n = blk.size
    if n == 0:
        return np.zeros(nd + 1, np.int64)
    cut = np.flatnonzero(np.diff(blk)) + 1
    allowed = np.concatenate([[0], cut, [n]]).astype(np.int64)
    return _balanced_cuts(allowed, n, nd)


# Sites reach the device as pieces of at most _MAX_PIECE sites: a
# piece's [piece, 185] f64 intermediates stay a few hundred MB whatever
# the genome size.
_MAX_PIECE = 1 << 18


def _piece_layout(blk: np.ndarray, bounds: np.ndarray):
    """Cut every run of equal block id into pieces of at most C sites,
    counted from the run's start, and deal each device the pieces of
    its site range.  Returns (C, [nd] lists of (start, stop, block)).

    C depends on the data alone, and a piece always starts at row 0 of
    its [C] slot, so a block's pieces hold the same sites at the same
    offsets for every mesh size."""
    n = blk.size
    runs = np.concatenate([[0], np.flatnonzero(np.diff(blk)) + 1, [n]])
    longest = int(np.max(np.diff(runs))) if n else 1
    C = 1024
    while C < min(longest, _MAX_PIECE):
        C *= 2
    per_dev = [[] for _ in range(bounds.size - 1)]
    owner = np.searchsorted(bounds, runs[:-1], side="right") - 1
    for s, e, d in zip(runs[:-1].tolist(), runs[1:].tolist(), owner.tolist()):
        for p in range(s, e, C):
            per_dev[d].append((p, min(p + C, e), int(blk[s])))
    return C, per_dev


def sharded_bin_sites(mesh, age_begin, age_end, w_shared, w_notshared, block_id,
                      num_blocks: int, age: float = 0.0):
    """Data-parallel analytic binning: shard sites, psum block histograms.

    Inputs are host numpy arrays; returns the four [num_blocks, 185]
    float64 histograms (replicated).

    Sites are sharded on BLOCK boundaries (``_block_aligned_site_bounds``)
    so each block's histogram is computed entirely on one device and the
    psum adds exact zeros from the others.  Each device walks its pieces
    (``_piece_layout``) in order; a piece reduces to its four [185] rows
    with fixed-shape column sums, and its rows are added to its block's.
    No step depends on the mesh size or on the order in which a scatter
    lands, so the meshed result is bitwise identical to a 1-device run of
    the same path — the property the multichip dry run asserts.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    nd = mesh.devices.size
    blk64 = np.asarray(block_id, np.int64)
    bounds = _block_aligned_site_bounds(blk64, nd)
    C, per_dev = _piece_layout(blk64, bounds)
    npc = max(max(len(p) for p in per_dev), 1)
    # padding rows and pieces carry zero weight: they add exact +0.0
    ab = np.full((nd, npc, C), 1.0, np.float64)
    ae = np.full((nd, npc, C), 2.0, np.float64)
    ws = np.zeros((nd, npc, C), np.float64)
    wn = np.zeros((nd, npc, C), np.float64)
    pblk = np.zeros((nd, npc), np.int32)
    cols = [(ab, age_begin), (ae, age_end), (ws, w_shared), (wn, w_notshared)]
    for d, pieces in enumerate(per_dev):
        for i, (lo, hi, b) in enumerate(pieces):
            for dst, src in cols:
                dst[d, i, : hi - lo] = src[lo:hi]
            pblk[d, i] = b

    fn = _sharded_bin_fn(mesh, max(num_blocks, 1), float(age))
    sh = NamedSharding(mesh, P("d"))
    args = [jax.device_put(a, sh) for a in (ab, ae, ws, wn, pblk)]
    out = np.asarray(fn(*args))
    return tuple(out[j, :num_blocks] for j in range(4))


def _piece_hist(ab, ae, ws, wn, age, edges):
    """[4, 185] f64 histogram rows (shared, notshared, shared_emp,
    notshared_emp) of one piece of sites — the expectation that
    pipeline/binning.py:_chunk_hist computes in f32."""
    import jax.numpy as jnp

    from colate_tpu.pipeline.binning import _overlap_probs

    nbins = NUM_AGE_BINS
    is_emp = ab <= age
    a_reg = jnp.maximum(ab, age)
    p = _overlap_probs(a_reg, ae, edges)
    norm = jnp.sum(p, axis=1, keepdims=True)
    p = jnp.where(norm > 0, p / jnp.maximum(norm, 1e-300), 0.0)
    w_s = jnp.where(is_emp, 0.0, ws)
    w_n_reg = jnp.where(is_emp, 0.0, wn)
    width = jnp.maximum(ae - ab, 1e-300)
    cdf_u = jnp.clip((edges[None, :] - ab[:, None]) / width[:, None], 0.0, 1.0)
    f_t = jnp.where(edges[None, :] > age, cdf_u, 0.0)
    p_emp = f_t[:, 1:] - f_t[:, :-1]
    p_emp = p_emp.at[:, -1].add(1.0 - f_t[:, -1])
    w_s_emp = jnp.where(is_emp, ws, 0.0)
    w_n_emp = jnp.where(is_emp, wn, 0.0)
    bin2 = jnp.clip(
        jnp.where(
            ae > 0,
            jnp.floor(jnp.log(10.0 * jnp.maximum(ae, 1e-300)) * 10.0 + 0.5).astype(
                jnp.int32
            )
            + 1,
            0,
        ),
        0,
        nbins - 1,
    )
    onehot = bin2[:, None] == jnp.arange(nbins, dtype=jnp.int32)[None, :]
    return jnp.stack([
        jnp.sum(p * w_s[:, None], axis=0),
        jnp.sum(p * w_n_reg[:, None] + p_emp * w_n_emp[:, None], axis=0),
        jnp.sum(jnp.where(onehot, w_s_emp[:, None], 0.0), axis=0),
        jnp.sum(jnp.where(onehot, w_n_emp[:, None], 0.0), axis=0),
    ])


@functools.lru_cache(maxsize=8)
def _sharded_bin_fn(mesh, num_blocks: int, age: float):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    edges_np = age_bin_edges()
    nbins = NUM_AGE_BINS

    def local_bin(ab, ae, ws, wn, pblk):
        # [1, pieces, C] local slabs (block-aligned device ranges)
        ab, ae, ws, wn, pblk = ab[0], ae[0], ws[0], wn[0], pblk[0]
        edges = jnp.asarray(edges_np)

        def add_piece(i, acc):
            h = _piece_hist(ab[i], ae[i], ws[i], wn[i], age, edges)
            return acc.at[:, pblk[i]].add(h)

        # derived from the sharded input so the loop carry has the same
        # varying-across-mesh type as the body's output
        acc0 = jnp.zeros((4, num_blocks, nbins), jnp.float64) + ws[0, 0] * 0.0
        acc = jax.lax.fori_loop(0, ab.shape[0], add_piece, acc0)
        # merge partial sufficient statistics across the mesh
        return jax.lax.psum(acc, "d")

    mapped = shard_map(
        local_bin,
        mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P("d")),
        out_specs=P(),
    )
    return jax.jit(mapped)


def sharded_run_em(mesh, epochs, init_rates, shared_counts, notshared_counts,
                   max_iter: int | None = None, min_iter: int | None = None,
                   dtype: str | None = None):
    """Bootstrap-parallel EM: shard replicates over the mesh.

    shared/notshared_counts: [B, nbins] host arrays.  B is padded to a
    multiple of the mesh size (padded replicates see the replicate-0
    counts and are discarded).  Returns (rates [B,E], logl [B], iters [B]).

    Every shard runs ops/em.py:run_em_sequential (``dtype`` as for
    run_em; f64 by default), so each replicate executes the same B=1
    program whatever the mesh size.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from colate_tpu.config import EM_MAX_ITER, EM_MIN_ITER
    from colate_tpu.ops.em import run_em_sequential

    nd = mesh.devices.size
    B = shared_counts.shape[0]
    mi = max_iter if max_iter is not None else EM_MAX_ITER
    mn = min_iter if min_iter is not None else EM_MIN_ITER
    sh_b = NamedSharding(mesh, P("d"))
    rep = NamedSharding(mesh, P())

    B_pad = ((B + nd - 1) // nd) * nd
    sc = _pad_to(np.asarray(shared_counts, np.float64), B_pad)
    nc = _pad_to(np.asarray(notshared_counts, np.float64), B_pad)
    if B_pad > B:
        sc[B:] = sc[0]
        nc[B:] = nc[0]

    def local_em(ep, ir, s, n):
        return run_em_sequential(
            ep, ir, s, n, max_iter=mi, min_iter=mn, dtype=dtype
        )

    mapped = shard_map(
        local_em,
        mesh=mesh,
        in_specs=(P(), P(), P("d"), P("d")),
        out_specs=(P("d"), P("d"), P("d")),
    )
    rates, logl, iters = jax.jit(mapped)(
        jax.device_put(np.asarray(epochs), rep),
        jax.device_put(np.asarray(init_rates), rep),
        jax.device_put(sc, sh_b),
        jax.device_put(nc, sh_b),
    )
    return (
        np.asarray(rates)[:B],
        np.asarray(logl)[:B],
        np.asarray(iters)[:B],
    )
