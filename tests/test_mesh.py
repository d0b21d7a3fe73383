"""Mesh-sharded execution must reproduce the single-device results.

Runs on the virtual 8-device CPU platform (conftest).  These are the
multi-host equivalence tests SURVEY §4 calls for: N-device psum-merged
sufficient statistics vs the 1-device reduction, and bootstrap-sharded
EM vs the batched EM.
"""

import numpy as np
import pytest

from colate_tpu.config import age_bin_centers
from colate_tpu.parallel.mesh import make_mesh, sharded_bin_sites, sharded_run_em


@pytest.mark.parametrize("nd", [1, 4, 8])
def test_sharded_binning_matches_single_device(nd):
    import jax

    if len(jax.devices()) < nd:
        pytest.skip("not enough virtual devices")
    from colate_tpu.pipeline.binning import bin_sites_analytic
    from colate_tpu.pipeline.join import JoinedSites

    g = np.random.default_rng(7)
    n = 5000
    ab = g.uniform(0.0, 1e4, n)
    ae = ab + g.uniform(1.0, 1e5, n)
    ws = g.uniform(0.0, 2.0, n)
    wn = g.uniform(0.0, 2.0, n)
    blk = np.sort(g.integers(0, 9, n)).astype(np.int32)
    sites = JoinedSites(
        age_begin=ab, age_end=ae, w_shared=ws, w_notshared=wn,
        block_id=blk, num_blocks=10,
    )
    ref = bin_sites_analytic(sites, age=0.0)
    mesh = make_mesh(nd)
    out = sharded_bin_sites(mesh, ab, ae, ws, wn, blk, 10, age=0.0)
    for a, b in zip(out, ref):
        # sharded path reduces in f64 on CPU; single-device kernel works
        # in f32 with f64 accumulation — compare at f32-level tolerance
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-8)


@pytest.mark.parametrize("nd", [2, 8])
def test_sharded_em_matches_batched(nd):
    import jax
    import jax.numpy as jnp

    if len(jax.devices()) < nd:
        pytest.skip("not enough virtual devices")
    from colate_tpu.ops.em import run_em

    g = np.random.default_rng(3)
    B = 5  # deliberately not a multiple of the mesh size (padding path)
    epochs = np.array([0.0, 500.0, 2000.0, 8000.0, 32000.0, 1e6])
    t = age_bin_centers()
    lam = 1e-4
    p = 1 - np.exp(-lam * t)
    sc = np.stack([(100 + 50 * i) * p for i in range(B)])
    nc = np.stack([(100 + 50 * i) * (1 - p) for i in range(B)])
    init = np.full(6, 1 / 20000.0)
    r_ref, l_ref, i_ref = run_em(
        jnp.asarray(epochs), jnp.asarray(init), jnp.asarray(sc), jnp.asarray(nc)
    )
    mesh = make_mesh(nd)
    r_sh, l_sh, i_sh = sharded_run_em(mesh, epochs, init, sc, nc)
    np.testing.assert_array_equal(i_sh, np.asarray(i_ref))
    np.testing.assert_allclose(r_sh, np.asarray(r_ref), rtol=1e-12)
    np.testing.assert_allclose(l_sh, np.asarray(l_ref), rtol=1e-12)


def test_mesh_size_bitwise_invariance():
    """Block-aligned sharding + replicate-sequential EM make EVERY mesh
    size produce bit-identical results (the property the driver's
    multichip dryrun asserts end-to-end on the .coal bytes)."""
    from colate_tpu.ops.em import run_em_sequential
    from colate_tpu.ops.epochs import epochs_from_bins

    g = np.random.default_rng(3)
    n, nb = 15_000, 9
    ae = np.exp(g.uniform(np.log(10.0), np.log(3e5), n))
    ab = ae * g.uniform(0.0, 0.9, n)
    ab[g.random(n) < 0.2] = 0.0
    ws, wn = g.random(n), g.random(n)
    blk = np.sort(g.integers(0, nb, n)).astype(np.int32)

    ref_bins = None
    for nd in (1, 2, 8):
        out = sharded_bin_sites(
            make_mesh(nd), ab, ae, ws, wn, blk, nb
        )
        if ref_bins is None:
            ref_bins = out
        else:
            for a, b in zip(out, ref_bins):
                np.testing.assert_array_equal(a, b)

    epochs, _ = epochs_from_bins("3,7,0.25", 28.0, 0.0)
    init = np.full(epochs.shape, 1 / 20000.0)
    B = 6
    sc = np.abs(g.normal(5.0, 2.0, (B, 185)))
    nc = np.abs(g.normal(50.0, 10.0, (B, 185)))
    r_seq = np.asarray(run_em_sequential(epochs, init, sc, nc)[0])
    for nd in (2, 8):
        r, _, _ = sharded_run_em(make_mesh(nd), epochs, init, sc, nc)
        np.testing.assert_array_equal(r, r_seq)


def _wide_sites(seed, n, nb):
    g = np.random.default_rng(seed)
    ae = np.exp(g.uniform(np.log(10.0), np.log(3e5), n))
    ab = ae * g.uniform(0.0, 0.9, n)
    ab[g.random(n) < 0.2] = 0.0
    blk = np.sort(g.integers(0, nb, n)).astype(np.int32)
    return ab, ae, g.random(n), g.random(n), blk


@pytest.mark.parametrize("nd", [1, 4])
def test_sharded_binning_matches_native_f64(nd):
    """The mesh path computes the same f64 expectation as the native
    host binner (both f64; they differ only in summation order)."""
    from colate_tpu.pipeline.binning import bin_sites_analytic_native
    from colate_tpu.pipeline.join import JoinedSites

    ab, ae, ws, wn, blk = _wide_sites(12, 40_000, 9)
    sites = JoinedSites(
        age_begin=ab, age_end=ae, w_shared=ws, w_notshared=wn,
        block_id=blk, num_blocks=9,
    )
    ref = bin_sites_analytic_native(sites)
    if ref is None:
        pytest.skip("native library unavailable")
    out = sharded_bin_sites(make_mesh(nd), ab, ae, ws, wn, blk, 9)
    for a, b in zip(out, ref):
        assert a.shape == b.shape == (9, 185)
        # the native prefix sums leave ~1e-12-of-the-mass residues in
        # bins no site reaches; compare the bins that hold real mass
        held = b >= 1e-9 * b.sum()
        assert held.sum() > 100
        np.testing.assert_allclose(a[held], b[held], rtol=1e-9)
        assert np.abs(a - b).max() <= 1e-11 * b.sum()


def test_blocks_longer_than_a_piece_stay_mesh_invariant(monkeypatch):
    """Blocks split into several pieces, cut from each block's start:
    every mesh size still gives bitwise the same histograms."""
    import colate_tpu.parallel.mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_MAX_PIECE", 1024)
    ab, ae, ws, wn, blk = _wide_sites(5, 12_000, 3)
    C, per_dev = mesh_mod._piece_layout(
        blk.astype(np.int64), mesh_mod._block_aligned_site_bounds(blk, 2)
    )
    assert C == 1024
    pieces = [p for dev in per_dev for p in dev]
    assert sum(hi - lo for lo, hi, _ in pieces) == blk.size
    assert all(0 < hi - lo <= C for lo, hi, _ in pieces)
    assert len(pieces) > 3  # every block spans several pieces
    outs = [
        sharded_bin_sites(make_mesh(nd), ab, ae, ws, wn, blk, 3)
        for nd in (1, 2, 3)
    ]
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            np.testing.assert_array_equal(a, b)
    whole = sharded_bin_sites(make_mesh(1), ab, ae, ws, wn, blk, 3)
    monkeypatch.setattr(mesh_mod, "_MAX_PIECE", 1 << 18)
    for a, b in zip(whole, outs[0]):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_sharded_f32_em_pads_an_uneven_batch():
    """--em_dtype float32 reaches the mesh EM, and a batch that is not a
    multiple of the mesh size gives each replicate the 1-device result."""
    from colate_tpu.ops.em import run_em_sequential
    from colate_tpu.ops.epochs import epochs_from_bins

    g = np.random.default_rng(8)
    epochs, _ = epochs_from_bins("3,7,0.25", 28.0, 0.0)
    init = np.full(epochs.shape, 1 / 20000.0)
    sc = np.abs(g.normal(5.0, 2.0, (3, 185)))
    nc = np.abs(g.normal(50.0, 10.0, (3, 185)))
    r1, l1, i1 = run_em_sequential(epochs, init, sc, nc, dtype="float32")
    r, l, i = sharded_run_em(make_mesh(2), epochs, init, sc, nc, dtype="float32")
    assert r.shape == (3, epochs.size)
    np.testing.assert_array_equal(i, np.asarray(i1))
    np.testing.assert_array_equal(r, np.asarray(r1))
    r64, _, _ = sharded_run_em(make_mesh(2), epochs, init, sc, nc)
    assert not np.array_equal(r, r64)  # the dtype really changed the path
