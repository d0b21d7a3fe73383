"""EM numerics: closed-form oracle checks (the reference's own test
strategy, include/test/test_aDNA.cpp:214-352, re-derived independently)
plus fixed-point sanity on synthetic data."""

import jax.numpy as jnp
import numpy as np
import pytest

from colate_tpu.config import age_bin_centers
from colate_tpu.ops.em import _e_step_all_bins, run_em


def _closed_form_constant_rate(lam, epochs, t):
    """Shared/notshared posteriors for a single constant rate λ.

    T ~ Exp(λ).  shared: condition on T<t; notshared: on T>t.
    Returns (num_s, den_s, logl_s, num_n, den_n, logl_n) per epoch.

    Evaluated with 60-digit ``decimal`` arithmetic so the naive formulas
    (which cancel catastrophically in f64 for small λ·t) stay exact —
    a genuinely independent oracle for the expm1-stabilised kernel.
    """
    from decimal import Decimal, getcontext

    getcontext().prec = 60
    E = len(epochs)
    lam_d = Decimal(repr(float(lam)))
    t_d = Decimal(repr(float(t)))

    def S(x):  # survival e^{-lam x}; x may be Decimal or inf
        if x == Decimal("Infinity"):
            return Decimal(0)
        return (-lam_d * x).exp()

    def P(a, b):  # P(a < T <= b)
        return S(a) - S(b)

    def ET(a, b):  # E[T 1{a<T<=b}]
        inv = 1 / lam_d
        lo = (a + inv) * S(a)
        hi = Decimal(0) if b == Decimal("Infinity") else (b + inv) * S(b)
        return lo - hi

    inf = Decimal("Infinity")
    edges = [Decimal(repr(float(x))) for x in epochs] + [inf]
    Zs = 1 - S(t_d)
    Zn = S(t_d)
    num_s = np.zeros(E)
    den_s = np.zeros(E)
    num_n = np.zeros(E)
    den_n = np.zeros(E)
    for e in range(E):
        a, b = edges[e], edges[e + 1]
        dt = b - a
        # shared
        bs = min(b, t_d)
        if a < t_d and Zs > 0:
            num_s[e] = float(P(a, bs) / Zs)
            extra = dt * P(bs, t_d) if b <= t_d else Decimal(0)
            den_s[e] = float((ET(a, bs) - a * P(a, bs) + extra) / Zs)
        # notshared
        if Zn > 0:
            an = max(a, t_d)
            if b > t_d:
                num_n[e] = float(P(an, b) / Zn)
                tail = dt * S(b) / Zn if b != inf else Decimal(0)
                den_n[e] = float((ET(an, b) - a * P(an, b)) / Zn + tail)
            else:
                den_n[e] = float(dt)
    logl_s = float(Zs.ln()) if Zs > 0 else 0.0
    logl_n = float(Zn.ln()) if Zn > 0 else 0.0
    return num_s, den_s, logl_s, num_n, den_n, logl_n


@pytest.mark.parametrize("lam", [1e-7, 1e-5, 1e-3, 1e-2, 1e-1])
def test_e_step_constant_rate_oracle(lam):
    epochs = jnp.asarray(
        np.array([0.0, 100.0, 1000.0, 10000.0, 100000.0]), jnp.float64
    )
    rates = jnp.full(5, lam, jnp.float64)
    ages = np.array([1.0, 50.0, 100.0, 353.0, 2000.0, 5e4, 2e5])
    t = jnp.asarray(ages)
    k = jnp.clip(jnp.searchsorted(epochs, t, side="right") - 1, 0, 4).astype(jnp.int32)
    num_s, den_s, logl_s, num_n, den_n, logl_n = [
        np.asarray(x) for x in _e_step_all_bins(epochs, rates, t, k)
    ]
    for i, age in enumerate(ages):
        ns, ds, ls, nn, dn, ln = _closed_form_constant_rate(lam, np.asarray(epochs), age)
        np.testing.assert_allclose(num_s[i], ns, rtol=1e-9, atol=1e-12, err_msg=f"num_s age={age}")
        np.testing.assert_allclose(den_s[i], ds, rtol=1e-8, atol=1e-9, err_msg=f"den_s age={age}")
        np.testing.assert_allclose(num_n[i], nn, rtol=1e-9, atol=1e-12, err_msg=f"num_n age={age}")
        np.testing.assert_allclose(den_n[i], dn, rtol=1e-8, atol=1e-9, err_msg=f"den_n age={age}")
        np.testing.assert_allclose(logl_s[i], ls, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(logl_n[i], ln, rtol=1e-9, atol=1e-12)


def test_e_step_no_nan_sweep():
    """NaN/negativity sweep mirroring test_aDNA.cpp:187-208."""
    epochs = jnp.asarray(np.array([0.0, 10.0, 1e3, 1e5, 1e7]), jnp.float64)
    for lam in [0.0, 1e-9, 1e-4, 10.0]:
        rates = jnp.full(5, lam, jnp.float64)
        t = jnp.asarray(age_bin_centers())
        k = jnp.clip(jnp.searchsorted(epochs, t, side="right") - 1, 0, 4).astype(
            jnp.int32
        )
        outs = _e_step_all_bins(epochs, rates, t, k)
        for o in outs:
            a = np.asarray(o)
            assert np.all(np.isfinite(a)), f"non-finite for lam={lam}"
        num_s, den_s, _, num_n, den_n, _ = outs
        assert np.all(np.asarray(num_s) >= 0)
        assert np.all(np.asarray(den_s) >= 0)
        assert np.all(np.asarray(num_n) >= 0)
        assert np.all(np.asarray(den_n) >= 0)


def test_em_recovers_constant_rate():
    """Counts generated from a constant-rate model make EM recover ~that rate."""
    lam_true = 1e-4
    epochs_np = np.array([0.0, 500.0, 2000.0, 8000.0, 32000.0, 1e6])
    t = age_bin_centers()
    # expected counts: many pairs observed at each age; shared with prob
    # 1-exp(-lam t), notshared otherwise
    w = np.exp(-((np.log10(np.maximum(t, 1e-3)) - 3.0) ** 2))  # age profile
    p_shared = 1 - np.exp(-lam_true * t)
    shared = (1000 * w * p_shared)[None, :]
    notshared = (1000 * w * (1 - p_shared))[None, :]
    rates, logl, iters = run_em(
        jnp.asarray(epochs_np),
        jnp.full(6, 1 / 20000.0, jnp.float64),
        jnp.asarray(shared),
        jnp.asarray(notshared),
    )
    rates = np.asarray(rates)[0]
    # interior epochs where data is informative
    np.testing.assert_allclose(rates[1:4], lam_true, rtol=0.05)


def test_em_bootstrap_batch_consistency():
    """A replicated count matrix must give identical rates per replicate."""
    lam_true = 3e-5
    epochs_np = np.array([0.0, 1000.0, 10000.0, 1e6])
    t = age_bin_centers()
    p_shared = 1 - np.exp(-lam_true * t)
    shared = np.tile(100 * p_shared, (3, 1))
    notshared = np.tile(100 * (1 - p_shared), (3, 1))
    rates, _, iters = run_em(
        jnp.asarray(epochs_np),
        jnp.full(4, 1 / 20000.0, jnp.float64),
        jnp.asarray(shared),
        jnp.asarray(notshared),
    )
    rates = np.asarray(rates)
    np.testing.assert_array_equal(rates[0], rates[1])
    np.testing.assert_array_equal(rates[0], rates[2])


def test_run_em_f32_close_to_f64():
    """The f32 path (f32 E-step, f64 logl) must track the f64 EM."""
    import jax.numpy as jnp

    from colate_tpu.ops.em import run_em
    from colate_tpu.ops.epochs import epochs_from_bins

    g = np.random.default_rng(123)
    epochs, _ = epochs_from_bins("3,7,0.3", 28.0, 0.0)
    nb = 185
    sh = np.abs(g.normal(5.0, 2.0, (2, nb)))
    ns = np.abs(g.normal(50.0, 10.0, (2, nb)))
    init = np.full(epochs.shape, 1 / 20000.0)
    r64, l64, i64 = run_em(
        jnp.asarray(epochs), jnp.asarray(init), jnp.asarray(sh),
        jnp.asarray(ns), max_iter=1200, dtype="float64",
    )
    r32, l32, i32 = run_em(
        jnp.asarray(epochs), jnp.asarray(init), jnp.asarray(sh),
        jnp.asarray(ns), max_iter=1200, dtype="float32",
    )
    r64 = np.asarray(r64)
    r32 = np.asarray(r32)
    m = r64 > 1e-8  # ignore floor-pinned epochs
    np.testing.assert_allclose(r32[m], r64[m], rtol=5e-3)
    np.testing.assert_allclose(np.asarray(l32), np.asarray(l64), rtol=1e-5)


def test_e_step_sampled_degenerate_interval_matches_point():
    """With age_begin == age_end the sampled E-step is the point E-step."""
    import jax
    import jax.numpy as jnp

    from colate_tpu.ops.em import _e_step_all_bins, e_step_sampled
    from colate_tpu.ops.epochs import epochs_from_bins

    epochs, _ = epochs_from_bins("3,6,0.5", 28.0, 0.0)
    epochs = jnp.asarray(epochs)
    rates = jnp.full(epochs.shape, 1e-4)
    t = jnp.asarray(np.geomspace(1.0, 1e5, 32))
    k = jnp.clip(
        jnp.searchsorted(epochs, t, side="right") - 1, 0, epochs.shape[0] - 1
    ).astype(jnp.int32)
    point = _e_step_all_bins(epochs, rates, t, k)
    sampled = e_step_sampled(
        epochs, rates, jax.random.PRNGKey(0), t, t
    )
    for a, b in zip(point, sampled[:-1]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sampled[-1]), np.asarray(t))


def test_run_em_native_matches_jax_f64():
    """The host EM provider (native/em.cpp, factorised E-step) must track
    the JAX f64 EM: same iteration counts, rates to f64 round-off."""
    from colate_tpu import native
    from colate_tpu.ops.em import run_em_native
    from colate_tpu.ops.epochs import epochs_from_bins

    if native.load() is None:
        pytest.skip("native library unavailable")
    epochs_np, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    E = epochs_np.shape[0]
    g = np.random.default_rng(42)
    B = 3
    sc = g.uniform(0, 100, (B, 185))
    nc = g.uniform(0, 100, (B, 185))
    sc[:, :7] = 0.0  # empty young bins (common in real data)
    nc[:, -5:] = 0.0
    sc[2] *= 1e-6  # tiny-count replicate
    init = np.full(E, 1 / 20000.0)
    out = run_em_native(epochs_np, init, sc, nc)
    assert out is not None
    rn, ln, itn = out
    rj, lj, itj = run_em(
        jnp.asarray(epochs_np), jnp.asarray(init),
        jnp.asarray(sc), jnp.asarray(nc), dtype="float64",
    )
    rj, lj, itj = np.asarray(rj), np.asarray(lj), np.asarray(itj)
    np.testing.assert_array_equal(itn, itj)
    np.testing.assert_allclose(rn, rj, rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(ln, lj, rtol=1e-12)


def test_run_em_native_ancient_zero_epoch():
    """Epoch grids with a zeroed young epoch (ancient samples) and counts
    concentrated in old bins exercise the hazard-overflow rescale."""
    from colate_tpu import native
    from colate_tpu.ops.em import run_em_native

    if native.load() is None:
        pytest.skip("native library unavailable")
    epochs_np = np.array([0.0, 100.0, 1000.0, 5000.0, 50000.0, 1e6, 1e8 / 28.0])
    E = epochs_np.shape[0]
    t = age_bin_centers()
    # strong signal: high rates force huge cumulative hazards at old ages
    p = 1 - np.exp(-np.minimum(5e-3 * t, 700))
    sc = (500 * p)[None, :]
    nc = (500 * (1 - p))[None, :]
    init = np.full(E, 1 / 200.0)  # large initial rate -> immediate overflow risk
    out = run_em_native(epochs_np, init, sc, nc)
    assert out is not None
    rn, ln, itn = out
    rj, lj, itj = run_em(
        jnp.asarray(epochs_np), jnp.asarray(init),
        jnp.asarray(sc), jnp.asarray(nc), dtype="float64",
    )
    rj = np.asarray(rj)
    assert np.all(np.isfinite(rn))
    np.testing.assert_array_equal(itn, np.asarray(itj))
    np.testing.assert_allclose(rn, rj, rtol=1e-8)
