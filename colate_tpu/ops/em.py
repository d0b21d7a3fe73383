"""Vectorised EM for piecewise-constant coalescence rates.

Reimplements the numerics of the reference's ``coal_EM::EM_shared`` /
``EM_notshared`` (coal/coal_EM.cpp:153-468) for the point-age case — the
only case mode `mut` exercises (coal.cpp:3708/3721 pass the same age for
begin and end) — as dense JAX math over [bootstrap, age_bin, epoch]
tensors, and runs the reference's EM fixed-point loop (coal.cpp:3675-3825)
as one ``lax.while_loop`` with per-replicate convergence freezing.

Math.  With epochs t_0=0 < ... < t_{E-1} (last open-ended) and rates
λ_e, the coalescence time density is piecewise-exponential with
cumulative hazard H.  For a mutation of age t in epoch k:

shared (T < t):   posterior P(T∈e | T<t) and epoch exposures
                  E[min(T,t_{e+1})−t_e | T<t]⁺;  Z = 1−e^{−H(t)}
notshared (T > t): same conditioned on T > t;     Z = e^{−H(t)}

Instead of the reference's guarded log-space chains we evaluate the
closed forms in linear f64 with `expm1` stabilisation:

  P_e  = S_e·(1−e^{−λΔ})               (S_e = e^{−H_e})
  T1_e = E[T·1{T∈e}] = S_e·((t_{e+1}+1/λ)(1−e^{−λΔ}) − Δ)

which stay accurate both for λΔ → 0 and λΔ → ∞.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from colate_tpu.config import (
    COAL_RATE_FLOOR,
    EM_CONV_RATIO,
    EM_MAX_ITER,
    EM_MIN_ITER,
    INITIAL_COAL_RATE,
    age_bin_centers,
)


class EMResult(NamedTuple):
    rates: np.ndarray  # [B, E]
    logl: np.ndarray  # [B]
    iterations: np.ndarray  # [B] iteration count at convergence


def _epoch_tables(epochs, rates):
    """Per-epoch survival tables; epochs [E], rates [E] -> dict of [E]."""
    import jax.numpy as jnp

    lam = rates
    dt = jnp.diff(epochs)  # [E-1]
    dH = lam[:-1] * dt
    H = jnp.concatenate([jnp.zeros((1,), epochs.dtype), jnp.cumsum(dH)])  # [E]
    S = jnp.exp(-H)
    em1 = -jnp.expm1(-dH)  # 1 - exp(-dH), accurate for small dH
    inv_lam = jnp.where(lam > 0, 1.0 / jnp.where(lam > 0, lam, 1.0), 0.0)
    # last (open-ended) epoch carries mass only if its rate is positive
    # (reference get_AB: coal_EM.cpp:134-147 sets A=B=log(0) for rate 0)
    P = jnp.concatenate([S[:-1] * em1, jnp.where(lam[-1] > 0, S[-1], 0.0)[None]])
    T1_body = S[:-1] * ((epochs[1:] + inv_lam[:-1]) * em1 - dt)
    T1_last = (epochs[-1] + inv_lam[-1]) * S[-1]
    T1 = jnp.concatenate(
        [jnp.where(lam[:-1] > 0, T1_body, 0.0), jnp.where(lam[-1] > 0, T1_last, 0.0)[None]]
    )
    return dict(lam=lam, dt=dt, H=H, S=S, P=P, T1=T1, inv_lam=inv_lam)


def _gdiv(lam, x):
    """g(x)/λ with g(x) = 1 − (1+x)e^{−x} and x = λ·width, evaluated
    stably: the naive em1 − x·e^{−x} loses all precision for small x
    (both terms ~x, difference ~x²/2); the series takes over below 0.1
    (truncation ≤ x⁴/72 ≈ 1.4e-6 relative at the switch, far inside the
    f32 working precision this path serves)."""
    import jax.numpy as jnp

    small = x < 0.5
    xs = jnp.where(small, x, 0.0)
    # g(x) = sum_{n>=2} (-1)^n x^n (n-1)/n!; through x^8 the truncation
    # at x=0.5 is ~5e-7 relative — below f32 working precision
    g_small = xs * xs * (
        0.5
        + xs * (-1.0 / 3.0
                + xs * (0.125
                        + xs * (-1.0 / 30.0
                                + xs * (1.0 / 144.0
                                        + xs * (-1.0 / 840.0
                                                + xs * (1.0 / 5760.0))))))
    )
    xb = jnp.where(small, 1.0, x)
    g_big = -jnp.expm1(-xb) - xb * jnp.exp(-xb)
    g = jnp.where(small, g_small, g_big)
    return jnp.where(lam > 0, g / jnp.where(lam > 0, lam, 1.0), 0.0)


def _e_step_all_bins(epochs, rates, t, k):
    """E-step for all age bins at once.

    epochs [E], rates [E], t [nb] point ages, k [nb] epoch index of t.
    Returns (num_s, den_s, logl_s, num_n, den_n, logl_n):
    [nb, E] x2, [nb], [nb, E] x2, [nb].

    In float32 the per-epoch exposure is computed by the cancellation-
    free identity T1_e − t_e·P_e = S_e·g(λΔ)/λ (see :func:`_gdiv`) —
    the naive difference loses ~λ·t_e relative digits, which is what
    produced the round-3 0.9% tail error on rates ≥ 1e6.  The f64 path
    keeps the original expressions bit-for-bit (mc_parity byte
    identity depends on it).
    """
    import jax.numpy as jnp

    E = epochs.shape[0]
    tab = _epoch_tables(epochs, rates)
    lam_k = tab["lam"][k]  # [nb]
    inv_lam_k = tab["inv_lam"][k]
    H_k = tab["H"][k]
    S_k = tab["S"][k]
    t_k = epochs[k]
    dH_lo = lam_k * (t - t_k)
    H_t = H_k + dH_lo
    S_t = jnp.exp(-H_t)
    em1_lo = -jnp.expm1(-dH_lo)

    e_idx = jnp.arange(E)
    m_lt = e_idx[None, :] < k[:, None]  # [nb, E]
    m_eq = e_idx[None, :] == k[:, None]
    m_le = m_lt | m_eq
    m_gt = e_idx[None, :] > k[:, None]

    dt_full = jnp.concatenate([tab["dt"], jnp.zeros((1,), epochs.dtype)])  # [E]

    # ---------- shared: T < t ----------
    Pk_minus = S_k * em1_lo
    T1k_minus = jnp.where(
        lam_k > 0, S_k * ((t + inv_lam_k) * em1_lo - (t - t_k)), 0.0
    )
    num_lin = tab["P"][None, :] * m_lt + Pk_minus[:, None] * m_eq
    T1v = tab["T1"][None, :] * m_lt + T1k_minus[:, None] * m_eq
    Z_s = -jnp.expm1(-H_t)  # 1 - S_t
    guard_s = Z_s > 0
    zinv = jnp.where(guard_s, 1.0 / jnp.where(guard_s, Z_s, 1.0), 0.0)
    post = num_lin * zinv[:, None]
    texp = T1v * zinv[:, None]
    # remaining conditional mass above epoch e — as the SUFFIX sum of the
    # nonnegative per-epoch masses, never as 1-cumsum: the complement
    # cancels catastrophically once the cumulative hazard is large, and
    # dt_e amplifies the noise (the reference's log-space A/B integrals
    # are immune; this is the linear-space equivalent)
    srev = jnp.flip(jnp.cumsum(jnp.flip(num_lin, 1), axis=1), 1)
    integ = (srev - num_lin) * zinv[:, None]
    if epochs.dtype == jnp.float32:
        # cancellation-free exposure (see docstring): full epochs e<k,
        # the partial event epoch e==k, and the open last epoch
        lam_full32 = tab["lam"]
        D_body = tab["S"][:-1] * _gdiv(lam_full32[:-1], lam_full32[:-1] * tab["dt"])
        D_last = jnp.where(
            lam_full32[-1] > 0, tab["inv_lam"][-1] * tab["S"][-1], 0.0
        )
        D_full = jnp.concatenate([D_body, D_last[None]])  # [E]
        Dk_minus = S_k * _gdiv(lam_k, dH_lo)
        Dv = D_full[None, :] * m_lt + Dk_minus[:, None] * m_eq
        den = Dv * zinv[:, None] + dt_full[None, :] * integ
    else:
        den = texp - epochs[None, :] * post + dt_full[None, :] * integ
    # open-ended last epoch has no tail term (dt_full[-1]=0 handles it);
    # epochs beyond k are untouched by the reference (stay 0)
    den = jnp.where(m_le, den, 0.0)
    den = jnp.clip(den, 0.0, None)
    num_s = jnp.where(guard_s[:, None], post, 0.0)
    den_s = jnp.where(guard_s[:, None], den, 0.0)
    logl_s = jnp.where(guard_s, jnp.log(jnp.where(guard_s, Z_s, 1.0)), 0.0)

    # ---------- notshared: T > t ----------
    # Every term is a ratio with Z_n = S_t = e^{-H_t}; computing in
    # hazard-relative space (factor e^{-H_t} out analytically) keeps the
    # posterior exact even when H_t is far past the f64 underflow point —
    # the reference survives there only because it works in log space.
    lam_full = tab["lam"]
    dH_hi = jnp.where(k < E - 1, lam_k * (epochs[jnp.minimum(k + 1, E - 1)] - t), 0.0)
    em1_hi = -jnp.expm1(-dH_hi)
    t_k1 = epochs[jnp.minimum(k + 1, E - 1)]
    # relative survival at epoch starts: Srel_e = e^{-(H_e - H_t)} for e > k
    G = tab["H"][None, :] - H_t[:, None]
    Srel = jnp.exp(-jnp.where(m_gt, G, 0.0))
    em1_full = jnp.concatenate([-jnp.expm1(-tab["lam"][:-1] * tab["dt"]), jnp.ones((1,), epochs.dtype)])
    P_rel = jnp.where(
        (e_idx[None, :] == E - 1),
        jnp.where(lam_full[None, :] > 0, Srel, 0.0),
        Srel * em1_full[None, :],
    )
    T1_rel_body = Srel * (
        (jnp.append(epochs[1:], 0.0)[None, :] + tab["inv_lam"][None, :]) * em1_full[None, :]
        - dt_full[None, :]
    )
    T1_rel_last = (epochs[-1] + tab["inv_lam"][-1]) * Srel
    T1_rel = jnp.where(
        (e_idx[None, :] == E - 1), T1_rel_last, T1_rel_body
    )
    T1_rel = jnp.where(lam_full[None, :] > 0, T1_rel, 0.0)

    Pk_plus = jnp.where(k < E - 1, em1_hi, jnp.where(lam_k > 0, 1.0, 0.0))
    T1k_plus_body = jnp.where(
        lam_k > 0, (t_k1 + inv_lam_k) * em1_hi - (t_k1 - t), 0.0
    )
    T1k_plus_last = jnp.where(lam_k > 0, t + inv_lam_k, 0.0)
    T1k_plus = jnp.where(k < E - 1, T1k_plus_body, T1k_plus_last)

    raw_n = Pk_plus[:, None] * m_eq + P_rel * m_gt
    raw_t = T1k_plus[:, None] * m_eq + T1_rel * m_gt
    # normalise by the total absorbed mass, like the reference's
    # logsumexp normalising constant (Z/S_t; exactly 1 unless the last
    # epoch's rate is 0 and mass escapes to infinity).  Zrel==0 (no epoch
    # >= k can absorb the coalescence) zeroes everything, matching the
    # reference's log(0) normalising-constant branch.
    zrel = jnp.sum(raw_n, axis=1)
    guard_n = zrel > 0
    zrel_inv = jnp.where(guard_n, 1.0 / jnp.where(guard_n, zrel, 1.0), 0.0)
    post_n = raw_n * zrel_inv[:, None]
    texp_n = raw_t * zrel_inv[:, None]
    # suffix-sum form for the same reason as the shared branch; for
    # epochs below k the full zrel suffix recovers integ=1 (epoch-width
    # denominators, coal_EM.cpp:437-440)
    srev_n = jnp.flip(jnp.cumsum(jnp.flip(raw_n, 1), axis=1), 1)
    integ_n = (srev_n - raw_n) * zrel_inv[:, None]
    if epochs.dtype == jnp.float32:
        # stable exposures: e>k full epochs Srel·g(λΔ)/λ (inv·Srel for
        # the open one), event epoch g(λ(t_{k+1}−t))/λ + (t−t_k)·em1_hi
        D_rel_body = Srel * _gdiv(lam_full[None, :], lam_full[None, :] * dt_full[None, :])
        D_rel_last = jnp.where(lam_full[-1] > 0, tab["inv_lam"][-1] * Srel, 0.0)
        D_rel = jnp.where((e_idx[None, :] == E - 1), D_rel_last, D_rel_body)
        Dk_plus_body = _gdiv(lam_k, dH_hi) + (t - t_k) * em1_hi
        Dk_plus_last = jnp.where(lam_k > 0, (t - t_k) + inv_lam_k, 0.0)
        Dk_plus = jnp.where(k < E - 1, Dk_plus_body, Dk_plus_last)
        Dv_n = Dk_plus[:, None] * m_eq + D_rel * m_gt
        den_n = Dv_n * zrel_inv[:, None] + dt_full[None, :] * integ_n
    else:
        den_n = texp_n - epochs[None, :] * post_n + dt_full[None, :] * integ_n
    den_n = jnp.clip(den_n, 0.0, None)
    num_n = jnp.where(guard_n[:, None], post_n, 0.0)
    den_n = jnp.where(guard_n[:, None], den_n, 0.0)
    # reference normalising constant = log(absorbed mass) = log(zrel) - H_t
    logl_n = jnp.where(guard_n, jnp.log(jnp.where(guard_n, zrel, 1.0)) - H_t, 0.0)

    return num_s, den_s, logl_s, num_n, den_n, logl_n


def e_step_interval(epochs, rates, age_begin, age_end):
    """Analytic E-step for *interval* mutation ages t ~ U[a, b].

    The reference's ``EM_shared(age_begin, age_end, ...)`` /
    ``EM_notshared`` integrate the uniform age prior analytically
    (coal_EM.cpp:217-231); mode `mut` only ever calls the point-age case
    (a == b, handled by the vectorised ``_e_step_all_bins``), so this
    host-side f64 implementation exists for API parity and is verified
    against the exact mpmath oracle (tests/helpers/em_oracle.py).

    epochs [E], rates [E] (all > 0), age_begin/age_end [nb] with
    age_begin <= age_end.  Returns (num_s, den_s, logl_s, num_n, den_n,
    logl_n): [nb, E] x2, [nb], [nb, E] x2, [nb] — num = posterior epoch
    mass, den = conditional epoch exposure E[(min(T,t_{e+1})-t_e)^+],
    logl = log P(event); all-zero rows where P(event) == 0.
    """
    epochs = np.asarray(epochs, np.float64)
    rates = np.asarray(rates, np.float64)
    a_arr = np.asarray(age_begin, np.float64)
    b_arr = np.asarray(age_end, np.float64)
    E = epochs.shape[0]
    nb = a_arr.shape[0]
    out = [np.zeros((nb, E)) for _ in range(4)]
    logl = [np.zeros(nb), np.zeros(nb)]

    def moments(lam, Hlo, lo, hi):
        """(I0, I1, I2) of ∫ T^k λ e^{-H(T)} dT over [lo, hi] (hi may be
        inf), expm1-stabilised like _epoch_tables."""
        S = np.exp(-Hlo)
        inv = 1.0 / lam
        if np.isinf(hi):
            return (
                S,
                (lo + inv) * S,
                (lo * lo + 2 * lo * inv + 2 * inv * inv) * S,
            )
        d = hi - lo
        x = lam * d
        if x < 1e-4:
            # Taylor in λ: the closed forms cancel catastrophically here
            # (terms ~2/λ² against a result ~λd³); truncation O(x^3)
            i0 = S * lam * d * (1 - x / 2 + x * x / 6)
            i1 = S * lam * (
                lo * d + d * d / 2
                - lam * (lo * d * d / 2 + d**3 / 3)
                + lam * lam * (lo * d**3 / 6 + d**4 / 8)
            )
            i2 = S * lam * (
                (lo * lo * d + lo * d * d + d**3 / 3)
                - lam * (lo * lo * d * d / 2 + 2 * lo * d**3 / 3 + d**4 / 4)
                + lam * lam * (lo * lo * d**3 / 6 + lo * d**4 / 4 + d**5 / 10)
            )
            return i0, i1, i2
        edl = np.exp(-x)
        em1 = -np.expm1(-x)
        i0 = S * em1
        # (lo+inv)S(lo) - (hi+inv)S(hi), grouped so the small-λd
        # cancellation stays bounded (the x < 1e-4 branch covers the rest)
        i1 = S * ((lo + inv) * em1 - d * edl)
        i2 = S * (
            (lo * lo + 2 * lo * inv + 2 * inv * inv) * em1
            - d * (lo + hi + 2 * inv) * edl
        )
        return i0, i1, i2

    for i in range(nb):
        a, b = float(a_arr[i]), float(b_arr[i])
        point = a == b
        bounds = np.unique(np.concatenate([epochs, [a, b]]))
        pieces = []  # (lo, hi, epoch k)
        for j in range(bounds.shape[0] - 1):
            lo, hi = float(bounds[j]), float(bounds[j + 1])
            if hi <= lo:
                continue
            k = int(np.searchsorted(epochs, lo, side="right") - 1)
            pieces.append((lo, hi, k))
        pieces.append((float(bounds[-1]), np.inf, E - 1))

        H = 0.0
        prev, prev_k = 0.0, 0
        width = b - a
        Hs = []
        for lo, hi, k in pieces:
            H += rates[prev_k] * (lo - prev)
            Hs.append(H)
            prev, prev_k = lo, k

        # hazard at a: notshared mass lives above a, so factoring
        # e^{-H(a)} out keeps Z representable at extreme hazards (the
        # point-age path does the same in hazard-relative space; the
        # reference survives there via log space)
        H_a = 0.0
        for (lo, hi, k), Hlo in zip(pieces, Hs):
            if lo <= a:
                H_a = Hlo + rates[k] * (a - lo)

        for side, shared in ((0, True), (1, False)):
            Href = 0.0 if shared else H_a
            Z = 0.0
            mass = np.zeros(E)
            expo = np.zeros(E)
            for (lo, hi, k), Hlo_abs in zip(pieces, Hs):
                Hlo = Hlo_abs - Href
                # w(T) = c0 + c1 T on this piece
                if point:
                    inside = (hi <= a) if shared else (lo >= a)
                    if not inside:
                        continue
                    c0, c1 = 1.0, 0.0
                elif shared:
                    if lo >= b:
                        continue
                    c0, c1 = (1.0, 0.0) if hi <= a else (b / width, -1.0 / width)
                else:
                    if hi <= a:
                        continue
                    c0, c1 = (1.0, 0.0) if lo >= b else (-a / width, 1.0 / width)
                i0, i1, i2 = moments(rates[k], Hlo, lo, hi)
                m = c0 * i0 + c1 * i1
                Z += m
                mass[k] += m
                # exposure: epochs e < k get the full width, e == k the
                # in-epoch part (T - t_e), e > k nothing
                if k > 0:
                    expo[:k] += (epochs[1 : k + 1] - epochs[:k]) * m
                expo[k] += (c0 * i1 + c1 * i2) - epochs[k] * m
            if Z > 0:
                out[2 * side][i] = mass / Z
                out[2 * side + 1][i] = np.maximum(expo, 0.0) / Z
                logl[side][i] = np.log(Z) - Href

    return out[0], out[1], logl[0], out[2], out[3], logl[1]


def e_step_sampled(epochs, rates, key, age_begin, age_end):
    """Monte-Carlo E-step: one uniform age draw per bin, then the
    point-age E-step at the sampled age.

    The reference defines this as ``EM_shared_sampled`` /
    ``EM_notshared_sampled`` (coal/coal_EM.cpp:470-770, max_iter=1) but
    never calls it from mode `mut`; it is provided for API parity and
    for MC cross-checks of the analytic binning.  Returns the same
    six-tuple as the deterministic E-step plus the sampled ages.
    """
    import jax
    import jax.numpy as jnp

    u = jax.random.uniform(key, age_begin.shape, dtype=epochs.dtype)
    t = age_begin + u * (age_end - age_begin)
    k = jnp.clip(
        jnp.searchsorted(epochs, t, side="right") - 1, 0, epochs.shape[0] - 1
    ).astype(jnp.int32)
    return _e_step_all_bins(epochs, rates, t, k) + (t,)


def _m_step(rates_old, num_tot, den_tot):
    """Reference rate update (coal.cpp:3775-3815): num==0 copies the
    previous epoch's *new* rate (0 for epoch 0); den==0 keeps the old
    rate; otherwise num/den floored at 5e-9.

    The num==0 cascade is a fill-forward, vectorised as a running-max of
    the last index with num!=0 followed by a gather — no sequential scan
    (a length-E lax.scan inside the EM while-loop would cost E tiny
    sequential kernels per iteration)."""
    import jax
    import jax.numpy as jnp

    E = rates_old.shape[0]
    ratio = jnp.where(den_tot > 0, num_tot / jnp.where(den_tot > 0, den_tot, 1.0), 0.0)
    ratio = jnp.maximum(ratio, COAL_RATE_FLOOR)
    chosen = jnp.where(den_tot == 0, rates_old, ratio)  # value if num!=0
    has = num_tot != 0
    idx = jax.lax.cummax(jnp.where(has, jnp.arange(E, dtype=jnp.int32), -1))
    # epochs before the first num!=0 copy the implicit prev_new=0
    return jnp.where(idx >= 0, chosen[jnp.maximum(idx, 0)], 0.0)


def run_em_native(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    max_iter: int = EM_MAX_ITER,
    min_iter: int = EM_MIN_ITER,
):
    """Host (C++) EM — the latency-bound execution provider.

    Same fixed point and stopping rule as :func:`run_em`, evaluated in
    f64 with an O(bins+epochs) factorised E-step (native/em.cpp).  A
    B=1 EM is ~1000 sequential iterations over tiny tensors — pure
    dispatch latency on an accelerator — so small-B runs go here and
    large bootstrap batches / mesh-sharded runs use the JAX path.
    Returns (rates [B,E], logl [B], iters [B]) or None when the native
    library is unavailable."""
    import ctypes

    from colate_tpu import native

    lib = native.load()
    if lib is None:
        return None
    epochs = np.ascontiguousarray(epochs, np.float64)
    E = epochs.shape[0]
    sc = np.ascontiguousarray(shared_counts, np.float64)
    nc = np.ascontiguousarray(notshared_counts, np.float64)
    B, nbins = sc.shape
    t = np.ascontiguousarray(age_bin_centers(), np.float64)
    k = np.clip(
        np.searchsorted(epochs, t, side="right") - 1, 0, E - 1
    ).astype(np.int32)
    init = np.ascontiguousarray(init_rates, np.float64)
    out_r = np.zeros((B, E), np.float64)
    out_l = np.zeros(B, np.float64)
    out_i = np.zeros(B, np.int32)
    p = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.cn_em_run(
        p(epochs), E, p(init), p(sc), p(nc), B, nbins, p(t), p(k),
        int(max_iter), int(min_iter), float(EM_CONV_RATIO), float(COAL_RATE_FLOOR),
        p(out_r), p(out_l), p(out_i),
    )
    return out_r, out_l, out_i


@functools.partial(
    __import__("jax").jit,
    static_argnames=(
        "max_iter", "min_iter", "dtype", "check_every", "return_state"
    ),
)
def run_em(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    max_iter: int = EM_MAX_ITER,
    min_iter: int = EM_MIN_ITER,
    dtype: str | None = None,
    check_every: int | None = None,
    resume_state=None,
    return_state: bool = False,
):
    """EM to convergence for all bootstrap replicates in parallel.

    epochs [E]; init_rates [E]; shared/notshared_counts [B, nbins].
    Returns (rates [B,E], logl [B], iters [B]).

    Each replicate runs the reference's loop: E-step over the 185 point
    ages, count-weighted accumulation, rate update, stop when
    logl/prev_logl > 1-1e-7 after >1000 iterations.  Replicates freeze
    once converged (the reference runs them sequentially to their own
    stopping points).

    ``dtype`` selects the E-step working precision: "float64" (default;
    reference-parity numerics) or "float32" (opt-in, under the tiered
    contract of tests/test_em_f32.py).  The count-weighted contractions
    run at ``Precision.HIGHEST`` so an f32 run never drops to a
    reduced-precision matrix unit.  The log-likelihood driving the
    1-1e-7 convergence ratio always accumulates in f64.

    ``check_every`` (default: 1 in f64/parity mode, 8 in the f32 path)
    unrolls that many EM iterations per while-loop step and tests
    convergence only at chunk boundaries — each loop step has a fixed
    latency, so amortising it across K unrolled iterations pays off for
    the tiny [B,185,E] tensors.  The per-chunk threshold is scaled to
    K·(1−ratio): EM improvements decrease monotonically, so the chunked
    rule stops within K iterations of the reference's per-iteration rule
    (identical fixed point; parity mode keeps K=1 for bit-exactness).
    """
    import jax
    import jax.numpy as jnp

    wdt = jnp.float64 if dtype in (None, "float64") else jnp.float32
    f64 = jnp.float64
    B = shared_counts.shape[0]
    E = epochs.shape[0]
    # epoch assignment of the age-bin centres stays f64 (bin boundaries)
    t64 = jnp.asarray(age_bin_centers(), dtype=epochs.dtype)
    k = jnp.searchsorted(epochs, t64, side="right") - 1
    k = jnp.clip(k, 0, E - 1).astype(jnp.int32)
    t = t64.astype(wdt)
    epochs_w = epochs.astype(wdt)
    sc = shared_counts.astype(wdt)
    nc = notshared_counts.astype(wdt)

    e_step_b = jax.vmap(lambda r: _e_step_all_bins(epochs_w, r, t, k))

    hi = jax.lax.Precision.HIGHEST

    def iteration(rates):
        num_s, den_s, logl_s, num_n, den_n, logl_n = e_step_b(rates)
        num_tot = jnp.einsum(
            "bn,bne->be", sc, num_s, precision=hi
        ) + jnp.einsum("bn,bne->be", nc, num_n, precision=hi)
        den_tot = jnp.einsum(
            "bn,bne->be", sc, den_s, precision=hi
        ) + jnp.einsum("bn,bne->be", nc, den_n, precision=hi)
        ll = jnp.einsum(
            "bn,bn->b", sc, logl_s, precision=hi, preferred_element_type=f64
        ) + jnp.einsum(
            "bn,bn->b", nc, logl_n, precision=hi, preferred_element_type=f64
        )
        new_rates = jax.vmap(_m_step)(rates, num_tot, den_tot)
        return new_rates, ll

    K = check_every
    if K is None:
        K = 1 if wdt == jnp.float64 else 8
    # per-chunk convergence ratio: K iterations of improvement each below
    # (1-EM_CONV_RATIO) compound to at most K*(1-EM_CONV_RATIO)
    conv_ratio = 1.0 - K * (1.0 - EM_CONV_RATIO)

    def cond(state):
        it, rates, ll_prev, conv, iters = state
        return (it < max_iter) & ~jnp.all(conv)

    def body(state):
        it, rates, ll_prev, conv, iters = state
        if K == 1:
            new_rates, ll = iteration(rates)
        else:
            new_rates = rates
            for _ in range(K - 1):
                new_rates, _ = iteration(new_rates)
            new_rates, ll = iteration(new_rates)
        ratio = ll / ll_prev  # both negative; -inf prev -> ratio <= 0
        newly = (ratio > conv_ratio) & (it + K - 1 > min_iter)
        rates = jnp.where(conv[:, None], rates, new_rates)
        ll_out = jnp.where(conv, ll_prev, ll)
        iters = jnp.where(conv, iters, it + K)
        conv2 = conv | (newly & ~conv)
        return (it + K, rates, ll_out, conv2, iters)

    # batch-axis carries derive from the (possibly mesh-sharded) counts so
    # their varying-across-mesh type matches the loop body's outputs when
    # run_em executes inside shard_map (bootstrap-parallel EM)
    zero_b = sc[:, 0] * 0.0
    if resume_state is None:
        state0 = (
            jnp.zeros((), jnp.int32),
            init_rates[None, :].astype(wdt) + zero_b[:, None],
            zero_b.astype(f64) - jnp.inf,
            zero_b > 1.0,
            zero_b.astype(jnp.int32),
        )
    else:
        r_it, r_rates, r_ll, r_conv, r_iters = resume_state
        state0 = (
            jnp.asarray(r_it, jnp.int32),
            jnp.asarray(r_rates, wdt),
            jnp.asarray(r_ll, f64),
            jnp.asarray(r_conv, bool),
            jnp.asarray(r_iters, jnp.int32),
        )
    it, rates, ll, conv, iters = jax.lax.while_loop(cond, body, state0)
    if return_state:
        return it, rates, ll, conv, iters
    return rates.astype(epochs.dtype), ll, iters


def run_em_sequential(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    max_iter: int = EM_MAX_ITER,
    min_iter: int = EM_MIN_ITER,
    dtype: str | None = None,
):
    """Replicate-sequential EM: ``lax.map`` of a B=1 :func:`run_em`.

    The batched path's einsum blocking makes per-replicate rounding
    depend on the local batch shape (a ~1 ulp effect), which breaks
    bitwise parity between a mesh-sharded run and a single-device run.
    Here every replicate executes the identical B=1 trace regardless of
    how many replicates share its device, so ANY bootstrap sharding is
    bitwise transparent — the property parallel/mesh.py:sharded_run_em
    and the multichip dryrun (__graft_entry__.py) rely on.  The price is
    that a device runs its replicates one after another.
    """
    import jax
    import jax.numpy as jnp

    def one(args):
        s, n = args
        r, ll, it = run_em(
            epochs, init_rates, s[None, :], n[None, :],
            max_iter=max_iter, min_iter=min_iter, dtype=dtype,
        )
        return r[0], ll[0], it[0]

    return jax.lax.map(
        one, (jnp.asarray(shared_counts), jnp.asarray(notshared_counts))
    )


def run_em_checkpointed(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    ckpt_path: str,
    fingerprint: str,
    dtype: str | None = None,
    chunk: int = 4096,
):
    """The EM fixed point with mid-run checkpointing: the while-loop is
    driven in chunks of ``chunk`` iterations, persisting the FULL loop
    state (it, rates, logl, conv, iters) to ``ckpt_path`` after each
    chunk.  A killed run resumes from the exact saved state, so the
    final ``.coal`` is identical to an uninterrupted run (the chunk
    boundary only caps the while-loop's max_iter; the per-iteration
    sequence is unchanged).  The reference's only resume seam is its
    post-parse matrix cache (coal.cpp:3169-3171) — this generalises it
    through the estimator itself (SURVEY §5).

    COLATE_EM_DIE_AFTER_CHUNKS=<k> hard-exits after the k-th checkpoint
    write (the kill-and-resume test hook).
    """
    import os

    import jax.numpy as jnp

    import numpy as _np

    wdt_name = "float64" if dtype in (None, "float64") else "float32"
    state = None
    if os.path.exists(ckpt_path):
        try:
            z = _np.load(ckpt_path, allow_pickle=False)
            if str(z["fingerprint"]) == fingerprint and str(z["dtype"]) == wdt_name:
                state = (
                    z["it"], z["rates"], z["ll"], z["conv"], z["iters"]
                )
        except Exception:
            state = None

    die_after = int(os.environ.get("COLATE_EM_DIE_AFTER_CHUNKS", "0"))
    chunk = int(os.environ.get("COLATE_EM_CKPT_CHUNK", str(chunk)))
    chunks_done = 0
    ep = jnp.asarray(epochs)
    ir = jnp.asarray(init_rates)
    sc = jnp.asarray(shared_counts)
    nc = jnp.asarray(notshared_counts)
    while True:
        it0 = 0 if state is None else int(state[0])
        bound = min(it0 + int(chunk), EM_MAX_ITER)
        out = run_em(
            ep, ir, sc, nc, max_iter=bound, dtype=dtype,
            resume_state=None if state is None else tuple(
                jnp.asarray(s) for s in state
            ),
            return_state=True,
        )
        state = tuple(_np.asarray(s) for s in out)
        done = bool(state[3].all()) or int(state[0]) >= EM_MAX_ITER
        tmp = ckpt_path + ".tmp"
        _np.savez(
            tmp if not tmp.endswith(".npz") else tmp,
            fingerprint=fingerprint, dtype=wdt_name,
            it=state[0], rates=state[1], ll=state[2], conv=state[3],
            iters=state[4],
        )
        os.replace(tmp + (".npz" if not tmp.endswith(".npz") else ""), ckpt_path)
        chunks_done += 1
        if die_after and chunks_done >= die_after and not done:
            os._exit(17)
        if done:
            break
    try:
        os.remove(ckpt_path)
    except OSError:
        pass
    rates = state[1]
    if rates.dtype != _np.asarray(epochs).dtype:
        rates = rates.astype(_np.asarray(epochs).dtype)
    return rates, state[2], state[4]
