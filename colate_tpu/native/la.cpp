// Native host kernel for the local-ancestry estimator (coal_LA).
//
// The device kernel (colate_tpu/ops/la_kernel.py) is the mesh-scale
// path; this is its one-shot host twin,
// mirroring the reference semantics of coal_tree.cpp:447-527 without
// the per-pair nested loops: subtree leaf-group counts come from one
// ascending-index pass over the parent vector, every coalescence then
// contributes its children's count outer product into the sorted group
// key, and the epoch exposure is the clipped interval overlap
// (identical to the NumPy twin's H-function evaluation, so all three
// backends agree to f64 summation noise).
//
// Unlike the NumPy path this touches no multi-MB temporaries: per-item
// scratch is one [M, G] count table reused across items, so a cold
// process pays no page-fault storm.  Items are threaded over contiguous
// ranges with per-thread [nb, E, P] accumulators merged in thread
// order (deterministic for a fixed thread count).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" void cn_la_accumulate(
    int64_t S, int64_t M, int64_t N, int64_t G, int64_t E,
    const int32_t* parent,  // [S, M]
    const double* ages,     // [S, K], K = N-1 internal-node ages
    const int32_t* lab,     // [S, N] leaf group labels
    const int32_t* c1,      // [S, K] first child of internal node
    const int32_t* c2,      // [S, K] second child
    const double* w,        // [S] item weights (span*frac/1e9)
    const int32_t* blocks,  // [S] block id in [0, nb)
    const double* epochs,   // [E]
    int64_t nb, int32_t nthreads,
    double* num, double* den)  // [nb, E, P] each, P = G*(G+1)/2
{
  const int64_t K = N - 1;
  const int64_t P = G * (G + 1) / 2;
  const int64_t cell = E * P;
  unsigned hw = std::thread::hardware_concurrency();
  int nt = nthreads > 0 ? nthreads : (int)std::max(1u, hw ? hw : 1);
  nt = (int)std::min<int64_t>(nt, std::max<int64_t>(S, 1));

  std::vector<std::vector<double>> tnum((size_t)nt), tden((size_t)nt);
  std::vector<std::thread> th;
  auto worker = [&](int ti, int64_t lo, int64_t hi) {
    std::vector<double>& anum = tnum[(size_t)ti];
    std::vector<double>& aden = tden[(size_t)ti];
    anum.assign((size_t)(nb * cell), 0.0);
    aden.assign((size_t)(nb * cell), 0.0);
    std::vector<double> C((size_t)(M * G));
    std::vector<double> cnt((size_t)P);
    for (int64_t s = lo; s < hi; s++) {
      const int32_t* par = parent + s * M;
      const int32_t* lb = lab + s * N;
      const double* ag = ages + s * K;
      const int32_t* ch1 = c1 + s * K;
      const int32_t* ch2 = c2 + s * K;
      const double ws = w[s];
      double* bnum = anum.data() + (int64_t)blocks[s] * cell;
      double* bden = aden.data() + (int64_t)blocks[s] * cell;
      std::fill(C.begin(), C.end(), 0.0);
      for (int64_t i = 0; i < N; i++) C[(size_t)(i * G + lb[i])] = 1.0;
      for (int64_t j = 0; j < M - 1; j++) {
        int32_t p = par[j];
        if (p < 0) continue;
        double* dst = C.data() + (int64_t)p * G;
        const double* src = C.data() + j * G;
        for (int64_t g = 0; g < G; g++) dst[g] += src[g];
      }
      for (int64_t k = 0; k < K; k++) {
        const double a = ag[k];
        const double* n1 = C.data() + (int64_t)ch1[k] * G;
        const double* n2 = C.data() + (int64_t)ch2[k] * G;
        int64_t ki = 0;
        for (int64_t p = 0; p < G; p++)
          for (int64_t q = 0; q <= p; q++, ki++)
            cnt[(size_t)ki] = (p == q) ? n1[p] * n2[p]
                                       : n1[p] * n2[q] + n1[q] * n2[p];
        // epoch of the event: epochs[e] < a <= epochs[e+1], ages at an
        // edge fall in the lower epoch, everything above the last edge
        // lands in the open epoch (searchsorted(epochs[1:], a, 'left')
        // clipped — the host/device oracle semantics)
        int64_t ep = 0;
        while (ep < E - 1 && a > epochs[ep + 1]) ep++;
        double* nrow = bnum + ep * P;
        for (int64_t pi = 0; pi < P; pi++) nrow[pi] += ws * cnt[(size_t)pi];
        // exposure: den[e] += cnt * (min(a, ep[e+1]) - ep[e]) while
        // positive; the final open epoch contributes 0 (reference
        // sweep stops at the last edge)
        for (int64_t e = 0; e < E - 1; e++) {
          double ov = std::min(a, epochs[e + 1]) - epochs[e];
          if (ov <= 0.0) {
            if (a <= epochs[e]) break;  // all later epochs are 0 too
            // DELIBERATE divergence from the reference: coal_tree.cpp:515
            // breaks at the FIRST zero denominator entry, so a
            // degenerate zero-width epoch below the node's age drops
            // all later epochs' exposure for that event.  Such grids
            // only arise from a hand-edited --coal file with duplicate
            // boundaries; we keep scanning so later (positive-width)
            // epochs still accrue their true exposure.  All three
            // backends (this, ops/la_kernel.py host+device) agree.
            continue;  // degenerate zero-width epoch: keep scanning
          }
          double wov = ws * ov;
          double* drow = bden + e * P;
          for (int64_t pi = 0; pi < P; pi++)
            drow[pi] += wov * cnt[(size_t)pi];
        }
      }
    }
  };
  int64_t per = (S + nt - 1) / nt;
  for (int ti = 0; ti < nt; ti++) {
    int64_t lo = (int64_t)ti * per;
    int64_t hi = std::min<int64_t>(lo + per, S);
    if (lo >= hi) { tnum[(size_t)ti].assign((size_t)(nb * cell), 0.0);
                    tden[(size_t)ti].assign((size_t)(nb * cell), 0.0);
                    continue; }
    th.emplace_back(worker, ti, lo, hi);
  }
  for (auto& t : th) t.join();
  for (int ti = 0; ti < nt; ti++) {
    const double* an = tnum[(size_t)ti].data();
    const double* ad = tden[(size_t)ti].data();
    for (int64_t i = 0; i < nb * cell; i++) {
      num[i] += an[i];
      den[i] += ad[i];
    }
  }
}
