// Deferred Crout incomplete LDU + Schur complement — production host kernel.
//
// Semantics match the annotated Python anchor hifir_tpu/alg/crout_np.py
// (behavioral target: /root/reference/src/hif/alg/factor.hpp:803-1004,
// Crout.hpp, thresholds.hpp, Schur.hpp), implemented around the stable-id
// design: ids never move; dynamic deferral only reorders the final output.
// Dual adjacency (rows-of-L / cols-of-U) replaces the reference linked lists.
// The Schur SpGEMM accumulates in long double (the reference boosts precision
// the same way, Schur.hpp:310-361).

#include "common.hpp"

// Optional prefetch look-ahead of the hot U/L row scans (build with
// -DHT_PF=16 to enable).  Default OFF since round 5: after the AMD
// assembly-tree postorder the scatter maps are cache-resident for every
// level in the tracked regime (wu/wl are 8B*n = 2-8 MB vs a 260 MB LLC on
// this host), and the per-visit prefetch instruction stream measured as a
// pure ~1 c/visit overhead (interleaved bench_crout replays of the dumped
// 1M-convdiff level 2: ut 1.16 -> 1.06 Gc with it removed).
#ifndef HT_PF
#define HT_PF 0
#endif

// Per-visit profiling counters (utV/lV/swap in the HT_PROFILE2 dump) cost
// ~1 c/visit in the hot scans even when HT_PROFILE2 is unset (the
// test+branch rides the loop); production builds compile them out.  Build
// with -DHT_PROF_VISITS for the cross-check numbers (visit counts match
// the reference's instrumented Crout.hpp; see BASELINE.md round-4).
#ifdef HT_PROF_VISITS
#define HT_VIS(expr) \
  do {               \
    if (prof2) expr; \
  } while (0)
#else
#define HT_VIS(expr)
#endif

#include <chrono>
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <type_traits>
#include <malloc.h>
#ifdef _OPENMP
#include <omp.h>
#else
// built without OpenMP: every parallel region runs on one thread, and the
// chunk loops below cover all chunks from thread 0
static inline int omp_get_thread_num() { return 0; }
static inline int omp_get_num_threads() { return 1; }
#endif
#include <atomic>
#include <thread>
#include <x86intrin.h>
#include <sys/mman.h>

// identity on real types, std::conj on complex (the Hermitian LDL^H mode
// conjugates the mirrored side; real/symmetric modes must be unchanged)
template <class T>
static inline T ht_conj(const T &x) { return x; }
template <class T>
static inline std::complex<T> ht_conj(const std::complex<T> &x) {
  return std::conj(x);
}

namespace {

// Optional (HT_MALLOC_TUNE=1): keep GB-scale level buffers in the sbrk heap
// across levels instead of glibc's mmap/munmap round trips, trading process
// RSS (stays at the factorize peak) for fewer first-touch page faults at the
// next level.  Off by default: interleaved same-phase A/B on 1M Poisson
// showed the sbrk heap *slower* in-process (34.4 vs 23.4 s cycle-matched) —
// the earlier apparent win was machine-phase noise between separate runs.
void malloc_tune_once() {
  static bool done = false;
  if (done) return;
  done = true;
  const char *e = std::getenv("HT_MALLOC_TUNE");
  if (e && e[0] == '1') {
    mallopt(M_MMAP_MAX, 0);
    mallopt(M_TRIM_THRESHOLD, -1);
  }
}

}  // namespace

// FTZ/DAZ (flush subnormals to zero) experiment toggle: the reference links
// with -ffast-math, which sets these MXCSR bits process-wide; dropped-value
// products in deep levels can hit subnormal range where IEEE handling costs
// ~100 cycles/op.  Applies to the calling thread only.
extern "C" __attribute__((visibility("default"))) void ht_set_ftz(int on) {
  unsigned csr = __builtin_ia32_stmxcsr();
  if (on)
    csr |= 0x8040u;   // FTZ | DAZ
  else
    csr &= ~0x8040u;
  __builtin_ia32_ldmxcsr(csr);
}

// runtime toggle for in-process allocator A/B experiments (glibc defaults
// restored with on=0: M_MMAP_MAX=65536, M_TRIM_THRESHOLD=128k)
extern "C" __attribute__((visibility("default"))) void ht_malloc_tune(
    int on) {
  if (on) {
    mallopt(M_MMAP_MAX, 0);
    mallopt(M_TRIM_THRESHOLD, -1);
  } else {
    mallopt(M_MMAP_MAX, 65536);
    mallopt(M_TRIM_THRESHOLD, 128 * 1024);
  }
}

namespace {

template <class VT>
struct Adj {
  // per-id adjacency (step, value) as linked lists into one arena of packed
  // nodes -- one cache line per traversal visit (the loop is miss-bound)
  struct Node {
    i32 nxt;
    i32 step;
    VT val;
  };
  std::vector<i32> head;
  std::vector<Node> pool;
  Adj() = default;
  explicit Adj(i64 n, i64 reserve_nnz) : head(n, -1) {
    pool.reserve(reserve_nnz);
  }
  // reuse across calls: keep the pool's capacity, re-init the heads
  void reset(i64 n, i64 reserve_nnz) {
    head.assign(n, -1);
    pool.clear();
    pool.reserve(reserve_nnz);
  }
  inline void add(i64 id, i32 step, VT v) {
    pool.push_back(Node{head[id], step, v});
    head[id] = (i32)(pool.size() - 1);
  }
};

template <class VT>
struct DropEnt {
  double key;
  i32 id;
  VT val;
};

// Cross-level scratch workspace for the serial Crout kernel + finalize.
//
// Production factorizations call crout_core once per level with the previous
// levels' RESULT buffers still alive (zero-copy exported to numpy), so
// per-call local vectors always sit on FRESH mmapped pages: every append in
// the hot loop pays a first-touch fault, and the measured push phases ran
// 3-4x slower in production than in warm same-process replays of the same
// level (bench/bench_crout on the dumped level-2 operator: pushes 3.5 Gc
// production-min vs 0.9 Gc warm).  Persisting the scratch across levels
// (thread_local, capacity retained) would make every level after the fattest
// run on already-touched memory, but retention was measured SLOWER on this
// hypervisor-pressured host, so the DEFAULT is release-after-each-call;
// HT_WS=1 opts in to retention (see maybe_release below).
template <class VT>
struct CroutWS {
  struct TP { i32 tag; i32 pos; };
  std::vector<i64> Cp;
  std::vector<i32> Ci;
  std::vector<VT> Cv;
  Adj<VT> rows_of_L, cols_of_U, tail_of_L;
  std::vector<VT> d;
  std::vector<unsigned char> status;
  std::vector<i64> Lptr, Uptr, Lend, Uend;
  std::vector<i32> Lids, Uids;
  std::vector<VT> Lvals, Uvals;
  std::vector<VT> dvec, kap_u, kap_l;
  std::vector<i64> deferred;
  std::vector<TP> wu, wl;
  std::vector<i32> ut_ids, l_ids;
  std::vector<VT> utv, lv;
  std::vector<DropEnt<VT>> keep;
  std::vector<i32> adjU_j, adjL_j;
  std::vector<VT> adjU_v, adjL_v;
  // finalize scratch
  std::vector<i64> posR, posC;
  std::vector<i32> pcs, upos, lpos;
  std::vector<i64> UFp, LEp;
  std::vector<i32> UFi, LEi;
  std::vector<VT> UFv, LEv;
  std::vector<i64> SloP;  // lower-triangular Schur product (symmetric levels)
  std::vector<i32> SloI;
  std::vector<VT> SloV;
  std::vector<i64> ordR;
  static CroutWS &get() {
    static thread_local CroutWS ws;
    return ws;
  }
  void maybe_release() {
    // default: RELEASE after each call.  Retaining the high-water scratch
    // across levels was measured SLOWER end-to-end on this host (interleaved
    // 1M-robust battery: retain min 17.4 s vs release min 16.0 s) — memory
    // retention draws hypervisor pressure, the same effect as the r3
    // HT_POOL/HT_MALLOC_TUNE negative results.  HT_WS=1 opts in to
    // retention for hosts where RSS is free.
    static const bool retain =
        std::getenv("HT_WS") && std::getenv("HT_WS")[0] == '1';
    if (!retain) *this = CroutWS();
  }
};

// Concurrent arena prefault: production factorizations release the Crout
// workspace after every level (retention measured slower under hypervisor
// memory pressure, see CroutWS), so each level's appends run on fresh
// zero-fill-on-demand pages and the push phases pay one page fault per 4 KB
// touched (~2x the warm cost: interleaved HT_WS=1 replays of the dumped
// 1M-convdiff level 2 show pushA+push 1.05 -> 0.55 Gc warm).  The second
// core is idle during the serial Crout loop, so a helper thread populates
// the expected-use prefix of the big arenas via MADV_POPULATE_WRITE — a
// kernel-side fault-in that never modifies already-present pages, hence
// race-free against the concurrent appends.  No-op (EINVAL) on old kernels.
#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif
struct Prefault {
  std::thread th;
  void go(std::vector<std::pair<void *, size_t>> regions) {
    if (regions.empty()) return;
    th = std::thread([regions]() {
      for (const auto &r : regions) {
        if (!r.second) continue;
        const uintptr_t a = (uintptr_t)r.first;
        const uintptr_t b = a & ~(uintptr_t)4095;
        (void)madvise((void *)b, r.second + (a - b), MADV_POPULATE_WRITE);
      }
    });
  }
  void join() {
    if (th.joinable()) th.join();
  }
  ~Prefault() { join(); }
};

// value-type tag for the C accessor dispatch (the reference instantiates
// HIF over d/z/s/c the same way, builder.hpp:109,589)
template <class VT> struct DtypeCode;
template <> struct DtypeCode<double> { static const int value = 0; };
template <> struct DtypeCode<std::complex<double>> {
  static const int value = 1;
};
template <> struct DtypeCode<float> { static const int value = 2; };
template <> struct DtypeCode<std::complex<float>> {
  static const int value = 3;
};

// common initial layout for type dispatch in the C accessors
struct ResHead {
  int dtype;  // DtypeCode of the value type
  i64 n, m;
};

template <class VT>
struct Result {
  int dtype = DtypeCode<VT>::value;
  i64 n = 0, m = 0;
  // L_B (m x m CSR strict lower), U_B (m x m CSR strict upper), S ((n-m)^2),
  // E ((n-m) x m) and F (m x (n-m)) blocks of the permuted scaled matrix
  std::vector<i64> Lp, Up, Sp, Ep, Fp;
  std::vector<i32> Li, Ui, Si, Ei, Fi;
  std::vector<VT> Lv, Uv, Sv, Ev, Fv;
  std::vector<VT> d;
  std::vector<i64> ord;      // final ordering: position -> id
  i64 stats[6] = {0, 0, 0, 0, 0, 0};  // defers, diag, cond, space, total, -
  // min/max |kappa_u|, min/max |kappa_l| over accepted steps (the
  // reference's INFO2 per-level dump, factor.hpp:1063-1110)
  double kmm[4] = {0.0, 0.0, 0.0, 0.0};
};

template <class VT>
void kappa_minmax(const std::vector<VT> &ku, const std::vector<VT> &kl,
                  double *kmm) {
  auto mm = [](const std::vector<VT> &v, double *lo, double *hi) {
    *lo = *hi = 0.0;
    bool first = true;
    for (const VT &x : v) {
      const double a = std::abs(x);
      if (first) { *lo = *hi = a; first = false; }
      else { if (a < *lo) *lo = a; if (a > *hi) *hi = a; }
    }
  };
  mm(ku, kmm, kmm + 1);
  mm(kl, kmm + 2, kmm + 3);
}

// dual dropping on a scatter-accumulated sparse vector
// (ref alg/thresholds.hpp:49,72).  The candidate ids gather their values
// into a small contiguous scratch ({|v|, id, v}) in ONE pass, and the
// space-limitation select runs on the scratch: the nth_element comparator
// touches sequential 24-byte entries instead of doing two random loads into
// the n-sized scatter workspace per comparison, and the subsequent factor
// pushes read the scratch instead of re-gathering.  Selection order (and
// therefore tie-breaking) is identical to selecting on the raw ids, so the
// kept set matches the Python anchor exactly.
// start_size > 0 charges already-committed (mirrored) entries against the
// space cap (ref apply_space_dropping start_size arg, thresholds.hpp:72-86)
template <class VT>
inline i64 drop_vec(const i32 *ids, const VT *vals, i64 cnt,
                    double tau, double kap, double alpha, i64 nnz_ref,
                    i64 &n_num, i64 &n_space,
                    std::vector<DropEnt<VT>> &scratch, i64 start_size = 0) {
  scratch.clear();
  const bool do_num = tau > 0.0 && kap > 0.0;
  const double coeff = do_num ? tau / kap : 0.0;
  for (i64 k = 0; k < cnt; ++k) {
    const VT v = vals[k];
    const double a = std::abs(v);
    if (do_num && !(a > coeff)) continue;
    scratch.push_back(DropEnt<VT>{a, ids[k], v});
  }
  n_num += cnt - (i64)scratch.size();
  i64 sz = (i64)scratch.size();
  if (alpha > 0.0) {
    i64 cap = (i64)std::ceil(alpha * (double)nnz_ref);
    if (start_size >= cap) cap = start_size + 1;
    cap -= start_size;
    if (cap < 1) cap = 1;
    if (sz > cap) {
      // deterministic total order (|v| desc, id asc) — matches the anchor's
      // lexsort so kept sets are identical even under exact-magnitude ties;
      // the kept prefix is then sorted the same way so stored row order is
      // bit-reproducible too
      auto cmp = [](const DropEnt<VT> &x, const DropEnt<VT> &y) {
        return x.key > y.key || (x.key == y.key && x.id < y.id);
      };
      std::nth_element(scratch.begin(), scratch.begin() + cap - 1,
                       scratch.end(), cmp);
      std::sort(scratch.begin(), scratch.begin() + cap, cmp);
      n_space += sz - cap;
      sz = cap;
    }
  }
  return sz;
}

template <class VT>
inline i64 drop_vec(const std::vector<i32> &ids, const std::vector<VT> &vals,
                    double tau, double kap, double alpha, i64 nnz_ref,
                    i64 &n_num, i64 &n_space,
                    std::vector<DropEnt<VT>> &scratch, i64 start_size = 0) {
  return drop_vec(ids.data(), vals.data(), (i64)ids.size(), tau, kap, alpha,
                  nnz_ref, n_num, n_space, scratch, start_size);
}


}  // namespace

namespace {

template <class VT>
void finalize_core(Result<VT> *res, i64 n, i64 m, const i64 *Ap,
                   const i32 *Ai, const VT *Av, const i64 *row_ref,
                   const i64 *col_ref, double schur_aL, double schur_aU,
                   const std::vector<i64> &ordR, const std::vector<i64> &ordC,
                   const std::vector<i64> &Lptr, const std::vector<i32> &Lids,
                   const std::vector<VT> &Lvals, const std::vector<i64> &Uptr,
                   const std::vector<i32> &Uids, const std::vector<VT> &Uvals,
                   const std::vector<VT> &dvec, bool sym = false,
                   bool herm = false) {
  const bool prof = std::getenv("HT_PROFILE") != nullptr;
  auto tprev = std::chrono::steady_clock::now();
  auto mark = [&](const char *what) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[ht_finalize] %s=%.0fms\n", what,
                 std::chrono::duration<double, std::milli>(now - tprev)
                     .count());
    tprev = now;
  };
  // position maps for (possibly distinct) row/col orderings; big scratch
  // comes from the cross-level workspace (see CroutWS)
  CroutWS<VT> &ws = CroutWS<VT>::get();
  std::vector<i64> &posR = ws.posR, &posC = ws.posC;
  posR.resize(n);
  posC.resize(n);
  for (i64 k = 0; k < n; ++k) posR[ordR[k]] = k;
  for (i64 k = 0; k < n; ++k) posC[ordC[k]] = k;
  res->ord.assign(ordR.begin(), ordR.end());
  res->ord.insert(res->ord.end(), ordC.begin(), ordC.end());
  const i64 nm0 = n - m;

  // The E/F extraction, the U split and the L split read disjoint inputs
  // and write disjoint outputs, so they run as concurrent sections (the
  // machine has >=2 cores and each block alone is single-threaded
  // counting-sort work).
  const i64 nm = n - m;
  std::vector<i64> &UFp = ws.UFp, &LEp = ws.LEp;
  std::vector<i32> &UFi = ws.UFi, &LEi = ws.LEi;
  std::vector<VT> &UFv = ws.UFv, &LEv = ws.LEv;
  UFp.assign(m + 1, 0);
  LEp.assign(nm + 1, 0);
  UFi.clear();
  LEi.clear();
  UFv.clear();
  LEv.clear();
#pragma omp parallel sections num_threads(2) if (Ap[n] > 1 << 20)
 {
#pragma omp section
 {
  // ---- E / F blocks of Ahat in final ordering (ref extract_E/F,
  // factor.hpp:185-368), assembled with counting sort, O(nnz).  The posC
  // map is gathered ONCE into a sequential i32 scratch (the gather is the
  // random-access cost; the count and fill passes then stream it).
  // Symmetric (LDL^T) levels extract only E from the tail rows and mirror
  // F = E^T by counting transpose (Ahat is exactly symmetric there). ----
  if (sym) {
    res->Ep.assign(nm0 + 1, 0);
    std::vector<i32> &pcs = ws.pcs;
    pcs.resize(Ap[n]);
    for (i64 prow = m; prow < n; ++prow) {
      const i64 arow = ordR[prow];
      i64 w = Ap[arow];
      for (i64 k = Ap[arow]; k < Ap[arow + 1]; ++k) {
        const i64 pc = posC[Ai[k]];
        pcs[w++] = (i32)pc;
        if (pc < m) ++res->Ep[prow - m + 1];
      }
    }
    for (i64 i = 0; i < nm0; ++i) res->Ep[i + 1] += res->Ep[i];
    res->Ei.resize(res->Ep[nm0]);
    res->Ev.resize(res->Ep[nm0]);
    {
      std::vector<i64> ne(res->Ep.begin(), res->Ep.end() - 1);
      struct PEnt { i32 c; VT v; };
      std::vector<PEnt> rowbuf, rowtmp;
      for (i64 prow = m; prow < n; ++prow) {
        const i64 arow = ordR[prow];
        rowbuf.clear();
        for (i64 k = Ap[arow]; k < Ap[arow + 1]; ++k) {
          const i64 pc = pcs[k];
          if (pc < m) rowbuf.push_back({(i32)pc, Av[k]});
        }
        ht::radix_sort_by_key(rowbuf.data(), (i64)rowbuf.size(), rowtmp,
                              (i32)m, [](const PEnt &e) { return e.c; });
        i64 &w = ne[prow - m];
        for (auto &e : rowbuf) {
          res->Ei[w] = e.c;
          res->Ev[w++] = e.v;
        }
      }
    }
    // F = E^T (m x nm0), rows sorted by construction
    res->Fp.assign(m + 1, 0);
    const i64 enz = res->Ep[nm0];
    for (i64 k = 0; k < enz; ++k) ++res->Fp[res->Ei[k] + 1];
    for (i64 j = 0; j < m; ++j) res->Fp[j + 1] += res->Fp[j];
    res->Fi.resize(enz);
    res->Fv.resize(enz);
    {
      std::vector<i64> nx(res->Fp.begin(), res->Fp.end() - 1);
      for (i64 i = 0; i < nm0; ++i)
        for (i64 k = res->Ep[i]; k < res->Ep[i + 1]; ++k) {
          const i64 pos = nx[res->Ei[k]]++;
          res->Fi[pos] = (i32)i;
          res->Fv[pos] = herm ? ht_conj(res->Ev[k]) : res->Ev[k];
        }
    }
  } else {
    res->Ep.assign(nm0 + 1, 0);
    res->Fp.assign(m + 1, 0);
    std::vector<i32> &pcs = ws.pcs;
    pcs.resize(Ap[n]);
    for (i64 prow = 0; prow < n; ++prow) {
      const i64 arow = ordR[prow];
      i64 w = Ap[arow];
      for (i64 k = Ap[arow]; k < Ap[arow + 1]; ++k) {
        const i64 pc = posC[Ai[k]];
        pcs[w++] = (i32)pc;
        if (prow >= m && pc < m) ++res->Ep[prow - m + 1];
        else if (prow < m && pc >= m) ++res->Fp[prow + 1];
      }
    }
    for (i64 i = 0; i < nm0; ++i) res->Ep[i + 1] += res->Ep[i];
    for (i64 i = 0; i < m; ++i) res->Fp[i + 1] += res->Fp[i];
    res->Ei.resize(res->Ep[nm0]);
    res->Ev.resize(res->Ep[nm0]);
    res->Fi.resize(res->Fp[m]);
    res->Fv.resize(res->Fp[m]);
    std::vector<i64> ne(res->Ep.begin(), res->Ep.end() - 1);
    std::vector<i64> nf(res->Fp.begin(), res->Fp.end() - 1);
    struct PEnt { i32 c; VT v; };
    std::vector<PEnt> rowbuf, rowtmp;
    for (i64 prow = 0; prow < n; ++prow) {
      const i64 arow = ordR[prow];
      rowbuf.clear();
      const bool tailrow = prow >= m;
      for (i64 k = Ap[arow]; k < Ap[arow + 1]; ++k) {
        const i64 pc = pcs[k];
        if (tailrow && pc < m) rowbuf.push_back({(i32)pc, Av[k]});
        else if (!tailrow && pc >= m) rowbuf.push_back({(i32)(pc - m), Av[k]});
      }
      ht::radix_sort_by_key(rowbuf.data(), (i64)rowbuf.size(), rowtmp,
                            (i32)(tailrow ? m : nm0),
                            [](const PEnt &e) { return e.c; });
      if (tailrow) {
        i64 &w = ne[prow - m];
        for (auto &e : rowbuf) {
          res->Ei[w] = e.c;
          res->Ev[w++] = e.v;
        }
      } else {
        i64 &w = nf[prow];
        for (auto &e : rowbuf) {
          res->Fi[w] = e.c;
          res->Fv[w++] = e.v;
        }
      }
    }
  }
 }  // omp section (E/F)
#pragma omp section
 {
  // ---- split U rows into U_B (CSR, cols < m) and U_F^T rows; L columns into
  // L_B (transposed to CSR) and L_E rows.  Symmetric (LDL^T) levels never
  // materialized U in the Crout loop: U_B = L_B^T is rebuilt by counting
  // transpose after the L split, and U_F = (dropped L_E)^T after the drop
  // (skipping the whole U split AND the U_F drop). ----
  if (!sym) {
  // U_B CSR (row per step), U_F as CSC (column j of U -> tail cols)
  res->Up.assign(m + 1, 0);
  std::vector<i32> &upos = ws.upos;  // posC gathered once (see EF note)
  upos.resize(Uptr[m]);
  for (i64 j = 0; j < m; ++j) {
    for (i64 k = Uptr[j]; k < Uptr[j + 1]; ++k) {
      const i64 pc = posC[Uids[k]];
      upos[k] = (i32)pc;
      if (pc < m)
        ++res->Up[j + 1];
      else
        ++UFp[j + 1];
    }
  }
  for (i64 j = 0; j < m; ++j) {
    res->Up[j + 1] += res->Up[j];
    UFp[j + 1] += UFp[j];
  }
  res->Ui.resize(res->Up[m]);
  res->Uv.resize(res->Up[m]);
  UFi.resize(UFp[m]);
  UFv.resize(UFp[m]);
  {
    std::vector<i64> nb(res->Up.begin(), res->Up.end() - 1);
    std::vector<i64> nf(UFp.begin(), UFp.end() - 1);
    for (i64 j = 0; j < m; ++j)
      for (i64 k = Uptr[j]; k < Uptr[j + 1]; ++k) {
        const i64 pc = upos[k];
        if (pc < m) {
          res->Ui[nb[j]] = (i32)pc;
          res->Uv[nb[j]++] = Uvals[k];
        } else {
          UFi[nf[j]] = (i32)(pc - m);
          UFv[nf[j]++] = Uvals[k];
        }
      }
  }
  // sort U_B rows by column: space dropping caps each row at
  // ceil(alpha*nnz_ref), so small cache-hot per-row sorts beat the two
  // full counting-transpose passes over m-wide scatter arrays
  {
    struct PEnt { i32 c; VT v; };
    std::vector<PEnt> rb, rbt;
    for (i64 j = 0; j < m; ++j) {
      const i64 a = res->Up[j], b = res->Up[j + 1];
      if (b - a < 2) continue;
      bool sorted = true;
      for (i64 k = a + 1; k < b; ++k)
        if (res->Ui[k] < res->Ui[k - 1]) {
          sorted = false;
          break;
        }
      if (sorted) continue;
      rb.resize(b - a);
      for (i64 k = a; k < b; ++k) rb[k - a] = {res->Ui[k], res->Uv[k]};
      ht::radix_sort_by_key(rb.data(), b - a, rbt, (i32)m,
                            [](const PEnt &e) { return e.c; });
      for (i64 k = a; k < b; ++k) {
        res->Ui[k] = rb[k - a].c;
        res->Uv[k] = rb[k - a].v;
      }
    }
  }
  }  // !sym (U split)

  // L columns -> split into L_B (m x m, want CSR) and L_E ((n-m) x m CSR)
  // first count rows
  res->Lp.assign(m + 1, 0);
  std::vector<i32> &lpos = ws.lpos;  // posR gathered once (see EF note)
  lpos.resize(Lptr[m]);
  for (i64 j = 0; j < m; ++j)
    for (i64 k = Lptr[j]; k < Lptr[j + 1]; ++k) {
      const i64 pr = posR[Lids[k]];
      lpos[k] = (i32)pr;
      if (pr < m)
        ++res->Lp[pr + 1];
      else
        ++LEp[pr - m + 1];
    }
  for (i64 i = 0; i < m; ++i) res->Lp[i + 1] += res->Lp[i];
  for (i64 i = 0; i < nm; ++i) LEp[i + 1] += LEp[i];
  res->Li.resize(res->Lp[m]);
  res->Lv.resize(res->Lp[m]);
  LEi.resize(LEp[nm]);
  LEv.resize(LEp[nm]);
  {
    std::vector<i64> nb(res->Lp.begin(), res->Lp.end() - 1);
    std::vector<i64> ne(LEp.begin(), LEp.end() - 1);
    for (i64 j = 0; j < m; ++j)  // columns in increasing step order => sorted
      for (i64 k = Lptr[j]; k < Lptr[j + 1]; ++k) {
        const i64 pr = lpos[k];
        if (pr < m) {
          res->Li[nb[pr]] = (i32)j;
          res->Lv[nb[pr]++] = Lvals[k];
        } else {
          LEi[ne[pr - m]] = (i32)j;
          LEv[ne[pr - m]++] = Lvals[k];
        }
      }
  }
  if (sym) {
    // U_B = L_B^T by counting transpose (rows come out column-sorted)
    res->Up.assign(m + 1, 0);
    const i64 lbz = res->Lp[m];
    for (i64 k = 0; k < lbz; ++k) ++res->Up[res->Li[k] + 1];
    for (i64 j = 0; j < m; ++j) res->Up[j + 1] += res->Up[j];
    res->Ui.resize(lbz);
    res->Uv.resize(lbz);
    std::vector<i64> nx(res->Up.begin(), res->Up.end() - 1);
    for (i64 i = 0; i < m; ++i)
      for (i64 k = res->Lp[i]; k < res->Lp[i + 1]; ++k) {
        const i64 pos = nx[res->Li[k]]++;
        res->Ui[pos] = (i32)i;
        res->Uv[pos] = herm ? ht_conj(res->Lv[k]) : res->Lv[k];
      }
  }
 }  // omp section (U/L splits)
 }  // omp parallel sections

  res->d = dvec;
  mark("EF_and_splits");

  // ---- L_E / U_F dropping (ref Schur.hpp:61-190); the two drops touch
  // disjoint data, so they run as concurrent sections (the reference has an
  // OpenMP variant of this too, Schur.hpp:424) ----
  if (nm) {
#pragma omp parallel sections num_threads(2) if (LEi.size() + UFi.size() > 65536)
   {
#pragma omp section
    // L_E rows: cap ceil(schur_aL * row_ref[ord[m+i]])
    if (schur_aL > 0.0) {
      std::vector<i64> newp(nm + 1, 0);
      std::vector<i32> ni;
      std::vector<VT> nv;
      ni.reserve(LEi.size());
      nv.reserve(LEv.size());
      // top-k on a contiguous scratch: an indirect nth_element comparator
      // re-gathers values at ~125 cycles/candidate; gathering {|v|, col, v}
      // once keeps the selection loop in cache
      struct Ent { double key; i32 col; VT val; };
      std::vector<Ent> sc;
      for (i64 i = 0; i < nm; ++i) {
        const i64 a = LEp[i], b = LEp[i + 1];
        i64 cap = (i64)std::ceil(schur_aL * (double)row_ref[ordR[m + i]]);
        if (cap < 1) cap = 1;
        if (b - a > cap) {
          sc.resize(b - a);
          for (i64 k = a; k < b; ++k)
            sc[k - a] = Ent{std::abs(LEv[k]), LEi[k], LEv[k]};
          // deterministic under ties (column ascending == position
          // ascending; rows are built column-sorted) -- matches the host
          // _drop_offsets total order
          auto cmp = [](const Ent &x, const Ent &y) {
            return x.key > y.key || (x.key == y.key && x.col < y.col);
          };
          std::nth_element(sc.begin(), sc.begin() + cap - 1, sc.end(), cmp);
          std::sort(sc.begin(), sc.begin() + cap,
                    [](const Ent &x, const Ent &y) { return x.col < y.col; });
          for (i64 kk = 0; kk < cap; ++kk) {
            ni.push_back(sc[kk].col);
            nv.push_back(sc[kk].val);
          }
        } else {
          for (i64 k = a; k < b; ++k) {
            ni.push_back(LEi[k]);
            nv.push_back(LEv[k]);
          }
        }
        newp[i + 1] = (i64)ni.size();
      }
      LEp.swap(newp);
      LEi.swap(ni);
      LEv.swap(nv);
    }
#pragma omp section
    // U_F columns: cap ceil(schur_aU * col_ref[ord[m+j]]); UF stored per
    // source row (CSC of U_F); dropping is per *column* of U_F == per tail
    // col.  Skipped on symmetric levels: U_F = (dropped L_E)^T is built
    // below (row_ref == col_ref and identical tie order make the two drop
    // selections exactly transposed).
    if (!sym && schur_aU > 0.0) {
      // build column-major counts of UF: column c in [0, nm)
      std::vector<i64> colcnt(nm, 0);
      for (i64 k = 0; k < (i64)UFi.size(); ++k) ++colcnt[UFi[k]];
      // select per column the cap largest: gather entries per column
      std::vector<i64> cptr(nm + 1, 0);
      for (i64 c = 0; c < nm; ++c) cptr[c + 1] = cptr[c] + colcnt[c];
      std::vector<i64> entry_of(UFi.size());
      {
        std::vector<i64> nx(cptr.begin(), cptr.end() - 1);
        for (i64 j = 0; j < m; ++j)
          for (i64 k = UFp[j]; k < UFp[j + 1]; ++k)
            entry_of[nx[UFi[k]]++] = k;
      }
      std::vector<char> kill(UFi.size(), 0);
      // contiguous {|v|, pos} scratch for the selection (see the L_E note)
      struct Ent { double key; i64 pos; };
      std::vector<Ent> sc;
      for (i64 c = 0; c < nm; ++c) {
        const i64 a = cptr[c], b = cptr[c + 1];
        i64 cap = (i64)std::ceil(schur_aU * (double)col_ref[ordC[m + c]]);
        if (cap < 1) cap = 1;
        if (b - a > cap) {
          sc.resize(b - a);
          for (i64 k = a; k < b; ++k) {
            const i64 e = entry_of[k];
            sc[k - a] = Ent{std::abs(UFv[e]), e};
          }
          // deterministic under ties (position = source row ascending) --
          // matches _drop_offsets
          auto cmp = [](const Ent &x, const Ent &y) {
            return x.key > y.key || (x.key == y.key && x.pos < y.pos);
          };
          std::nth_element(sc.begin(), sc.begin() + cap - 1, sc.end(), cmp);
          for (i64 k = cap; k < b - a; ++k) kill[sc[k].pos] = 1;
        }
      }
      // compress
      std::vector<i64> newp(m + 1, 0);
      i64 w = 0;
      for (i64 j = 0; j < m; ++j) {
        for (i64 k = UFp[j]; k < UFp[j + 1]; ++k)
          if (!kill[k]) {
            UFi[w] = UFi[k];
            UFv[w++] = UFv[k];
          }
        newp[j + 1] = w;
      }
      UFi.resize(w);
      UFv.resize(w);
      UFp.swap(newp);
    }
   }  // omp sections

    if (sym) {
      // U_F = (dropped L_E)^T in the per-source-row layout the Schur loop
      // consumes (UF[j] = {(tail row i, L_E[i,j])}, i ascending)
      const i64 lez = LEp[nm];
      UFp.assign(m + 1, 0);
      for (i64 k = 0; k < lez; ++k) ++UFp[LEi[k] + 1];
      for (i64 j = 0; j < m; ++j) UFp[j + 1] += UFp[j];
      UFi.resize(lez);
      UFv.resize(lez);
      std::vector<i64> nx(UFp.begin(), UFp.end() - 1);
      for (i64 i = 0; i < nm; ++i)
        for (i64 k = LEp[i]; k < LEp[i + 1]; ++k) {
          const i64 pos = nx[LEi[k]]++;
          UFi[pos] = (i32)i;
          UFv[pos] = herm ? ht_conj(LEv[k]) : LEv[k];
        }
    }

    mark("LE_UF_drop");
    // ---- Schur: S = Ahat[tail, tail] - L_E D U_F (ref Schur.hpp:214),
    // static row halves on two threads with per-thread accumulators,
    // TWO-PASS like the reference's symbolic+numeric split (Schur.hpp:
    // 242-361): pass 1 counts each row's unique tail columns (tags only),
    // then every row writes its sorted output DIRECTLY at its exact final
    // offset — no growable per-thread buffers (vector doubling was copying
    // the whole output multiple times) and no merge memcpy ----
    // Symmetric (LDL^T) levels compute only the LOWER triangle of
    // S = C - L_E D L_E^T (UF[j] row lists are ascending, so each (i,j)
    // pair's term range is cut at c <= i by one binary search) and mirror
    // the strict-lower entries afterwards — S comes out bit-symmetric and
    // the term count halves.
    std::vector<i64> &Sp_o = sym ? ws.SloP : res->Sp;
    std::vector<i32> &Si_o = sym ? ws.SloI : res->Si;
    std::vector<VT> &Sv_o = sym ? ws.SloV : res->Sv;
    Sp_o.assign(nm + 1, 0);
    const int nthr = nm >= 4096 ? 2 : 1;
#pragma omp parallel num_threads(nthr) if (nthr > 1)
    {
      // num_threads is a request, not a guarantee: stride the fixed row
      // chunks over the *delivered* team so a 1-thread team still covers
      // every row (output layout is identical for any team size)
      const int tid = nthr > 1 ? omp_get_thread_num() : 0;
      const int team = nthr > 1 ? omp_get_num_threads() : 1;
      // Working-precision accumulator + i32 tags: the dense scatter pair is
      // the cache-capacity bottleneck of the Schur (every product term is a
      // random RMW into acc+stag); f64+i32 halves the footprint vs the
      // reference's long-double boost (Schur.hpp:223 boost_type) and matches
      // the f64 Python anchor (_compute_schur).  Accuracy is governed by the
      // dropping thresholds (tau ~ 1e-4 rel), not the e-19 accumulator tail;
      // GMRES iteration parity (Stokes 2, 1M Poisson 39) is re-verified.
      // per-OMP-worker persistent scratch (workers are reused across
      // levels, so these stay on touched pages like the CroutWS fields)
      static thread_local std::vector<VT> acc;
      static thread_local std::vector<i32> stag, srow;
      acc.assign(nm, VT(0.0));
      stag.assign(nm, -1);
      srow.clear();
      i64 nterms = 0;
      unsigned long long cyc_a = 0, cyc_t = 0, cyc_s = 0, cyc_p = 0,
                         cyc_srt = 0, cyc_c = 0, tq = 0;
      const bool prof2s = std::getenv("HT_PROFILE2") != nullptr;
#define HTS_TIC() if (prof2s) tq = __rdtsc()
#define HTS_TOC(acc) if (prof2s) acc += __rdtsc() - tq
      // raw restrict pointers: vector indexing through aliasing-unknown
      // pointers stalls the RMW chain in the term loop
      struct SEnt { i32 c; VT v; };
      std::vector<SEnt> rowbuf, rowtmp;
      VT *HT_RESTRICT pacc = acc.data();
      i32 *HT_RESTRICT ptag = stag.data();
      const i32 *HT_RESTRICT ufi = UFi.data();
      const VT *HT_RESTRICT ufv = UFv.data();
      const i64 *HT_RESTRICT ufp = UFp.data();
      const i32 *HT_RESTRICT lei = LEi.data();
      const VT *HT_RESTRICT lev = LEv.data();
      const VT *HT_RESTRICT pdv = dvec.data();
      // ---- pass 1: symbolic row sizes (tags only) ----
      HTS_TIC();
      for (int chunk = tid; chunk < nthr; chunk += team) {
        const i64 lo = (i64)chunk * nm / nthr,
                  hi = (i64)(chunk + 1) * nm / nthr;
        for (i64 i = lo; i < hi; ++i) {
          const i64 arow = ordR[m + i];
          const i32 itag = (i32)i;
          i64 cnt = 0;
          for (i64 k = Ap[arow]; k < Ap[arow + 1]; ++k) {
            const i64 pc = posC[Ai[k]];
            if (pc >= m && (!sym || pc - m <= i)) {
              ptag[pc - m] = itag;
              ++cnt;
            }
          }
          if (sym) {
            // UF[j] lists ascend; stop at the first c > i (lower triangle)
            for (i64 k = LEp[i]; k < LEp[i + 1]; ++k) {
              const i32 j = lei[k];
              const i64 e0 = ufp[j], e1 = ufp[j + 1];
              for (i64 kk = e0; kk < e1; ++kk) {
                const i32 c = ufi[kk];
                if (c > (i32)i) break;
                if (ptag[c] != itag) {
                  ptag[c] = itag;
                  ++cnt;
                }
              }
            }
          } else {
            for (i64 k = LEp[i]; k < LEp[i + 1]; ++k) {
              const i32 j = lei[k];
              const i64 e0 = ufp[j], e1 = ufp[j + 1];
              for (i64 kk = e0; kk < e1; ++kk) {
                const i32 c = ufi[kk];
                if (ptag[c] != itag) {
                  ptag[c] = itag;
                  ++cnt;
                }
              }
            }
          }
          Sp_o[i + 1] = cnt;
        }
      }
      std::memset(stag.data(), 0xff, stag.size() * sizeof(i32));
      HTS_TOC(cyc_c);
#pragma omp barrier
#pragma omp single
      {
        for (i64 i = 0; i < nm; ++i) Sp_o[i + 1] += Sp_o[i];
        Si_o.resize(Sp_o[nm]);
        Sv_o.resize(Sp_o[nm]);
      }  // implicit barrier
      i32 *HT_RESTRICT psi = Si_o.data();
      VT *HT_RESTRICT psv = Sv_o.data();
      // ---- pass 2: numeric, written at exact final offsets ----
      for (int chunk = tid; chunk < nthr; chunk += team) {
      const i64 lo = (i64)chunk * nm / nthr, hi = (i64)(chunk + 1) * nm / nthr;
      for (i64 i = lo; i < hi; ++i) {
        srow.clear();
        const i64 arow = ordR[m + i];
        const i32 itag = (i32)i;
        HTS_TIC();
        for (i64 k = Ap[arow]; k < Ap[arow + 1]; ++k) {
          const i64 pc = posC[Ai[k]];
          if (pc >= m && (!sym || pc - m <= i)) {
            const i64 c = pc - m;
            acc[c] = Av[k];
            stag[c] = itag;
            srow.push_back((i32)c);
          }
        }
        HTS_TOC(cyc_a);
        HTS_TIC();
        if (sym) {
          for (i64 k = LEp[i]; k < LEp[i + 1]; ++k) {
            const i32 j = lei[k];
            const VT ldv = lev[k] * pdv[j];
            const i64 e0 = ufp[j], e1 = ufp[j + 1];
            for (i64 kk = e0; kk < e1; ++kk) {
              const i32 c = ufi[kk];
              if (c > (i32)i) break;
              ++nterms;
              if (ptag[c] != itag) {
                pacc[c] = -ldv * ufv[kk];
                ptag[c] = itag;
                srow.push_back(c);
              } else
                pacc[c] -= ldv * ufv[kk];
            }
          }
        } else {
          for (i64 k = LEp[i]; k < LEp[i + 1]; ++k) {
            const i32 j = lei[k];
            const VT ldv = lev[k] * pdv[j];
            const i64 e0 = ufp[j], e1 = ufp[j + 1];
            nterms += e1 - e0;
            for (i64 kk = e0; kk < e1; ++kk) {
              const i32 c = ufi[kk];
              if (ptag[c] != itag) {
                pacc[c] = -ldv * ufv[kk];
                ptag[c] = itag;
                srow.push_back(c);
              } else
                pacc[c] -= ldv * ufv[kk];
            }
          }
        }
        HTS_TOC(cyc_t);
        HTS_TIC();
        // gather {col, val} pairs while acc is still cache-hot, then sort
        // the compact pair buffer and write at the row's final offset
        rowbuf.resize(srow.size());
        for (size_t tpos = 0; tpos < srow.size(); ++tpos)
          rowbuf[tpos] = SEnt{srow[tpos], pacc[srow[tpos]]};
        HTS_TOC(cyc_s);
        HTS_TIC();
        ht::radix_sort_by_key(rowbuf.data(), (i64)rowbuf.size(), rowtmp,
                              (i32)nm, [](const SEnt &e) { return e.c; });
        HTS_TOC(cyc_srt);
        HTS_TIC();
        const i64 base = Sp_o[i];
        for (size_t tpos = 0; tpos < rowbuf.size(); ++tpos) {
          psi[base + tpos] = rowbuf[tpos].c;
          psv[base + tpos] = rowbuf[tpos].v;
        }
        HTS_TOC(cyc_p);
      }
      }  // chunk stride
      if (prof && nterms)
#pragma omp critical
        std::fprintf(stderr,
                     "[ht_finalize] schur_terms(t%d)=%lldM team=%d "
                     "c=%.2fGc a=%.2fGc t=%.2fGc s=%.2fGc srt=%.2fGc "
                     "p=%.2fGc\n",
                     tid, (long long)(nterms / 1000000), team, cyc_c * 1e-9,
                     cyc_a * 1e-9, cyc_t * 1e-9, cyc_s * 1e-9,
                     cyc_srt * 1e-9, cyc_p * 1e-9);
#undef HTS_TIC
#undef HTS_TOC
    }
    if (sym) {
      // mirror the strict-lower entries: full row i = [lower (c <= i),
      // sorted] ++ [mirrored (c > i) in ascending c] — concatenation stays
      // sorted and the values are bit-copied, so S is bit-symmetric.
      // Parallelized by DESTINATION row range: each thread reads the whole
      // strict-lower triangle but counts/writes only rows in its range, so
      // the ascending-source order per destination row is preserved.
      const std::vector<i64> &Lo = ws.SloP;
      const std::vector<i32> &LoI = ws.SloI;
      const std::vector<VT> &LoV = ws.SloV;
      res->Sp.assign(nm + 1, 0);
      const int mt = nm >= 4096 ? 2 : 1;
#pragma omp parallel num_threads(mt) if (mt > 1)
      {
        const int tid2 = mt > 1 ? omp_get_thread_num() : 0;
        const int team2 = mt > 1 ? omp_get_num_threads() : 1;
        for (int chunk = tid2; chunk < mt; chunk += team2) {
          const i64 lo = (i64)chunk * nm / mt, hi = (i64)(chunk + 1) * nm / mt;
          for (i64 i = lo; i < hi; ++i) res->Sp[i + 1] = Lo[i + 1] - Lo[i];
          for (i64 i = 0; i < nm; ++i)
            for (i64 k = Lo[i]; k < Lo[i + 1]; ++k) {
              const i32 c = LoI[k];
              if (c != (i32)i && c >= lo && c < hi) ++res->Sp[c + 1];
            }
        }
#pragma omp barrier
#pragma omp single
        {
          for (i64 i = 0; i < nm; ++i) res->Sp[i + 1] += res->Sp[i];
          res->Si.resize(res->Sp[nm]);
          res->Sv.resize(res->Sp[nm]);
        }  // implicit barrier
        for (int chunk = tid2; chunk < mt; chunk += team2) {
          const i64 lo = (i64)chunk * nm / mt, hi = (i64)(chunk + 1) * nm / mt;
          for (i64 i = lo; i < hi; ++i) {
            i64 w2 = res->Sp[i];
            for (i64 k = Lo[i]; k < Lo[i + 1]; ++k) {
              res->Si[w2] = LoI[k];
              res->Sv[w2++] = LoV[k];
            }
          }
          // append mirrored entries after each destination row's lower part
          std::vector<i64> nx(hi - lo);
          for (i64 c = lo; c < hi; ++c)
            nx[c - lo] = res->Sp[c] + (Lo[c + 1] - Lo[c]);
          for (i64 i = 0; i < nm; ++i)
            for (i64 k = Lo[i]; k < Lo[i + 1]; ++k) {
              const i32 c = LoI[k];
              if (c != (i32)i && c >= lo && c < hi) {
                res->Si[nx[c - lo]] = (i32)i;
                res->Sv[nx[c - lo]++] = herm ? ht_conj(LoV[k]) : LoV[k];
              }
            }
        }
      }
    }
    mark("Schur");
  } else {
    res->Sp.assign(1, 0);
  }
}


// ---- dual-thread general-LDU Crout loop -------------------------------
//
// Thread 0 (caller) owns the U side: kappa_u, the ut compute/scale/drop,
// U storage, cols_of_U appends, kap_u, status/deferred bookkeeping and
// reading d.  Thread 1 (worker) owns the L side: kappa_l, the l
// compute, the trailing-diagonal update (the only writer of d), scale/
// drop of l, L storage, rows_of_L appends and kap_l.  Per step there are
// three release/acquire points: T0 publishes {status of the previous
// step, ku} -> T1 publishes kl -> T0 publishes the scaled ut -> T1
// signals step completion.  Cross-thread reads are safe because (a) each
// adjacency pool is appended by exactly one thread and hard-reserved to
// the space-dropping cap sum, so nodes never move under the other
// thread's walk, (b) Adj::add prepends by replacing the head only --
// existing nodes are immutable -- and the walked head (id = idk) is
// never appended to (idk is excluded from both kept vectors), and (c)
// dvec/kap arrays are reserved to m2 upfront.  Operation order inside
// each vector is identical to the serial kernel, so the factorization is
// bit-identical to crout_core (asserted by tests).
template <class VT>
void *crout_core_mt(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                    const VT *Av, const VT *d0, double kappa_d,
                    double kappa, double tau_L, double tau_U, double alpha_L,
                    double alpha_U, const i64 *row_ref, const i64 *col_ref,
                    double schur_aL, double schur_aU) {
  auto t_begin = std::chrono::steady_clock::now();
  malloc_tune_once();
  auto *res = new Result<VT>();
  res->n = n;

  std::vector<i64> Cp;
  std::vector<i32> Ci;
  std::vector<VT> Cv;
  ht::transpose_csr(n, n, Ap, Ai, Av, Cp, Ci, Cv);

  std::vector<VT> d(d0, d0 + m2);
  std::vector<unsigned char> status(n, 0);
  // hard capacity bounds from the space-dropping caps (no realloc allowed:
  // the other thread walks these pools concurrently)
  i64 cap_u_sum = 16, cap_l_sum = 16;
  for (i64 i = 0; i < m2; ++i) {
    cap_u_sum += (i64)std::ceil(alpha_U * (double)row_ref[i]);
    cap_l_sum += (i64)std::ceil(alpha_L * (double)col_ref[i]);
  }
  Adj<VT> rows_of_L(n, cap_l_sum), cols_of_U(n, cap_u_sum);

  std::vector<i64> Lptr{0}, Uptr{0};
  std::vector<i64> Lend, Uend;
  std::vector<i32> Lids, Uids;
  std::vector<VT> Lvals, Uvals;
  std::vector<VT> dvec, kap_u, kap_l;
  std::vector<i64> deferred;
  Lids.reserve(cap_l_sum);
  Lvals.reserve(cap_l_sum);
  Uids.reserve(cap_u_sum);
  Uvals.reserve(cap_u_sum);
  Lptr.reserve(m2 + 1);
  Uptr.reserve(m2 + 1);
  Lend.reserve(m2);
  Uend.reserve(m2);
  dvec.reserve(m2);
  kap_u.reserve(m2);
  kap_l.reserve(m2);
  deferred.reserve(m2);

  struct TP { i32 tag; i32 pos; };
  std::vector<TP> wu(n, TP{-1, 0}), wl(n, TP{-1, 0});
  std::vector<i32> ut_ids, l_ids;
  std::vector<VT> utv, lv;
  std::vector<DropEnt<VT>> keep0, keep1;

  // sync cells (idk-stamped, monotonically increasing)
  struct alignas(64) Cell { std::atomic<i64> v; };
  Cell c_t0{{-1}}, c_kl{{-1}}, c_utv{{-1}}, c_t1{{-1}};
  VT ku_slot = VT(0.0), kl_slot = VT(0.0);
  constexpr i64 SKIP_BIT = 1;  // c_t0.v = idk*2 | SKIP_BIT on diag-defer
  auto spin_until = [](std::atomic<i64> &a, i64 want) {
    while (a.load(std::memory_order_acquire) < want) _mm_pause();
  };

  i64 step_t0 = 0;
  i64 nnum0 = 0, nsp0 = 0, nnum1 = 0, nsp1 = 0;

  std::thread worker([&]() {
    i64 step = 0;
    for (i64 idk = 0; idk < m2; ++idk) {
      spin_until(c_t0.v, idk * 2);
      const bool diag_skip = c_t0.v.load(std::memory_order_acquire) ==
                             idk * 2 + SKIP_BIT;
      if (diag_skip) {
        c_t1.v.store(idk, std::memory_order_release);
        continue;
      }
      const VT ku = ku_slot;
      // kappa_l over rows_of_L (owned by this thread)
      VT kl = VT(1.0);
      if (step) {
        VT sum = VT(0.0);
        for (i32 e = rows_of_L.head[idk]; e >= 0; e = rows_of_L.pool[e].nxt)
          sum += kap_l[rows_of_L.pool[e].step] * rows_of_L.pool[e].val;
        const VT k1 = VT(1.0) - sum, k2 = VT(-1.0) - sum;
        kl = std::abs(k1) < std::abs(k2) ? k2 : k1;
      }
      kl_slot = kl;
      c_kl.v.store(idk, std::memory_order_release);
      if (std::abs(ku) > kappa || std::abs(kl) > kappa) {
        c_t1.v.store(idk, std::memory_order_release);
        continue;
      }
      const VT dk = d[idk];
      const i32 stp = (i32)step;

      // ---- compute l ----
      l_ids.clear();
      lv.clear();
      for (i64 k = Cp[idk]; k < Cp[idk + 1]; ++k) {
        const i32 r = Ci[k];
        if (status[r] != 1 && r != idk) {
          wl[r].tag = stp;
          wl[r].pos = (i32)l_ids.size();
          l_ids.push_back(r);
          lv.push_back(Cv[k]);
        }
      }
      for (i32 e = cols_of_U.head[idk]; e >= 0; e = cols_of_U.pool[e].nxt) {
        const i32 j = cols_of_U.pool[e].step;
        const VT du = dvec[j] * cols_of_U.pool[e].val;
        i64 k = Lptr[j], end = Lend[j];
        while (k < end) {
          const i32 r = Lids[k];
          if (HT_PF && k + HT_PF < end) __builtin_prefetch(&wl[Lids[k + HT_PF]], 1, 1);
          if (status[r] == 1) {
            --end;
            std::swap(Lids[k], Lids[end]);
            std::swap(Lvals[k], Lvals[end]);
            continue;
          }
          if (r != idk) {
            if (wl[r].tag != stp) {
              wl[r].tag = stp;
              wl[r].pos = (i32)l_ids.size();
              l_ids.push_back(r);
              lv.push_back(-du * Lvals[k]);
            } else
              lv[wl[r].pos] -= du * Lvals[k];
          }
          ++k;
        }
        Lend[j] = end;
      }

      // ---- diag update needs the scaled ut ----
      spin_until(c_utv.v, idk);
      if (ut_ids.size() <= l_ids.size()) {
        for (i64 k = 0; k < (i64)ut_ids.size(); ++k) {
          const i32 c = ut_ids[k];
          if (c < m2 && status[c] == 0 && wl[c].tag == stp)
            d[c] -= utv[k] * lv[wl[c].pos];
        }
      } else {
        for (i64 k = 0; k < (i64)l_ids.size(); ++k) {
          const i32 c = l_ids[k];
          if (c < m2 && status[c] == 0 && wu[c].tag == stp)
            d[c] -= utv[wu[c].pos] * lv[k];
        }
      }
      // true division, not reciprocal multiply: the anchor divides and a
      // 1-ulp difference here flips near-threshold drop decisions
      for (VT &v : lv) v /= dk;

      // ---- drop + push L ----
      const i64 kept = drop_vec(l_ids, lv, tau_L, std::abs(kl) * kappa_d,
                                alpha_L, col_ref[idk], nnum1, nsp1, keep1);
      for (i64 k = 0; k < kept; ++k) {
        if (k + 8 < kept)
          __builtin_prefetch(&rows_of_L.head[keep1[k + 8].id], 1, 1);
        Lids.push_back(keep1[k].id);
        Lvals.push_back(keep1[k].val);
        rows_of_L.add(keep1[k].id, stp, keep1[k].val);
      }
      Lptr.push_back((i64)Lids.size());
      Lend.push_back((i64)Lids.size());
      kap_l.push_back(kl);
      ++step;
      c_t1.v.store(idk, std::memory_order_release);
    }
  });

  // `status[idk]=1` for an accepted step is NOT published at the end of
  // the step: T1 may still be mid-step reading status[idk] in its pool-
  // compaction check, which is a data race and makes the compaction order
  // (hence l_ids append order and top-k tie-breaking) nondeterministic.
  // Publish it at the top of the NEXT iteration, after the c_t1 spin
  // guarantees T1 finished the step and before the c_t0 release store
  // makes it visible -- this also matches the serial kernel, where
  // status[idk] is still 0 during step idk's own l compute.
  i64 pending_accept = -1;
  for (i64 idk = 0; idk < m2; ++idk) {
    spin_until(c_t1.v, idk - 1);  // previous step fully done (d visible)
    if (pending_accept >= 0) {
      status[pending_accept] = 1;
      pending_accept = -1;
    }
    const VT dk = d[idk];
    if (dk == VT(0.0) || std::abs(VT(1.0) / dk) > kappa_d) {
      ++res->stats[1];
      status[idk] = 2;
      deferred.push_back(idk);
      c_t0.v.store(idk * 2 + SKIP_BIT, std::memory_order_release);
      continue;
    }
    VT ku = VT(1.0);
    if (step_t0) {
      VT sum = VT(0.0);
      for (i32 e = cols_of_U.head[idk]; e >= 0; e = cols_of_U.pool[e].nxt)
        sum += kap_u[cols_of_U.pool[e].step] * cols_of_U.pool[e].val;
      const VT k1 = VT(1.0) - sum, k2 = VT(-1.0) - sum;
      ku = std::abs(k1) < std::abs(k2) ? k2 : k1;
    }
    ku_slot = ku;
    c_t0.v.store(idk * 2, std::memory_order_release);
    spin_until(c_kl.v, idk);
    const VT kl = kl_slot;
    if (std::abs(ku) > kappa || std::abs(kl) > kappa) {
      ++res->stats[2];
      status[idk] = 2;
      deferred.push_back(idk);
      continue;  // T1 made the same decision and already moved on
    }
    const i32 stp = (i32)step_t0;

    // ---- compute ut ----
    ut_ids.clear();
    utv.clear();
    for (i64 k = Ap[idk]; k < Ap[idk + 1]; ++k) {
      const i32 c = Ai[k];
      if (status[c] != 1 && c != idk) {
        wu[c].tag = stp;
        wu[c].pos = (i32)ut_ids.size();
        ut_ids.push_back(c);
        utv.push_back(Av[k]);
      }
    }
    for (i32 e = rows_of_L.head[idk]; e >= 0; e = rows_of_L.pool[e].nxt) {
      const i32 j = rows_of_L.pool[e].step;
      const VT ld = rows_of_L.pool[e].val * dvec[j];
      i64 k = Uptr[j], end = Uend[j];
      while (k < end) {
        const i32 c = Uids[k];
        if (HT_PF && k + HT_PF < end) __builtin_prefetch(&wu[Uids[k + HT_PF]], 1, 1);
        if (status[c] == 1) {
          --end;
          std::swap(Uids[k], Uids[end]);
          std::swap(Uvals[k], Uvals[end]);
          continue;
        }
        if (c != idk) {
          if (wu[c].tag != stp) {
            wu[c].tag = stp;
            wu[c].pos = (i32)ut_ids.size();
            ut_ids.push_back(c);
            utv.push_back(-ld * Uvals[k]);
          } else
            utv[wu[c].pos] -= ld * Uvals[k];
        }
        ++k;
      }
      Uend[j] = end;
    }
    for (VT &v : utv) v /= dk;  // anchor divides (see T1 note)
    c_utv.v.store(idk, std::memory_order_release);

    // ---- drop + push U (T1 does the diag update + L side concurrently) --
    const i64 kept = drop_vec(ut_ids, utv, tau_U, std::abs(ku) * kappa_d,
                              alpha_U, row_ref[idk], nnum0, nsp0, keep0);
    for (i64 k = 0; k < kept; ++k) {
      if (k + 8 < kept)
        __builtin_prefetch(&cols_of_U.head[keep0[k + 8].id], 1, 1);
      Uids.push_back(keep0[k].id);
      Uvals.push_back(keep0[k].val);
      cols_of_U.add(keep0[k].id, stp, keep0[k].val);
    }
    Uptr.push_back((i64)Uids.size());
    Uend.push_back((i64)Uids.size());
    kap_u.push_back(ku);
    dvec.push_back(dk);
    pending_accept = idk;  // published at the top of the next iteration
    ++step_t0;
  }
  worker.join();
  if (pending_accept >= 0) status[pending_accept] = 1;

  res->stats[3] = nsp0 + nsp1;
  res->stats[4] = nnum0 + nsp0 + nnum1 + nsp1;
  const i64 m = step_t0;
  res->m = m;
  res->stats[0] = (i64)deferred.size();
  kappa_minmax(kap_u, kap_l, res->kmm);
  const bool prof = std::getenv("HT_PROFILE") != nullptr;
  auto t_loop_end = std::chrono::steady_clock::now();

  std::vector<i64> ordR;
  ordR.reserve(n);
  for (i64 id = 0; id < m2; ++id)
    if (status[id] == 1) ordR.push_back(id);
  for (i64 id = m2; id < n; ++id) ordR.push_back(id);
  for (i64 id : deferred) ordR.push_back(id);
  finalize_core<VT>(res, n, m, Ap, Ai, Av, row_ref, col_ref, schur_aL,
                    schur_aU, ordR, ordR, Lptr, Lids, Lvals, Uptr, Uids,
                    Uvals, dvec);
  CroutWS<VT>::get().maybe_release();
  if (prof) {
    auto t_end = std::chrono::steady_clock::now();
    auto ms = [](auto a, auto b) {
      return std::chrono::duration<double, std::milli>(b - a).count();
    };
    std::fprintf(stderr,
                 "[ht_crout mt] n=%lld m=%lld loop=%.0fms post=%.0fms\n",
                 (long long)n, (long long)m, ms(t_begin, t_loop_end),
                 ms(t_loop_end, t_end));
  }
  return res;
}

template <class VT>
void *crout_core(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                 const VT *Av, const VT *d0, double kappa_d,
                 double kappa, double tau_L, double tau_U, double alpha_L,
                 double alpha_U, const i64 *row_ref, const i64 *col_ref,
                 double schur_aL, double schur_aU, int symmetric) {
  auto t_begin = std::chrono::steady_clock::now();
  malloc_tune_once();
  auto *res = new Result<VT>();
  res->n = n;

  // symmetric: 0 = general LDU; 1 = LDL^T (opts.is_symm, U mirrored from L
  // in full); 2 = pattern-symmetric *mirror* mode matching the reference's
  // level_factorize<IsSymm=true> (levels <= 2 with >= nzp_thres pattern
  // symmetry and q == p, s == t): only ut is computed, the leading part of
  // each L column is the mirror of the kept ut (L_B = U_B^T), only the tail
  // part of l (ids >= m2 or deferred) is computed against tail views of L,
  // kappa_l = kappa_ut, and the trailing diagonal update uses ut alone
  // (ref Crout.hpp:271-356,613-630,803-850; factor.hpp:903-983).  The
  // Python anchor for mode 2 is crout_level_np(..., symm_mode=2).
  // 3 = Hermitian LDL^H: the LDL^T walk with conjugated mirror (U = L^H);
  // a deliberate improvement over the reference, whose own is_symm on
  // complex input produces a broken preconditioner (BASELINE.md round-5)
  const bool herm = symmetric == 3;
  const bool ldlt = symmetric == 1 || herm;
  const bool mir = symmetric == 2;

  // fat levels run the dual-thread variant (identical results); requires
  // positive space-dropping caps for the no-realloc pool guarantee.
  // On <= 2 hardware threads the spin-synchronized pair measurably LOSES to
  // the serial kernel (interleaved 1M-Poisson A/B: L2 loop 5.2s MT vs 3.5s
  // serial) -- the finalize OpenMP regions already saturate both cores --
  // so the pair engages only with >2 cores, or when HT_MT=1 forces it.
  const bool mt_forced = std::getenv("HT_MT") != nullptr;
  if (!ldlt && !mir && alpha_L > 0.0 && alpha_U > 0.0 && m2 > 0 &&
      n >= 16384 && Ap[n] >= 12 * n && std::getenv("HT_NO_MT") == nullptr &&
      (mt_forced || std::thread::hardware_concurrency() > 2)) {
    delete res;
    return crout_core_mt<VT>(n, m2, Ap, Ai, Av, d0, kappa_d, kappa, tau_L,
                             tau_U, alpha_L, alpha_U, row_ref, col_ref,
                             schur_aL, schur_aU);
  }

  // CSC of Ahat (all big scratch lives in the cross-level workspace; see
  // CroutWS)
  CroutWS<VT> &ws = CroutWS<VT>::get();
  std::vector<i64> &Cp = ws.Cp;
  std::vector<i32> &Ci = ws.Ci;
  std::vector<VT> &Cv = ws.Cv;
  const i64 nnzA = Ap[n];
  const i64 rsv = nnzA * 4 + 16;
  Adj<VT> &rows_of_L = ws.rows_of_L, &cols_of_U = ws.cols_of_U;
  rows_of_L.reset(mir ? 0 : n, mir ? 0 : rsv);
  cols_of_U.reset(n, rsv);
  // Reserve the factor arrays up front and kick off the concurrent arena
  // prefault (see Prefault) over the expected-use prefixes while the main
  // thread runs the transpose + loop.  Populate depth: the kept-entry count
  // per side is bounded by the space-dropping caps and empirically lands in
  // [0.2, 1.1] * nnz(Ahat) on the tracked problems; 1.25 * nnz covers it
  // without ballooning RSS (under-population just leaves residual faults).
  ws.Lids.reserve(rsv);
  ws.Lvals.reserve(rsv);
  ws.Uids.reserve(rsv);
  ws.Uvals.reserve(rsv);
  Cp.reserve(n + 1);
  Ci.reserve(nnzA);
  Cv.reserve(nnzA);
  Prefault pf;
  if (!std::getenv("HT_NO_PREFAULT")) {
    // 0.5*nnz default: covers the early hot growth of every tracked level
    // while keeping the populate volume (and its kernel zeroing on core 2)
    // well under the actually-used footprint — the 1.25*nnz full-coverage
    // setting measurably slowed the finalize phases that follow (L2 post
    // 1.9 -> 2.9 s) by zeroing never-used pages.  HT_PREFAULT_FRAC to A/B.
    const char *pfr = std::getenv("HT_PREFAULT_FRAC");
    const double frac = pfr ? std::atof(pfr) : 0.5;
    const size_t cnt = (size_t)std::min(rsv, (i64)(nnzA * frac) + 16);
    const size_t nodesz = sizeof(typename Adj<VT>::Node);
    std::vector<std::pair<void *, size_t>> regions;
    regions.emplace_back(Ci.data(), nnzA * sizeof(i32));
    regions.emplace_back(Cv.data(), nnzA * sizeof(VT));
    if (!ldlt) {  // U side materialized (general + mirror modes)
      regions.emplace_back(cols_of_U.pool.data(), cnt * nodesz);
      regions.emplace_back(ws.Uids.data(), cnt * sizeof(i32));
      regions.emplace_back(ws.Uvals.data(), cnt * sizeof(VT));
    }
    if (!mir) {  // L side materialized in the loop (general + LDL^T)
      regions.emplace_back(rows_of_L.pool.data(), cnt * nodesz);
      regions.emplace_back(ws.Lids.data(), cnt * sizeof(i32));
      regions.emplace_back(ws.Lvals.data(), cnt * sizeof(VT));
    }
    pf.go(std::move(regions));
  }
  ht::transpose_csr(n, n, Ap, Ai, Av, Cp, Ci, Cv);
  if (std::getenv("HT_PROFILE")) {
    auto t_tr = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[ht_crout] setup(transpose)=%.0fms\n",
                 std::chrono::duration<double, std::milli>(t_tr - t_begin)
                     .count());
  }

  std::vector<VT> &d = ws.d;
  d.assign(d0, d0 + m2);
  std::vector<unsigned char> &status = ws.status;
  status.assign(n, 0);  // 0 pending 1 accepted 2 deferred
  // mode-2 tail views of L columns, keyed by step j; node.step holds the
  // row id (the reference's symm_update_lstart L_offsets play this role)
  Adj<VT> &tail_of_L = ws.tail_of_L;
  tail_of_L.reset(mir ? m2 + 1 : 0, mir ? (Ap[n] + 16) : 0);
  auto spill_mirror = [&](i64 idv) {
    // on deferral the mirrored entries of idv move from the (implicit)
    // leading parts into the tail views (ref defer_entry index rotation)
    for (i32 e = cols_of_U.head[idv]; e >= 0; e = cols_of_U.pool[e].nxt)
      tail_of_L.add(cols_of_U.pool[e].step, (i32)idv, cols_of_U.pool[e].val);
  };

  // factor storage: per accepted step; Lend/Uend track the live region of
  // each row -- consumed (accepted) entries are swapped to the tail so the
  // hot scans only visit remaining entries (the reference gets the same
  // effect from its advancing start positions, Crout.hpp:428)
  std::vector<i64> &Lptr = ws.Lptr, &Uptr = ws.Uptr;
  std::vector<i64> &Lend = ws.Lend, &Uend = ws.Uend;
  std::vector<i32> &Lids = ws.Lids, &Uids = ws.Uids;
  std::vector<VT> &Lvals = ws.Lvals, &Uvals = ws.Uvals;
  std::vector<VT> &dvec = ws.dvec, &kap_u = ws.kap_u, &kap_l = ws.kap_l;
  std::vector<i64> &deferred = ws.deferred;
  Lptr.assign(1, 0);
  Uptr.assign(1, 0);
  Lend.clear();
  Uend.clear();
  Lids.clear();
  Uids.clear();
  Lvals.clear();
  Uvals.clear();
  dvec.clear();
  kap_u.clear();
  kap_l.clear();
  deferred.clear();
  Lptr.reserve(m2 + 1);
  Uptr.reserve(m2 + 1);
  Lend.reserve(m2);
  Uend.reserve(m2);
  dvec.reserve(m2);
  kap_u.reserve(m2);
  kap_l.reserve(m2);

  // scatter workspaces hold only {step tag, position}; the candidate
  // VALUES live in compact append-order buffers (utv/lv parallel to
  // ut_ids/l_ids).  The streaming row scans evict the cache between the
  // scatter phase and dropping, so dropping/scaling/pushing must not
  // re-gather through the n-sized array: with the compact buffers they
  // touch only sequential hot memory (8 bytes per id in the scatter map
  // instead of 16 also halves the random-access footprint).
  // Accepted ids are additionally TOMBSTONE-tagged here: an accepted id can
  // never be a candidate again, so its (dead) tag slot doubles as the
  // "consumed" flag — the hot U/L row scans then need ONE random load per
  // visited entry (wu/wl) instead of two (status byte + tag word), which is
  // the dominant cost of this latency-bound loop (~150M visits per fat
  // level at 1M rows)
  using TP = typename CroutWS<VT>::TP;
  constexpr i32 TOMB = -2;  // never equals a step stamp (>= 0) or init -1
  std::vector<TP> &wu = ws.wu, &wl = ws.wl;
  wu.assign(n, TP{-1, 0});
  wl.assign(n, TP{-1, 0});
  // candidate buffers are preallocated at full width and written by index
  // (counts nu/nl) so the hot scans can do an UNCONDITIONAL append-slot
  // store and select the target position branchlessly — the new-vs-seen
  // branch is data-dependent (~25% new) and its mispredicts dominate the
  // otherwise cache-resident scan (+1 slot for the dead store when the
  // final visit is a duplicate)
  std::vector<i32> &ut_ids = ws.ut_ids, &l_ids = ws.l_ids;
  std::vector<VT> &utv = ws.utv, &lv = ws.lv;
  ut_ids.resize(n + 1);
  l_ids.resize(n + 1);
  utv.resize(n + 1);
  lv.resize(n + 1);
  std::vector<DropEnt<VT>> &keep = ws.keep;
  // deferred consumed-entry compaction scratch (see scans): raw pointer +
  // counter, NO vector calls inside the hot loops — a push_back there makes
  // the compiler reload every other vector's data pointer each iteration
  // (measured 2x on the scans)
  std::vector<i64> tomb_store(n);
  i64 *HT_RESTRICT tomb_buf = tomb_store.data();
  Lids.reserve(rsv); Lvals.reserve(rsv);
  Uids.reserve(rsv); Uvals.reserve(rsv);
  // adjacency stashes: the kappa walk is the COLD traversal of the two
  // per-id linked lists (~100 cycles/node); stashing (step, val) into these
  // compact buffers lets the ut/l outer loops re-read them sequentially
  // instead of re-chasing the same cold pointers a second time
  std::vector<i32> &adjU_j = ws.adjU_j, &adjL_j = ws.adjL_j;
  std::vector<VT> &adjU_v = ws.adjU_v, &adjL_v = ws.adjL_v;

  const bool prof2 = std::getenv("HT_PROFILE2") != nullptr;
  unsigned long long n_ut_vis = 0, n_l_vis = 0, n_kap_vis = 0,
                     n_pre = 0, n_kept = 0, n_swap = 0;
  unsigned long long c_kappa = 0, c_ut = 0, c_l = 0, c_drop = 0, c_push = 0,
                     c_pushA = 0, c_scale = 0, t0 = 0, t1 = 0;
  (void)c_pushA;
#define HT_TIC2() if (prof2) t1 = __rdtsc()
#define HT_TOC2(acc) if (prof2) acc += __rdtsc() - t1
#define HT_TIC() if (prof2) t0 = __rdtsc()
#define HT_TOC(acc) if (prof2) acc += __rdtsc() - t0

  i64 step = 0;
  for (i64 idk = 0; idk < m2; ++idk) {
    const VT dk = d[idk];
    if (dk == VT(0.0) || std::abs(VT(1.0) / dk) > kappa_d) {
      ++res->stats[1];
      status[idk] = 2;
      deferred.push_back(idk);
      if (mir) spill_mirror(idk);
      continue;
    }
    VT ku = VT(1.0), kl = VT(1.0);
    HT_TIC();
    adjU_j.clear(); adjU_v.clear();
    adjL_j.clear(); adjL_v.clear();
    if (step) {
      // incremental inverse-norm estimates (ref Crout.hpp:486); for the
      // symmetric LDL^T kernel kappa_u == kappa_l (ref factor.hpp:818-820),
      // and the mode-2 mirror reuses kappa_ut (ref factor.hpp:858-860).
      // The walks also stash (step, val) for the ut/l outer loops below.
      // the two chases are independent dependent-miss chains; running them
      // interleaved doubles the memory-level parallelism of this
      // latency-bound walk (each chain's own accumulation order — and thus
      // the fp sum — is unchanged)
      if (!ldlt && !mir) {
        VT sumu = VT(0.0), suml = VT(0.0);
        i32 eu = cols_of_U.head[idk], el = rows_of_L.head[idk];
        while (eu >= 0 || el >= 0) {
          if (eu >= 0) {
            const i32 j = cols_of_U.pool[eu].step;
            const VT v = cols_of_U.pool[eu].val;
            eu = cols_of_U.pool[eu].nxt;
            if (eu >= 0) __builtin_prefetch(&cols_of_U.pool[eu], 0, 1);
            adjU_j.push_back(j);
            adjU_v.push_back(v);
            sumu += kap_u[j] * v;
            HT_VIS(++n_kap_vis);
          }
          if (el >= 0) {
            const i32 j = rows_of_L.pool[el].step;
            const VT v = rows_of_L.pool[el].val;
            el = rows_of_L.pool[el].nxt;
            if (el >= 0) __builtin_prefetch(&rows_of_L.pool[el], 0, 1);
            adjL_j.push_back(j);
            adjL_v.push_back(v);
            suml += kap_l[j] * v;
          }
        }
        const VT k1u = VT(1.0) - sumu, k2u = VT(-1.0) - sumu;
        ku = std::abs(k1u) < std::abs(k2u) ? k2u : k1u;
        const VT k1l = VT(1.0) - suml, k2l = VT(-1.0) - suml;
        kl = std::abs(k1l) < std::abs(k2l) ? k2l : k1l;
      } else {
        VT sum = VT(0.0);
        if (!ldlt) {
          for (i32 e = cols_of_U.head[idk]; e >= 0;
               e = cols_of_U.pool[e].nxt) {
            const i32 j = cols_of_U.pool[e].step;
            const VT v = cols_of_U.pool[e].val;
            adjU_j.push_back(j);
            adjU_v.push_back(v);
            sum += kap_u[j] * v;
            HT_VIS(++n_kap_vis);
          }
          const VT k1 = VT(1.0) - sum, k2 = VT(-1.0) - sum;
          ku = std::abs(k1) < std::abs(k2) ? k2 : k1;
        }
        if (ldlt || !mir) {
          sum = VT(0.0);
          for (i32 e = rows_of_L.head[idk]; e >= 0;
               e = rows_of_L.pool[e].nxt) {
            const i32 j = rows_of_L.pool[e].step;
            const VT v = rows_of_L.pool[e].val;
            adjL_j.push_back(j);
            adjL_v.push_back(v);
            sum += kap_l[j] * v;
          }
          const VT k1 = VT(1.0) - sum, k2 = VT(-1.0) - sum;
          kl = std::abs(k1) < std::abs(k2) ? k2 : k1;
        }
        if (ldlt) ku = herm ? ht_conj(kl) : kl;  // U = L^H: conj recurrence
        if (mir) kl = ku;
      }
    }
    HT_TOC(c_kappa);
    if (std::abs(ku) > kappa || std::abs(kl) > kappa) {
      ++res->stats[2];
      status[idk] = 2;
      deferred.push_back(idk);
      if (mir) spill_mirror(idk);
      continue;
    }

    // ---- compute ut (ref Crout.hpp:169); skipped for LDL^T (U = L^T).
    // For a pending idk the leading L row mirrors the U column, so mode 2
    // traverses cols_of_U in place of rows_of_L ----
    i64 nu = 0, nl = 0;
    HT_TIC();
    const i32 stp = (i32)step;
    if (!ldlt) {
      for (i64 k = Ap[idk]; k < Ap[idk + 1]; ++k) {
        const i32 c = Ai[k];
        if (wu[c].tag != TOMB && c != idk) {
          wu[c].tag = stp;
          wu[c].pos = (i32)nu;
          ut_ids[nu] = c;
          utv[nu] = Av[k];
          ++nu;
        }
      }
      const std::vector<i32> &rj = mir ? adjU_j : adjL_j;
      const std::vector<VT> &rv = mir ? adjU_v : adjL_v;
      for (i64 e = 0; e < (i64)rj.size(); ++e) {
        const i32 j = rj[e];
        const VT ld = rv[e] * dvec[j];
        // FIXED-end scan + deferred backward compaction: mutating `end`
        // inside the loop (the old swap-on-encounter removal) makes the
        // trip count data-dependent and blocks compiler unrolling of this
        // hottest loop; consumed entries are now only NOTED during the
        // countable scan and compacted to the tail afterwards (same
        // amortized cost — each consumed entry moves once).  Live-region
        // content order changes relative to the old scheme, which is safe:
        // per-candidate accumulation order across rows j is fixed by the
        // outer loop, and the dropping total order is position-free.
        const i64 kbeg = Uptr[j], kend = Uend[j];
        i64 ntomb = 0;
        for (i64 k = kbeg; k < kend; ++k) {
          const i32 c = Uids[k];
          HT_VIS(++n_ut_vis);
          const TP tp = wu[c];  // one 8-byte load covers tag AND pos
          const i32 tg = tp.tag;
          // hottest case first: already a candidate this step.  tg == stp
          // implies c was seeded/inserted this step, so c != idk is
          // guaranteed (idk is never seeded and its tag can only be a
          // stale older stamp or TOMB) — no wu store, no idk check.
          if (tg == stp) {
            utv[tp.pos] -= ld * Uvals[k];
            continue;
          }
          if (tg == TOMB) {  // consumed: compacted after the scan
            HT_VIS(++n_swap);
            tomb_buf[ntomb++] = k;
            continue;
          }
          if (c != idk) {  // new candidate
            wu[c].tag = stp;
            wu[c].pos = (i32)nu;
            ut_ids[nu] = c;
            utv[nu] = -ld * Uvals[k];
            ++nu;
          }
        }
        if (ntomb) {
          // descending: every tomb above position p is already in (e, kend)
          i64 ee = kend;
          for (i64 t = ntomb - 1; t >= 0; --t) {
            const i64 pp = tomb_buf[t];
            --ee;
            std::swap(Uids[pp], Uids[ee]);
            std::swap(Uvals[pp], Uvals[ee]);
          }
          Uend[j] = ee;
        }
      }
    }

    HT_TOC(c_ut);
    // ---- compute l (ref Crout.hpp:271); mode 2 computes only the tail
    // part (ids >= m2 or deferred) against the tail views of L ----
    HT_TIC();
    for (i64 k = Cp[idk]; k < Cp[idk + 1]; ++k) {
      const i32 r = Ci[k];
      if (mir ? (r >= m2 || status[r] == 2)
              : (wl[r].tag != TOMB && r != idk)) {
        wl[r].tag = stp;
        wl[r].pos = (i32)nl;
        l_ids[nl] = r;
        lv[nl] = Cv[k];
        ++nl;
      }
    }
    if (mir) {
      for (i64 e = 0; e < (i64)adjU_j.size(); ++e) {
        const i32 j = adjU_j[e];
        const VT du = dvec[j] * adjU_v[e];
        for (i32 e2 = tail_of_L.head[j]; e2 >= 0;
             e2 = tail_of_L.pool[e2].nxt) {
          const i32 r = tail_of_L.pool[e2].step;  // row id
          if (wl[r].tag != stp) {
            wl[r].tag = stp;
            wl[r].pos = (i32)nl;
            l_ids[nl] = r;
            lv[nl] = -du * tail_of_L.pool[e2].val;
            ++nl;
          } else
            lv[wl[r].pos] -= du * tail_of_L.pool[e2].val;
        }
      }
    } else {
      const std::vector<i32> &cj = ldlt ? adjL_j : adjU_j;
      const std::vector<VT> &cv = ldlt ? adjL_v : adjU_v;
      for (i64 e = 0; e < (i64)cj.size(); ++e) {
        const i32 j = cj[e];
        // LDL^H: U[j, idk] = conj(L[idk, j])
        const VT du = dvec[j] * (herm ? ht_conj(cv[e]) : cv[e]);
        // fixed-end countable scan + deferred compaction (see the ut scan)
        const i64 kbeg = Lptr[j], kend = Lend[j];
        i64 ntomb = 0;
        for (i64 k = kbeg; k < kend; ++k) {
          const i32 r = Lids[k];
          HT_VIS(++n_l_vis);
          const TP tp = wl[r];  // one 8-byte load covers tag AND pos
          const i32 tg = tp.tag;
          if (tg == stp) {  // seen this step (see the ut-scan note)
            lv[tp.pos] -= du * Lvals[k];
            continue;
          }
          if (tg == TOMB) {
            tomb_buf[ntomb++] = k;
            continue;
          }
          if (r != idk) {
            wl[r].tag = stp;
            wl[r].pos = (i32)nl;
            l_ids[nl] = r;
            lv[nl] = -du * Lvals[k];
            ++nl;
          }
        }
        if (ntomb) {
          i64 ee = kend;
          for (i64 t = ntomb - 1; t >= 0; --t) {
            const i64 pp = tomb_buf[t];
            --ee;
            std::swap(Lids[pp], Lids[ee]);
            std::swap(Lvals[pp], Lvals[ee]);
          }
          Lend[j] = ee;
        }
      }
    }

    HT_TOC(c_l);
    // ---- scale ut, update trailing diag, scale l (ref factor.hpp:906-931)
    // All scalings are true divisions (not reciprocal multiplies): the
    // Python anchor divides, and a 1-ulp difference flips near-threshold
    // drop decisions, breaking the anchor==native bit-identity contract.
    HT_TIC();
    if (ldlt) {
      // anchor (general kernel on a symmetric matrix) scales ut first and
      // updates d from scaled-ut * unscaled-l; mirror that exactly
      for (i64 k = 0; k < nl; ++k) {
        const i32 c = l_ids[k];
        if (c < m2 && status[c] == 0)
          d[c] -= (lv[k] / dk) * (herm ? ht_conj(lv[k]) : lv[k]);
      }
      for (i64 k = 0; k < nl; ++k) lv[k] /= dk;
      // mirror for the dropping below: ut = l
    } else if (mir) {
      // d[c] -= dk * ut_scaled[c]^2 (ref update_diag<true>,
      // Crout.hpp:613-630; no conjugation — symmetric, not Hermitian)
      for (i64 k = 0; k < nu; ++k) utv[k] /= dk;
      for (i64 k = 0; k < nu; ++k) {
        const i32 c = ut_ids[k];
        if (c < m2 && status[c] == 0) d[c] -= dk * utv[k] * utv[k];
      }
      for (i64 k = 0; k < nl; ++k) lv[k] /= dk;
    } else {
      for (i64 k = 0; k < nu; ++k) utv[k] /= dk;
      if (nu <= nl) {
        for (i64 k = 0; k < nu; ++k) {
          const i32 c = ut_ids[k];
          if (c < m2 && status[c] == 0 && wl[c].tag == stp)
            d[c] -= utv[k] * lv[wl[c].pos];
        }
      } else {
        for (i64 k = 0; k < nl; ++k) {
          const i32 c = l_ids[k];
          if (c < m2 && status[c] == 0 && wu[c].tag == stp)
            d[c] -= utv[wu[c].pos] * lv[k];
        }
      }
      for (i64 k = 0; k < nl; ++k) lv[k] /= dk;
    }
    HT_TOC(c_scale);

    // ---- dropping ----
    i64 nnum = 0, nsp = 0;
    i64 n_lead = 0;
    if (!ldlt) {
      HT_TIC2();
      if (prof2) n_pre += nu;
      const i64 kept = drop_vec(ut_ids.data(), utv.data(), nu, tau_U,
                                std::abs(ku) * kappa_d,
                                alpha_U, row_ref[idk], nnum, nsp, keep);
      if (prof2) n_kept += kept;
      HT_TOC2(c_drop);
      HT_TIC2();
      // (the former upfront head-slot prefetch sweep was removed in round
      // 5: with the 260 MB LLC the head arrays are cache-resident and the
      // sweep measured as pure overhead — pushA 0.66 -> 0.52 Gc on the
      // dumped 1M-convdiff level 2)
      for (i64 k = 0; k < kept; ++k) {
        const i32 c = keep[k].id;
        Uids.push_back(c);
        Uvals.push_back(keep[k].val);
        if (mir && c < m2 && status[c] == 0) ++n_lead;
      }
      Uptr.push_back((i64)Uids.size());
      Uend.push_back((i64)Uids.size());
      HT_TOC2(c_pushA);
      HT_TIC2();
      for (i64 k = 0; k < kept; ++k)
        cols_of_U.add(keep[k].id, (i32)step, keep[k].val);
      HT_TOC2(c_push);
    }

    HT_TIC2();
    if (prof2) n_pre += nl;
    const i64 kept = drop_vec(l_ids.data(), lv.data(), nl, tau_L,
                              std::abs(kl) * kappa_d,
                              alpha_L, col_ref[idk], nnum, nsp, keep,
                              mir ? n_lead : 0);
    if (prof2) n_kept += kept;
    HT_TOC2(c_drop);
    HT_TIC2();
    if (mir) {
      // kept tail entries of the L column go into the tail view only; the
      // leading part is implicit (mirror of the kept ut)
      for (i64 k = 0; k < kept; ++k)
        tail_of_L.add(step, keep[k].id, keep[k].val);
    } else {
      for (i64 k = 0; k < kept; ++k) {
        Lids.push_back(keep[k].id);
        Lvals.push_back(keep[k].val);
      }
      Lptr.push_back((i64)Lids.size());
      Lend.push_back((i64)Lids.size());
      HT_TOC2(c_pushA);
      HT_TIC2();
      for (i64 k = 0; k < kept; ++k)
        rows_of_L.add(keep[k].id, (i32)step, keep[k].val);
    }
    // (LDL^T: U is NOT materialized — U = L^T is reconstructed by the
    // symmetric finalize via counting transposes of L_B / dropped L_E)
    HT_TOC2(c_push);
    res->stats[4] += nnum + nsp;
    res->stats[3] += nsp;

    dvec.push_back(dk);
    kap_u.push_back(ku);
    kap_l.push_back(kl);
    status[idk] = 1;
    wu[idk].tag = TOMB;  // consumed-flag for the hot scans (see TP comment)
    wl[idk].tag = TOMB;
    ++step;
  }
  // ---- mode 2: materialize L columns = mirror of the accepted kept ut
  // entries (=> L_B = U_B^T) + the tail views ----
  if (mir) {
    for (i64 j = 0; j < step; ++j) {
      for (i64 k = Uptr[j]; k < Uptr[j + 1]; ++k)
        if (status[Uids[k]] == 1) {
          Lids.push_back(Uids[k]);
          Lvals.push_back(Uvals[k]);
        }
      for (i32 e = tail_of_L.head[j]; e >= 0; e = tail_of_L.pool[e].nxt) {
        Lids.push_back(tail_of_L.pool[e].step);
        Lvals.push_back(tail_of_L.pool[e].val);
      }
      Lptr.push_back((i64)Lids.size());
    }
  }
  const i64 m = step;
  res->m = m;
  if (prof2)
    std::fprintf(stderr,
                 "[ht_loop] kappa=%.2fGc ut=%.2fGc l=%.2fGc scale=%.2fGc "
                 "drop=%.2fGc "
                 "pushA=%.2fGc push=%.2fGc | nnzA=%lld kapV=%.1fM utV=%.1fM "
                 "lV=%.1fM swap=%.1fM pre=%.1fM kept=%.1fM\n",
                 c_kappa * 1e-9, c_ut * 1e-9, c_l * 1e-9, c_scale * 1e-9,
                 c_drop * 1e-9,
                 c_pushA * 1e-9,
                 c_push * 1e-9, (long long)Ap[n], n_kap_vis * 1e-6,
                 n_ut_vis * 1e-6, n_l_vis * 1e-6, n_swap * 1e-6,
                 n_pre * 1e-6, n_kept * 1e-6);
#undef HT_TIC
#undef HT_TOC
#undef HT_TIC2
#undef HT_TOC2
  const bool prof = std::getenv("HT_PROFILE") != nullptr;
  auto t_loop_end = std::chrono::steady_clock::now();
  res->stats[0] = (i64)deferred.size();
  kappa_minmax(kap_u, kap_l, res->kmm);

  // ---- final ordering (rows == cols for the non-pivoting kernel) ----
  std::vector<i64> &ordR = ws.ordR;
  ordR.clear();
  ordR.reserve(n);
  for (i64 id = 0; id < m2; ++id)
    if (status[id] == 1) ordR.push_back(id);
  for (i64 id = m2; id < n; ++id) ordR.push_back(id);
  for (i64 id : deferred) ordR.push_back(id);
  pf.join();  // before finalize competes for the 2nd core / ws release
  finalize_core<VT>(res, n, m, Ap, Ai, Av, row_ref, col_ref, schur_aL,
                    schur_aU, ordR, ordR, Lptr, Lids, Lvals, Uptr, Uids,
                    Uvals, dvec, /*sym=*/ldlt, /*herm=*/herm);
  if (prof) {
    auto t_end = std::chrono::steady_clock::now();
    auto ms = [](auto a, auto b) {
      return std::chrono::duration<double, std::milli>(b - a).count();
    };
    std::fprintf(stderr,
                 "[ht_crout] n=%lld m=%lld loop=%.0fms post=%.0fms\n",
                 (long long)n, (long long)m, ms(t_begin, t_loop_end),
                 ms(t_loop_end, t_end));
  }
  ws.maybe_release();
  return res;
}


// ---- rook-pivoting variant (ref PivotCrout.hpp / pivot_factor.hpp; anchor:
// hifir_tpu/alg/crout_pivot_np.py).  Row and column ids are independent;
// d_k is computed on the fly (no incremental trailing diagonal). ----
template <class VT>
void *pivot_crout_core(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                       const VT *Av, double kappa_d, double kappa,
                       double tau_L, double tau_U, double alpha_L,
                       double alpha_U, const i64 *row_ref, const i64 *col_ref,
                       double schur_aL, double schur_aU, double gamma) {
  constexpr int MAX_ROOK = 4;  // ref PivotCrout.hpp:510
  malloc_tune_once();
  auto *res = new Result<VT>();
  res->n = n;
  if (gamma <= 0.0) gamma = 1.0;

  std::vector<i64> Cp;
  std::vector<i32> Ci;
  std::vector<VT> Cv;
  ht::transpose_csr(n, n, Ap, Ai, Av, Cp, Ci, Cv);

  std::vector<unsigned char> statusR(n, 0), statusC(n, 0);
  std::vector<i64> rowcand(m2), colcand(m2), pos_of_row(m2), pos_of_col(m2);
  for (i64 i = 0; i < m2; ++i)
    rowcand[i] = colcand[i] = pos_of_row[i] = pos_of_col[i] = i;

  const i64 rsv = Ap[n] * 4 + 16;
  Adj<VT> rows_of_L(n, rsv), cols_of_U(n, rsv);
  std::vector<i64> Lptr{0}, Uptr{0};
  std::vector<i32> Lids, Uids;
  std::vector<VT> Lvals, Uvals;
  std::vector<VT> dvec, kap_u, kap_l;
  std::vector<i64> deferredR, deferredC;

  // {stamp, position} scatter maps; candidate values live in compact
  // append-order buffers (same design as crout_core)
  struct TP { i64 tag; i32 pos; };
  std::vector<TP> wu(n, TP{-1, 0}), wl(n, TP{-1, 0});
  std::vector<i32> ut_ids, l_ids;
  std::vector<VT> utv, lv;
  std::vector<DropEnt<VT>> keep;
  i64 stamp = 0;

  auto kappa_new = [&](const Adj<VT> &adj, const std::vector<VT> &kap,
                       i64 idv) -> VT {
    VT sum = VT(0.0);
    for (i32 e = adj.head[idv]; e >= 0; e = adj.pool[e].nxt)
      sum += kap[adj.pool[e].step] * adj.pool[e].val;
    const VT k1 = VT(1.0) - sum, k2 = VT(-1.0) - sum;
    return std::abs(k1) < std::abs(k2) ? k2 : k1;
  };

  // unscaled l over non-accepted rows of column ci (incl. pivot row)
  auto compute_l = [&](i64 ci) {
    ++stamp;
    l_ids.clear();
    lv.clear();
    for (i64 k = Cp[ci]; k < Cp[ci + 1]; ++k) {
      const i32 r = Ci[k];
      if (statusR[r] != 1) {
        wl[r].tag = stamp;
        wl[r].pos = (i32)l_ids.size();
        l_ids.push_back(r);
        lv.push_back(Cv[k]);
      }
    }
    for (i32 e = cols_of_U.head[ci]; e >= 0; e = cols_of_U.pool[e].nxt) {
      const i32 j = cols_of_U.pool[e].step;
      const VT du = dvec[j] * cols_of_U.pool[e].val;
      for (i64 k = Lptr[j]; k < Lptr[j + 1]; ++k) {
        const i32 r = Lids[k];
        if (statusR[r] == 1) continue;
        if (wl[r].tag != stamp) {
          wl[r].tag = stamp;
          wl[r].pos = (i32)l_ids.size();
          l_ids.push_back(r);
          lv.push_back(-du * Lvals[k]);
        } else
          lv[wl[r].pos] -= du * Lvals[k];
      }
    }
  };

  // unscaled ut over non-accepted cols of row ri (incl. pivot col)
  auto compute_ut = [&](i64 ri) {
    ++stamp;
    ut_ids.clear();
    utv.clear();
    for (i64 k = Ap[ri]; k < Ap[ri + 1]; ++k) {
      const i32 c = Ai[k];
      if (statusC[c] != 1) {
        wu[c].tag = stamp;
        wu[c].pos = (i32)ut_ids.size();
        ut_ids.push_back(c);
        utv.push_back(Av[k]);
      }
    }
    for (i32 e = rows_of_L.head[ri]; e >= 0; e = rows_of_L.pool[e].nxt) {
      const i32 j = rows_of_L.pool[e].step;
      const VT ld = rows_of_L.pool[e].val * dvec[j];
      for (i64 k = Uptr[j]; k < Uptr[j + 1]; ++k) {
        const i32 c = Uids[k];
        if (statusC[c] == 1) continue;
        if (wu[c].tag != stamp) {
          wu[c].tag = stamp;
          wu[c].pos = (i32)ut_ids.size();
          ut_ids.push_back(c);
          utv.push_back(-ld * Uvals[k]);
        } else
          utv[wu[c].pos] -= ld * Uvals[k];
      }
    }
  };

  i64 step = 0;
  for (i64 pos = 0; pos < m2; ++pos) {
    i64 ri = rowcand[pos];
    i64 ci = colcand[pos];

    // ---- thresholded rook pivoting (ref apply_thres_pivot) --------------
    for (int rook = 0; rook < MAX_ROOK; ++rook) {
      bool changed = false;
      // row interchange candidate from the column vector
      compute_l(ci);
      VT dk = (wl[ri].tag == stamp) ? lv[wl[ri].pos] : VT(0.0);
      i64 best_r = -1;
      double best_mag = std::abs(dk);
      for (i64 k = 0; k < (i64)l_ids.size(); ++k) {
        const i32 r = l_ids[k];
        if (r == (i32)ri || r >= m2 || statusR[r] != 0) continue;
        if (pos_of_row[r] <= pos) continue;
        const double mag = std::abs(lv[k]);
        if (mag > best_mag) {
          best_r = r;
          best_mag = mag;
        }
      }
      if (best_r >= 0 && std::abs(dk) < gamma * best_mag) {
        const VT klc = step ? kappa_new(rows_of_L, kap_l, best_r) : VT(1.0);
        if (std::abs(klc) <= kappa) {
          const i64 p2 = pos_of_row[best_r];
          std::swap(rowcand[pos], rowcand[p2]);
          pos_of_row[ri] = p2;
          pos_of_row[best_r] = pos;
          ri = best_r;
          changed = true;
        }
      }
      // column interchange candidate from the row vector
      compute_ut(ri);
      dk = (wu[ci].tag == stamp) ? utv[wu[ci].pos] : VT(0.0);
      i64 best_c = -1;
      best_mag = std::abs(dk);
      for (i64 k = 0; k < (i64)ut_ids.size(); ++k) {
        const i32 c = ut_ids[k];
        if (c == (i32)ci || c >= m2 || statusC[c] != 0) continue;
        if (pos_of_col[c] <= pos) continue;
        const double mag = std::abs(utv[k]);
        if (mag > best_mag) {
          best_c = c;
          best_mag = mag;
        }
      }
      if (best_c >= 0 && std::abs(dk) < gamma * best_mag) {
        const VT kuc = step ? kappa_new(cols_of_U, kap_u, best_c) : VT(1.0);
        if (std::abs(kuc) <= kappa) {
          const i64 p2 = pos_of_col[best_c];
          std::swap(colcand[pos], colcand[p2]);
          pos_of_col[ci] = p2;
          pos_of_col[best_c] = pos;
          ci = best_c;
          changed = true;
        }
      }
      if (!changed) break;
    }

    // ---- admissibility of the final pair --------------------------------
    compute_ut(ri);
    const i64 stamp_u = stamp;
    const VT dk = (wu[ci].tag == stamp_u) ? utv[wu[ci].pos] : VT(0.0);
    bool bad = (dk == VT(0.0)) || (std::abs(VT(1.0) / dk) > kappa_d);
    VT ku = VT(1.0), kl = VT(1.0);
    if (bad) {
      ++res->stats[1];
    } else {
      if (step) {
        ku = kappa_new(cols_of_U, kap_u, ci);
        kl = kappa_new(rows_of_L, kap_l, ri);
      }
      bad = std::abs(ku) > kappa || std::abs(kl) > kappa;
      if (bad) ++res->stats[2];
    }
    if (bad) {
      statusR[ri] = 2;
      statusC[ci] = 2;
      deferredR.push_back(ri);
      deferredC.push_back(ci);
      continue;
    }

    // ---- accept ----------------------------------------------------------
    compute_l(ci);
    // scale (true division — anchor bit-identity), excluding the diagonal
    {
      i64 w = 0;
      for (i64 k = 0; k < (i64)ut_ids.size(); ++k)
        if (ut_ids[k] != (i32)ci) {
          utv[w] = utv[k] / dk;
          ut_ids[w++] = ut_ids[k];
        }
      ut_ids.resize(w);
      utv.resize(w);
      w = 0;
      for (i64 k = 0; k < (i64)l_ids.size(); ++k)
        if (l_ids[k] != (i32)ri) {
          lv[w] = lv[k] / dk;
          l_ids[w++] = l_ids[k];
        }
      l_ids.resize(w);
      lv.resize(w);
    }
    i64 nnum = 0, nsp = 0;
    i64 kept = drop_vec(ut_ids, utv, tau_U, std::abs(ku) * kappa_d, alpha_U,
                        row_ref[ri], nnum, nsp, keep);
    for (i64 k = 0; k < kept; ++k) {
      Uids.push_back(keep[k].id);
      Uvals.push_back(keep[k].val);
      cols_of_U.add(keep[k].id, (i32)step, keep[k].val);
    }
    Uptr.push_back((i64)Uids.size());
    kept = drop_vec(l_ids, lv, tau_L, std::abs(kl) * kappa_d, alpha_L,
                    col_ref[ci], nnum, nsp, keep);
    for (i64 k = 0; k < kept; ++k) {
      Lids.push_back(keep[k].id);
      Lvals.push_back(keep[k].val);
      rows_of_L.add(keep[k].id, (i32)step, keep[k].val);
    }
    Lptr.push_back((i64)Lids.size());
    res->stats[4] += nnum + nsp;
    res->stats[3] += nsp;

    dvec.push_back(dk);
    kap_u.push_back(ku);
    kap_l.push_back(kl);
    statusR[ri] = 1;
    statusC[ci] = 1;
    ++step;
  }
  const i64 m = step;
  res->m = m;
  res->stats[0] = (i64)deferredR.size();
  kappa_minmax(kap_u, kap_l, res->kmm);

  std::vector<i64> ordR, ordC;
  ordR.reserve(n);
  ordC.reserve(n);
  for (i64 p2 = 0; p2 < m2; ++p2)
    if (statusR[rowcand[p2]] == 1) ordR.push_back(rowcand[p2]);
  for (i64 p2 = 0; p2 < m2; ++p2)
    if (statusC[colcand[p2]] == 1) ordC.push_back(colcand[p2]);
  for (i64 id = m2; id < n; ++id) {
    ordR.push_back(id);
    ordC.push_back(id);
  }
  for (i64 id : deferredR) ordR.push_back(id);
  for (i64 id : deferredC) ordC.push_back(id);

  finalize_core<VT>(res, n, m, Ap, Ai, Av, row_ref, col_ref, schur_aL,
                    schur_aU, ordR, ordC, Lptr, Lids, Lvals, Uptr, Uids,
                    Uvals, dvec);
  CroutWS<VT>::get().maybe_release();
  return res;
}

// ---- entry points ----
template void *crout_core<double>(i64, i64, const i64 *, const i32 *,
                                  const double *, const double *, double,
                                  double, double, double, double, double,
                                  const i64 *, const i64 *, double, double,
                                  int);
template void *crout_core<std::complex<double>>(
    i64, i64, const i64 *, const i32 *, const std::complex<double> *,
    const std::complex<double> *, double, double, double, double, double,
    double, const i64 *, const i64 *, double, double, int);
// native single-precision kernels (the reference's HIF<float> /
// HIF<complex<float>> instantiations, builder.hpp:109,589 and
// libhifir lhfs*/lhfc*, libhifir.cpp:595+): half the memory traffic of
// the miss-bound Crout loop, no f64 upcast anywhere
template void *crout_core<float>(i64, i64, const i64 *, const i32 *,
                                 const float *, const float *, double,
                                 double, double, double, double, double,
                                 const i64 *, const i64 *, double, double,
                                 int);
template void *crout_core<std::complex<float>>(
    i64, i64, const i64 *, const i32 *, const std::complex<float> *,
    const std::complex<float> *, double, double, double, double, double,
    double, const i64 *, const i64 *, double, double, int);

}  // namespace

HT_API void *ht_crout(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                      const double *Av, const double *d0, double kappa_d,
                      double kappa, double tau_L, double tau_U, double alpha_L,
                      double alpha_U, const i64 *row_ref, const i64 *col_ref,
                      double schur_aL, double schur_aU, int symmetric) {
  return crout_core<double>(n, m2, Ap, Ai, Av, d0, kappa_d, kappa, tau_L,
                            tau_U, alpha_L, alpha_U, row_ref, col_ref,
                            schur_aL, schur_aU, symmetric);
}

HT_API void *ht_crout_pivot(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                            const double *Av, double kappa_d, double kappa,
                            double tau_L, double tau_U, double alpha_L,
                            double alpha_U, const i64 *row_ref,
                            const i64 *col_ref, double schur_aL,
                            double schur_aU, double gamma) {
  return pivot_crout_core<double>(n, m2, Ap, Ai, Av, kappa_d, kappa, tau_L,
                                  tau_U, alpha_L, alpha_U, row_ref, col_ref,
                                  schur_aL, schur_aU, gamma);
}

HT_API void *ht_crout_pivot_z(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                              const double *Av, double kappa_d, double kappa,
                              double tau_L, double tau_U, double alpha_L,
                              double alpha_U, const i64 *row_ref,
                              const i64 *col_ref, double schur_aL,
                              double schur_aU, double gamma) {
  return pivot_crout_core<std::complex<double>>(
      n, m2, Ap, Ai, (const std::complex<double> *)Av, kappa_d, kappa, tau_L,
      tau_U, alpha_L, alpha_U, row_ref, col_ref, schur_aL, schur_aU, gamma);
}

HT_API void *ht_crout_s(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                        const float *Av, const float *d0, double kappa_d,
                        double kappa, double tau_L, double tau_U,
                        double alpha_L, double alpha_U, const i64 *row_ref,
                        const i64 *col_ref, double schur_aL, double schur_aU,
                        int symmetric) {
  return crout_core<float>(n, m2, Ap, Ai, Av, d0, kappa_d, kappa, tau_L,
                           tau_U, alpha_L, alpha_U, row_ref, col_ref,
                           schur_aL, schur_aU, symmetric);
}

// complex64 arrays passed as interleaved float pairs
HT_API void *ht_crout_c(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                        const float *Av, const float *d0, double kappa_d,
                        double kappa, double tau_L, double tau_U,
                        double alpha_L, double alpha_U, const i64 *row_ref,
                        const i64 *col_ref, double schur_aL, double schur_aU,
                        int symmetric) {
  return crout_core<std::complex<float>>(
      n, m2, Ap, Ai, (const std::complex<float> *)Av,
      (const std::complex<float> *)d0, kappa_d, kappa, tau_L, tau_U,
      alpha_L, alpha_U, row_ref, col_ref, schur_aL, schur_aU, symmetric);
}

HT_API void *ht_crout_pivot_s(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                              const float *Av, double kappa_d, double kappa,
                              double tau_L, double tau_U, double alpha_L,
                              double alpha_U, const i64 *row_ref,
                              const i64 *col_ref, double schur_aL,
                              double schur_aU, double gamma) {
  return pivot_crout_core<float>(n, m2, Ap, Ai, Av, kappa_d, kappa, tau_L,
                                 tau_U, alpha_L, alpha_U, row_ref, col_ref,
                                 schur_aL, schur_aU, gamma);
}

HT_API void *ht_crout_pivot_c(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                              const float *Av, double kappa_d, double kappa,
                              double tau_L, double tau_U, double alpha_L,
                              double alpha_U, const i64 *row_ref,
                              const i64 *col_ref, double schur_aL,
                              double schur_aU, double gamma) {
  return pivot_crout_core<std::complex<float>>(
      n, m2, Ap, Ai, (const std::complex<float> *)Av, kappa_d, kappa, tau_L,
      tau_U, alpha_L, alpha_U, row_ref, col_ref, schur_aL, schur_aU, gamma);
}

// complex128 arrays passed as interleaved double pairs
HT_API void *ht_crout_z(i64 n, i64 m2, const i64 *Ap, const i32 *Ai,
                        const double *Av, const double *d0, double kappa_d,
                        double kappa, double tau_L, double tau_U,
                        double alpha_L, double alpha_U, const i64 *row_ref,
                        const i64 *col_ref, double schur_aL, double schur_aU,
                        int symmetric) {
  return crout_core<std::complex<double>>(
      n, m2, Ap, Ai, (const std::complex<double> *)Av,
      (const std::complex<double> *)d0, kappa_d, kappa, tau_L, tau_U,
      alpha_L, alpha_U, row_ref, col_ref, schur_aL, schur_aU, symmetric);
}

// ---- result accessors (type-dispatched via the common ResHead prefix) ----
namespace {
// 4-way dtype dispatch: invokes f on the concrete Result<VT>*
template <class F>
auto res_dispatch(void *h, F f) {
  switch (((ResHead *)h)->dtype) {
    case 1: return f((Result<std::complex<double>> *)h);
    case 2: return f((Result<float>*)h);
    case 3: return f((Result<std::complex<float>> *)h);
    default: return f((Result<double> *)h);
  }
}
}  // namespace

HT_API i64 ht_res_m(void *h) { return ((ResHead *)h)->m; }
HT_API int ht_res_is_complex(void *h) {
  const int d = ((ResHead *)h)->dtype;
  return d == 1 || d == 3;
}
HT_API int ht_res_dtype(void *h) { return ((ResHead *)h)->dtype; }

namespace {
template <class VT>
void res_pick(Result<VT> *r, int what, const std::vector<i64> *&p,
              const std::vector<i32> *&i, const std::vector<VT> *&v) {
  if (what == 0) { p = &r->Lp; i = &r->Li; v = &r->Lv; }
  else if (what == 1) { p = &r->Up; i = &r->Ui; v = &r->Uv; }
  else if (what == 2) { p = &r->Sp; i = &r->Si; v = &r->Sv; }
  else if (what == 3) { p = &r->Ep; i = &r->Ei; v = &r->Ev; }
  else { p = &r->Fp; i = &r->Fi; v = &r->Fv; }
}
}  // namespace

HT_API i64 ht_res_nnz(void *h, int what) {
  return res_dispatch(h, [what](auto *r) -> i64 {
    switch (what) {
      case 0: return (i64)r->Li.size();
      case 1: return (i64)r->Ui.size();
      case 2: return (i64)r->Si.size();
      case 3: return (i64)r->Ei.size();
      case 4: return (i64)r->Fi.size();
    }
    return -1;
  });
}

// `vals` is an opaque buffer of the handle's value type
HT_API void ht_res_copy_mat(void *h, int what, i64 *indptr, i32 *indices,
                            void *vals) {
  res_dispatch(h, [&](auto *r) {
    using VT = typename std::remove_reference<decltype(r->Lv)>::type
        ::value_type;
    const std::vector<i64> *p; const std::vector<i32> *i;
    const std::vector<VT> *v;
    res_pick(r, what, p, i, v);
    std::memcpy(indptr, p->data(), p->size() * sizeof(i64));
    if (!i->empty()) std::memcpy(indices, i->data(), i->size() * sizeof(i32));
    if (!v->empty()) std::memcpy(vals, v->data(), v->size() * sizeof(VT));
  });
}

// raw pointers into the result vectors (zero-copy export; the Python side
// keeps the handle alive for the lifetime of the wrapping arrays)
HT_API void ht_res_ptrs(void *h, int what, void **pp, void **pi, void **pv) {
  res_dispatch(h, [&](auto *r) {
    using VT = typename std::remove_reference<decltype(r->Lv)>::type
        ::value_type;
    const std::vector<i64> *p; const std::vector<i32> *i;
    const std::vector<VT> *v;
    res_pick(r, what, p, i, v);
    *pp = (void *)p->data();
    *pi = (void *)i->data();
    *pv = (void *)v->data();
  });
}

HT_API void ht_res_copy_d(void *h, void *out) {
  res_dispatch(h, [out](auto *r) {
    using VT = typename std::remove_reference<decltype(r->d)>::type
        ::value_type;
    std::memcpy(out, r->d.data(), r->d.size() * sizeof(VT));
  });
}
HT_API void ht_res_copy_ord(void *h, i64 *out) {
  res_dispatch(h, [out](auto *r) {
    std::memcpy(out, r->ord.data(), r->ord.size() * sizeof(i64));
  });
}
HT_API void ht_res_copy_stats(void *h, i64 *out) {
  res_dispatch(h, [out](auto *r) {
    std::memcpy(out, r->stats, 6 * sizeof(i64));
  });
}
HT_API void ht_res_kmm(void *h, double *out) {
  res_dispatch(h, [out](auto *r) { std::copy_n(r->kmm, 4, out); });
}

HT_API void ht_res_free(void *h) {
  res_dispatch(h, [](auto *r) { delete r; });
}

// ---- per-matrix take-out holders --------------------------------------
//
// The zero-copy export used to keep ONE handle alive for all five exported
// matrices, so a preconditioner level retained its (consumed) Schur
// complement for its whole lifetime — ~0.5 GB of dead arrays on a 1M-row
// robust factorize, feeding the allocator-churn cost of every later level.
// ht_res_take_mat moves one matrix's vectors into a standalone holder whose
// lifetime is that matrix's numpy views alone; S is then freed as soon as
// the next level has consumed it.
namespace {
template <class VT>
struct MatHolder {
  int dtype = DtypeCode<VT>::value;
  std::vector<i64> p;
  std::vector<i32> i;
  std::vector<VT> v;
};
template <class F>
auto mat_dispatch(void *h, F f) {
  switch (*(int *)h) {
    case 1: return f((MatHolder<std::complex<double>> *)h);
    case 2: return f((MatHolder<float> *)h);
    case 3: return f((MatHolder<std::complex<float>> *)h);
    default: return f((MatHolder<double> *)h);
  }
}
}  // namespace

HT_API void *ht_res_take_mat(void *h, int what) {
  return res_dispatch(h, [what](auto *r) -> void * {
    using VT = typename std::remove_reference<decltype(r->Lv)>::type
        ::value_type;
    auto *mh = new MatHolder<VT>();
    if (what == 0) { mh->p = std::move(r->Lp); mh->i = std::move(r->Li);
                     mh->v = std::move(r->Lv); }
    else if (what == 1) { mh->p = std::move(r->Up); mh->i = std::move(r->Ui);
                          mh->v = std::move(r->Uv); }
    else if (what == 2) { mh->p = std::move(r->Sp); mh->i = std::move(r->Si);
                          mh->v = std::move(r->Sv); }
    else if (what == 3) { mh->p = std::move(r->Ep); mh->i = std::move(r->Ei);
                          mh->v = std::move(r->Ev); }
    else { mh->p = std::move(r->Fp); mh->i = std::move(r->Fi);
           mh->v = std::move(r->Fv); }
    return (void *)mh;
  });
}

HT_API void ht_mat_ptrs(void *h, void **pp, void **pi, void **pv) {
  mat_dispatch(h, [&](auto *mh) {
    *pp = (void *)mh->p.data();
    *pi = (void *)mh->i.data();
    *pv = (void *)mh->v.data();
  });
}

HT_API void ht_mat_free(void *h) {
  mat_dispatch(h, [](auto *mh) { delete mh; });
}
