// CI pairwise head-phase counts (K3) for Hopper (sm_90a), plain C interface.
//
// Replaces ventjax/ops/ci_pallas.py:head_counts_pallas (_head_kernel).
// counts[n, row, j] = #{ w : dmin2(center row, witness w) <= r2[j] }, j < ns,
// where dmin2 is the least scaled squared distance over the alias combos
// (p, q, s) whose offset lies in the rmax box.
//
// Exactness.  The geometry's build-time proof (ventjax/ops/ci_pairwise.py,
// guard (b)) validates the UNFUSED float32 expression
// ((fx*fx) + (fy*fy)) + (fz*fz) with fx = float(oi) * s0.  nvcc would
// contract it into FMAs, which can move a voxel across a shell boundary, so
// it is written with __fmul_rn / __fadd_rn in that association order.
// Counting uses each witness's first ball, searchsorted(r2, dmin2, left),
// in a per-center histogram whose prefix sum gives the counts: exact in
// integers, so the result is bit-equal to the plain PyTorch version.
//
// Tiling.  One block per (64 centers, lane), one thread per center; the
// witnesses stream through shared memory in tiles of 512.  Each block
// computes the i/j coordinate ranges of its centers and of each witness
// tile and skips a combo (or the whole tile) whose offset interval cannot
// meet the rmax box -- the Pallas kernel's interval tests, computed by the
// block from its own coordinates.  Sentinel rows (+-2^20 coordinates) only
// widen the intervals, so a skip is always safe.  Ragged edges are masked.
//
// What bounds it on this card: integer and float32 arithmetic per
// (center, witness, live combo) pair -- about 20 instructions -- plus a
// shared-memory histogram update for pairs within the head balls.  Device
// memory traffic is coordinates in and counts out.
//
// Why float32: the distances must be the float32 values the exactness
// proof checked; anything else may change the shell a pair falls in.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (never --use_fast_math), by ventjax_torch/_build.py.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;     // centers per block, one per thread
constexpr int WB = 512;      // witnesses per shared-memory tile
constexpr int MAXNS = 128;
constexpr int MAXCOMBO = 9;

struct Combos {
  int n;
  int p[MAXCOMBO], q[MAXCOMBO], s[MAXCOMBO];
};

__global__ void __launch_bounds__(ROWS) head_counts_kernel(
    const int* __restrict__ ci, const int* __restrict__ cj,
    const int* __restrict__ ck, const int* __restrict__ wi,
    const int* __restrict__ wj, const int* __restrict__ wk,
    const float* __restrict__ r2, int* __restrict__ counts, int K, int Kw,
    int ns, Combos cb, float s0, float s1, float s2, int rmax) {
  __shared__ int hist[MAXNS * ROWS];   // hist[ball * ROWS + thread]
  __shared__ int s_wi[WB], s_wj[WB], s_wk[WB];
  __shared__ float s_r2[MAXNS];
  __shared__ int c_rng[4];             // centers: i min, i max, j min, j max
  __shared__ int w_rng[4];             // current witness tile, same order

  const int lane = blockIdx.y;
  const int t = threadIdx.x;
  const int row = blockIdx.x * ROWS + t;
  const bool has = row < K;
  const size_t cbase = (size_t)lane * K;
  const size_t wbase = (size_t)lane * Kw;
  const int vi = has ? ci[cbase + row] : 0;
  const int vj = has ? cj[cbase + row] : 0;
  const int vk = has ? ck[cbase + row] : 0;

  for (int s = 0; s < ns; ++s) hist[s * ROWS + t] = 0;
  for (int s = t; s < ns; s += ROWS) s_r2[s] = r2[s];
  if (t == 0) {
    c_rng[0] = INT_MAX; c_rng[1] = INT_MIN;
    c_rng[2] = INT_MAX; c_rng[3] = INT_MIN;
  }
  __syncthreads();
  if (has) {
    atomicMin(&c_rng[0], vi); atomicMax(&c_rng[1], vi);
    atomicMin(&c_rng[2], vj); atomicMax(&c_rng[3], vj);
  }
  const float r2_head = r2[ns - 1];

  for (int w0 = 0; w0 < Kw; w0 += WB) {
    const int nw = min(WB, Kw - w0);
    __syncthreads();   // previous tile fully consumed
    if (t == 0) {
      w_rng[0] = INT_MAX; w_rng[1] = INT_MIN;
      w_rng[2] = INT_MAX; w_rng[3] = INT_MIN;
    }
    __syncthreads();
    int lo_i = INT_MAX, hi_i = INT_MIN, lo_j = INT_MAX, hi_j = INT_MIN;
    for (int i = t; i < nw; i += ROWS) {
      const int a = wi[wbase + w0 + i];
      const int b = wj[wbase + w0 + i];
      s_wi[i] = a;
      s_wj[i] = b;
      s_wk[i] = wk[wbase + w0 + i];
      lo_i = min(lo_i, a); hi_i = max(hi_i, a);
      lo_j = min(lo_j, b); hi_j = max(hi_j, b);
    }
    atomicMin(&w_rng[0], lo_i); atomicMax(&w_rng[1], hi_i);
    atomicMin(&w_rng[2], lo_j); atomicMax(&w_rng[3], hi_j);
    __syncthreads();

    // Combo c is live iff oi = wi - vi + p can meet [-rmax, rmax] over the
    // block's intervals, and likewise oj with q.  Uniform over the block.
    unsigned live = 0;
    for (int c = 0; c < cb.n; ++c) {
      const bool fi = (w_rng[0] - c_rng[1] + cb.p[c] <= rmax) &&
                      (w_rng[1] - c_rng[0] + cb.p[c] >= -rmax);
      const bool fj = (w_rng[2] - c_rng[3] + cb.q[c] <= rmax) &&
                      (w_rng[3] - c_rng[2] + cb.q[c] >= -rmax);
      if (fi && fj) live |= 1u << c;
    }
    if (live == 0u || !has) continue;

    for (int w = 0; w < nw; ++w) {
      const int oi0 = s_wi[w] - vi;
      const int oj0 = s_wj[w] - vj;
      const int ok0 = s_wk[w] - vk;
      float dmin = INFINITY;
      for (int c = 0; c < cb.n; ++c) {
        if (!((live >> c) & 1u)) continue;
        const int oi = oi0 + cb.p[c];
        const int oj = oj0 + cb.q[c];
        const int ok = ok0 + cb.s[c];
        if (abs(oi) > rmax || abs(oj) > rmax || abs(ok) > rmax) continue;
        const float fx = __fmul_rn((float)oi, s0);
        const float fy = __fmul_rn((float)oj, s1);
        const float fz = __fmul_rn((float)ok, s2);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)),
                                   __fmul_rn(fz, fz));
        dmin = fminf(dmin, d2);
      }
      if (dmin <= r2_head) {
        // first ball j with dmin <= r2[j] (r2 ascending)
        int lo = 0, hi = ns - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_r2[mid] < dmin) lo = mid + 1; else hi = mid;
        }
        hist[lo * ROWS + t] += 1;
      }
    }
  }

  if (has) {
    int run = 0;
    int* out = counts + (cbase + row) * ns;
    for (int s = 0; s < ns; ++s) {
      run += hist[s * ROWS + t];
      out[s] = run;
    }
  }
}

}  // namespace

extern "C" int vj_head_counts(const int* ci, const int* cj, const int* ck,
                              const int* wi, const int* wj, const int* wk,
                              const float* r2, int* counts, int N, int K,
                              int Kw, int ns, const int* combos, int ncombo,
                              float s0, float s1, float s2, int rmax,
                              void* stream) {
  if (N < 1 || N > 65535 || K < 1 || Kw < 1 || ns < 1 || ns > MAXNS ||
      ncombo < 1 || ncombo > MAXCOMBO)
    return (int)cudaErrorInvalidValue;
  Combos cb;
  cb.n = ncombo;
  for (int c = 0; c < ncombo; ++c) {
    cb.p[c] = combos[3 * c];
    cb.q[c] = combos[3 * c + 1];
    cb.s[c] = combos[3 * c + 2];
  }
  const dim3 grid((K + ROWS - 1) / ROWS, N);
  head_counts_kernel<<<grid, ROWS, 0, (cudaStream_t)stream>>>(
      ci, cj, ck, wi, wj, wk, r2, counts, K, Kw, ns, cb, s0, s1, s2, rmax);
  return (int)cudaGetLastError();
}
