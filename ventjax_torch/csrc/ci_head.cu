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
// integers, so the result is bit-equal to the plain PyTorch version in any
// order of the adds.
//
// What bounds it on this card.  Device memory traffic is coordinates in
// and counts out (about a microsecond); the work is integer and float32
// arithmetic per (center, witness, live combo) pair, about 20
// instructions, and a first-ball search and a shared-memory atomic for
// the pairs inside the head balls.  So it is bound by how many pairs it
// must look at and how well the card is filled while it does.  The design:
// - fill the card: a block holds 32 centers (one per lane of every warp)
//   and its 8 warps split the witness axis, each taking 32 witnesses at a
//   time; their counts meet in one shared histogram through integer
//   atomics.  At K 512 and N 16 that is 256 blocks of 8 warps, where one
//   warp per 64 centers walked all the witnesses before;
// - cull per warp: a warp tests each alias combo against the boxes of its
//   32 centers and of its 32 witnesses on all three axes, and drops it
//   where the offset cannot meet the rmax box or where the least distance
//   the two boxes allow, computed with the same rounded operations as a
//   pair's, is beyond the last head ball.  Rounding is monotone, so such a
//   combo gives no pair a distance inside the head: dropping it changes no
//   count.  Sentinel rows (+-2^20 coordinates) only widen the boxes;
// - the combo count is a template argument (1 for "pad", 9 for "wrap",
//   the only counts the geometry gives), so the combo loop is unrolled and
//   its culling mask is uniform over the warp.
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

constexpr int CW = 32;                 // centers per block, one per lane
constexpr int WARPS = 8;               // warps splitting the witnesses
constexpr int THREADS = CW * WARPS;
constexpr int MAXNS = 128;
constexpr int MAXCOMBO = 9;
constexpr unsigned FULL = 0xffffffffu;

struct Combos {
  int p[MAXCOMBO], q[MAXCOMBO], s[MAXCOMBO];
};

// The scaled squared distance of an offset, as the exactness proof has it.
__device__ __forceinline__ float dist2(int oi, int oj, int ok, float s0,
                                       float s1, float s2) {
  const float fx = __fmul_rn((float)oi, s0);
  const float fy = __fmul_rn((float)oj, s1);
  const float fz = __fmul_rn((float)ok, s2);
  return __fadd_rn(__fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)),
                   __fmul_rn(fz, fz));
}

// The least |x| over the integers of [lo, hi].
__device__ __forceinline__ int least_abs(int lo, int hi) {
  return lo > 0 ? lo : (hi < 0 ? -hi : 0);
}

// The box (min, max per axis) of the warp's values where ok.  Lane 0 of a
// warp always holds a center and a witness, so no box is empty.
struct Box {
  int lo[3], hi[3];
};
__device__ __forceinline__ Box warp_box(int a, int b, int c, bool ok) {
  Box x;
  const int v[3] = {a, b, c};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x.lo[k] = __reduce_min_sync(FULL, ok ? v[k] : INT_MAX);
    x.hi[k] = __reduce_max_sync(FULL, ok ? v[k] : INT_MIN);
  }
  return x;
}

template <int NC>
__global__ void __launch_bounds__(THREADS) head_counts_kernel(
    const int* __restrict__ ci, const int* __restrict__ cj,
    const int* __restrict__ ck, const int* __restrict__ wi,
    const int* __restrict__ wj, const int* __restrict__ wk,
    const float* __restrict__ r2, int* __restrict__ counts, int K, int Kw,
    int ns, Combos cb, float s0, float s1, float s2, int rmax) {
  __shared__ int hist[MAXNS * CW];     // hist[ball * CW + center]
  __shared__ float s_r2[MAXNS];

  const int n = blockIdx.y;
  const int t = threadIdx.x;
  const int l = t & 31;
  const int w = t >> 5;
  const int row0 = blockIdx.x * CW;
  const int row = row0 + l;
  const bool has = row < K;
  const size_t cbase = (size_t)n * K;
  const size_t wbase = (size_t)n * Kw;
  const int vi = has ? ci[cbase + row] : 0;
  const int vj = has ? cj[cbase + row] : 0;
  const int vk = has ? ck[cbase + row] : 0;

  for (int i = t; i < ns * CW; i += THREADS) hist[i] = 0;
  for (int i = t; i < ns; i += THREADS) s_r2[i] = r2[i];
  __syncthreads();
  const float r2_head = s_r2[ns - 1];
  const Box cbox = warp_box(vi, vj, vk, has);

  // Warp w takes witnesses [w0, w0 + 32) for w0 = 32 w, 32 (w + WARPS), ...
  // Lane l holds witness w0 + l; the next slice's coordinates are loaded
  // while this one is counted.
  const int step = CW * WARPS;
  int w0 = w * CW;
  int a = 0, b = 0, c = 0;
  if (w0 + l < Kw) {
    a = wi[wbase + w0 + l];
    b = wj[wbase + w0 + l];
    c = wk[wbase + w0 + l];
  }
  for (; w0 < Kw; w0 += step) {
    const int nw = min(CW, Kw - w0);
    const int xa = a, xb = b, xc = c;
    if (w0 + step + l < Kw) {
      a = wi[wbase + w0 + step + l];
      b = wj[wbase + w0 + step + l];
      c = wk[wbase + w0 + step + l];
    }
    const Box wbox = warp_box(xa, xb, xc, l < nw);
    // Combo k is live for this (centers, witnesses) pair of boxes iff its
    // offset interval meets the rmax box on every axis and the least
    // distance over the boxes is within the last head ball.
    unsigned live = 0u;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int sh[3] = {cb.p[k], cb.q[k], cb.s[k]};
      int m[3];
      bool in = true;
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const int lo = wbox.lo[x] - cbox.hi[x] + sh[x];
        const int hi = wbox.hi[x] - cbox.lo[x] + sh[x];
        in = in && lo <= rmax && hi >= -rmax;
        m[x] = least_abs(lo, hi);
      }
      if (in && dist2(m[0], m[1], m[2], s0, s1, s2) <= r2_head)
        live |= 1u << k;
    }
    if (live == 0u) continue;

    for (int x = 0; x < nw; ++x) {
      const int oi0 = __shfl_sync(FULL, xa, x) - vi;
      const int oj0 = __shfl_sync(FULL, xb, x) - vj;
      const int ok0 = __shfl_sync(FULL, xc, x) - vk;
      float dmin = INFINITY;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (!((live >> k) & 1u)) continue;
        const int oi = oi0 + cb.p[k];
        const int oj = oj0 + cb.q[k];
        const int ok = ok0 + cb.s[k];
        if (abs(oi) > rmax || abs(oj) > rmax || abs(ok) > rmax) continue;
        dmin = fminf(dmin, dist2(oi, oj, ok, s0, s1, s2));
      }
      if (has && dmin <= r2_head) {
        // first ball j with dmin <= r2[j]: the number of r2 below dmin
        int j = 0;
#pragma unroll
        for (int s = 64; s > 0; s >>= 1)
          if (j + s <= ns && s_r2[j + s - 1] < dmin) j += s;
        atomicAdd(&hist[j * CW + l], 1);
      }
    }
  }
  __syncthreads();

  // Prefix sums per center (warp 0), then a coalesced write of the rows.
  if (w == 0) {
    int run = 0;
    for (int s = 0; s < ns; ++s) {
      run += hist[s * CW + l];
      hist[s * CW + l] = run;
    }
  }
  __syncthreads();
  const int nrows = min(CW, K - row0);
  int* out = counts + (cbase + row0) * ns;
  for (int i = t; i < nrows * ns; i += THREADS) {
    const int r = i / ns;
    out[i] = hist[(i - r * ns) * CW + r];
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
      (ncombo != 1 && ncombo != MAXCOMBO))
    return (int)cudaErrorInvalidValue;
  Combos cb = {};
  for (int k = 0; k < ncombo; ++k) {
    cb.p[k] = combos[3 * k];
    cb.q[k] = combos[3 * k + 1];
    cb.s[k] = combos[3 * k + 2];
  }
  const dim3 grid((K + CW - 1) / CW, N);
  cudaStream_t st = (cudaStream_t)stream;
  if (ncombo == 1)
    head_counts_kernel<1><<<grid, THREADS, 0, st>>>(
        ci, cj, ck, wi, wj, wk, r2, counts, K, Kw, ns, cb, s0, s1, s2, rmax);
  else
    head_counts_kernel<MAXCOMBO><<<grid, THREADS, 0, st>>>(
        ci, cj, ck, wi, wj, wk, r2, counts, K, Kw, ns, cb, s0, s1, s2, rmax);
  return (int)cudaGetLastError();
}
