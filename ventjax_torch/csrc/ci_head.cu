// CI pairwise head-phase counts (K3) and the tail's first failing balls
// (K10) for Hopper (sm_90a), plain C interface.
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
// K10 tail_balls replaces no Pallas kernel: ventjax's tail is jnp.sort over
// [N, rows, Kw] distances (ventjax/ops/ci_pairwise.py), and K10's plain
// version (ops/ci_cuda.py:tail_balls_plain) is that sort.  For each tail
// row it returns the first ball j < nb with cumcount_j < T_j, where
// cumcount_j = #{ w : dmin2 <= r2[j] }, or nb where there is none; the
// caller passes nb = j_cap, so that is the sort path's clamped index.
// cumcount_j < T_j is the sort test sorted[T_j - 1] > r2[j], so the two
// are bit-equal.  K10 keeps K3's block layout, distances and per-warp
// culling, with the last tested ball r2[nb - 1] as the cut: a pair beyond
// it moves no tested count.  A pair inside adds 1 to its row's
// shared-memory histogram at its first ball, searchsorted(r2[:nb], d2,
// left), by integer atomics; warp 0 then runs each row's prefix sum up to
// its first failing ball.
//
// What bounds K10.  As K3: the pairs it must look at, with coordinates in
// and one int64 a row out.  Its shared memory is the histogram, nb bins of
// 32 rows, and it sets how many blocks an SM holds.  Counts are 16 bits,
// two to a word, wherever Kw < 65,536 (a count never exceeds Kw, so a half
// never carries into its neighbour): at Kw 8,192 (nb 875) a block takes
// 63 KB, three to an SM, where 32-bit counts (119 KB) leave one.  On an
// H100 80GB HBM3 at 700 W the severe cohort's tail (16 x 8,192 rows, 1,411
// of them live, against 8,192 witnesses) took 1.41 ms with 16-bit counts
// and 2.50 ms with 32-bit ones.  At Kw >= 65,536 counts are 32 bits.  Where the bins do not fit a block's opt-in
// shared memory (32-bit counts past ~1,700 balls: the halo engine's slab
// plus halo witnesses), the kernel walks the balls in windows, all the
// witnesses once a window, carrying each row's count below the window, and
// stops when its 32 rows are resolved.
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

// K10: the histogram of one window of balls, nbw bins of CW rows; with
// 16-bit counts ball b's count is the low half of word b / 2 when b is
// even and the high half when it is odd.
constexpr int NARROW_KW = 65536;       // Kw below which 16-bit counts hold
constexpr int MAX_DEVICES = 64;        // cards whose K10 opt-in is remembered

template <bool WIDE>
__host__ __device__ __forceinline__ int hist_words(int bins) {
  return WIDE ? bins : (bins + 1) / 2;
}

template <bool WIDE>
__device__ __forceinline__ void hist_add(unsigned* h, int b, int l) {
  if (WIDE)
    atomicAdd(&h[b * CW + l], 1u);
  else
    atomicAdd(&h[(b >> 1) * CW + l], 1u << ((b & 1) << 4));
}

template <bool WIDE>
__device__ __forceinline__ int hist_get(const unsigned* h, int b, int l) {
  if (WIDE) return (int)h[b * CW + l];
  return (int)((h[(b >> 1) * CW + l] >> ((b & 1) << 4)) & 0xffffu);
}

// Dynamic shared memory of a window of bins: the histogram, then its
// r2 and T.
template <bool WIDE>
size_t tail_smem(int bins) {
  return (size_t)hist_words<WIDE>(bins) * CW * sizeof(unsigned) +
         (size_t)bins * (sizeof(float) + sizeof(int));
}

template <int NC, bool WIDE>
__global__ void __launch_bounds__(THREADS) tail_balls_kernel(
    const int* __restrict__ ci, const int* __restrict__ cj,
    const int* __restrict__ ck, const int* __restrict__ wi,
    const int* __restrict__ wj, const int* __restrict__ wk,
    const float* __restrict__ r2, const int* __restrict__ T,
    long long* __restrict__ out, int R, int Kw, int nb, int wbins,
    Combos cb, float s0, float s1, float s2, int rmax) {
  extern __shared__ unsigned tail_shared[];
  unsigned* hist = tail_shared;
  float* s_r2 = (float*)(hist + hist_words<WIDE>(wbins) * CW);
  int* s_T = (int*)(s_r2 + wbins);
  __shared__ int s_open;

  const int n = blockIdx.y;
  const int t = threadIdx.x;
  const int l = t & 31;
  const int w = t >> 5;
  const int row = blockIdx.x * CW + l;
  const bool has = row < R;
  const size_t cbase = (size_t)n * R;
  const size_t wbase = (size_t)n * Kw;
  const int vi = has ? ci[cbase + row] : 0;
  const int vj = has ? cj[cbase + row] : 0;
  const int vk = has ? ck[cbase + row] : 0;
  const Box cbox = warp_box(vi, vj, vk, has);

  // Warp 0's lane l: its row's count below the window, and its result.
  int below = 0;
  long long res = nb;
  bool open = has;

  for (int b0 = 0; b0 < nb; b0 += wbins) {
    const int nbw = min(wbins, nb - b0);
    for (int i = t; i < hist_words<WIDE>(nbw) * CW; i += THREADS)
      hist[i] = 0u;
    for (int i = t; i < nbw; i += THREADS) {
      s_r2[i] = r2[b0 + i];
      s_T[i] = T[b0 + i];
    }
    __syncthreads();
    // A pair counts in this window iff lo2 < dmin <= hi2.
    const float lo2 = b0 > 0 ? r2[b0 - 1] : -INFINITY;
    const float hi2 = s_r2[nbw - 1];
    int top = 1;                      // the largest power of two <= nbw
    while (2 * top <= nbw) top *= 2;

    // K3's witness walk: warp w takes witnesses [w0, w0 + 32) for w0 =
    // 32 w, 32 (w + WARPS), ...; the next slice loads while this one runs.
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
        if (in && dist2(m[0], m[1], m[2], s0, s1, s2) <= hi2)
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
        if (has && dmin > lo2 && dmin <= hi2) {
          // the window's first ball j with dmin <= r2[j]
          int j = 0;
          for (int s = top; s > 0; s >>= 1)
            if (j + s <= nbw && s_r2[j + s - 1] < dmin) j += s;
          hist_add<WIDE>(hist, j, l);
        }
      }
    }
    __syncthreads();

    // Warp 0: each open row's running count through the window, up to its
    // first failing ball; then whether any row of the block is open.
    if (w == 0) {
      for (int j = 0; open && j < nbw; ++j) {
        below += hist_get<WIDE>(hist, j, l);
        if (below < s_T[j]) {
          res = b0 + j;
          open = false;
        }
      }
      const bool any_open = __any_sync(FULL, open);
      if (l == 0) s_open = any_open;
    }
    __syncthreads();
    if (!s_open) break;
  }
  if (w == 0 && has) out[cbase + row] = res;
}

// Launch K10 with nb bins in windows of the most that fit the device's
// opt-in shared memory, opting in once per card and instance.
template <int NC, bool WIDE>
int launch_tail(const int* ci, const int* cj, const int* ck, const int* wi,
                const int* wj, const int* wk, const float* r2, const int* T,
                long long* out, int N, int R, int Kw, int nb, Combos cb,
                float s0, float s1, float s2, int rmax, cudaStream_t st) {
  static int dyn_max[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int cap = dev < MAX_DEVICES ? dyn_max[dev] : 0;
  if (cap == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    cap = optin - 256;                // room for the static s_open
    err = cudaFuncSetAttribute(tail_balls_kernel<NC, WIDE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cap);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) dyn_max[dev] = cap;
  }
  int wbins = nb > 0 ? nb : 1;
  while (tail_smem<WIDE>(wbins) > (size_t)cap) wbins = wbins * 7 / 8;
  while (tail_smem<WIDE>(wbins + 1) <= (size_t)cap && wbins < nb) ++wbins;
  const dim3 grid((R + CW - 1) / CW, N);
  tail_balls_kernel<NC, WIDE><<<grid, THREADS, tail_smem<WIDE>(wbins), st>>>(
      ci, cj, ck, wi, wj, wk, r2, T, out, R, Kw, nb, wbins, cb, s0, s1, s2,
      rmax);
  return (int)cudaGetLastError();
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

extern "C" int vj_tail_balls(const int* ci, const int* cj, const int* ck,
                             const int* wi, const int* wj, const int* wk,
                             const float* r2, const int* T, long long* out,
                             int N, int R, int Kw, int nb, const int* combos,
                             int ncombo, float s0, float s1, float s2,
                             int rmax, void* stream) {
  if (N < 1 || N > 65535 || R < 1 || Kw < 1 || nb < 0 ||
      (ncombo != 1 && ncombo != MAXCOMBO))
    return (int)cudaErrorInvalidValue;
  Combos cb = {};
  for (int k = 0; k < ncombo; ++k) {
    cb.p[k] = combos[3 * k];
    cb.q[k] = combos[3 * k + 1];
    cb.s[k] = combos[3 * k + 2];
  }
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = Kw >= NARROW_KW;
  if (ncombo == 1)
    return wide ? launch_tail<1, true>(ci, cj, ck, wi, wj, wk, r2, T, out, N,
                                       R, Kw, nb, cb, s0, s1, s2, rmax, st)
                : launch_tail<1, false>(ci, cj, ck, wi, wj, wk, r2, T, out,
                                        N, R, Kw, nb, cb, s0, s1, s2, rmax,
                                        st);
  return wide ? launch_tail<MAXCOMBO, true>(ci, cj, ck, wi, wj, wk, r2, T,
                                            out, N, R, Kw, nb, cb, s0, s1,
                                            s2, rmax, st)
              : launch_tail<MAXCOMBO, false>(ci, cj, ck, wi, wj, wk, r2, T,
                                             out, N, R, Kw, nb, cb, s0, s1,
                                             s2, rmax, st);
}
