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
// are bit-equal.  K10 keeps K3's block layout (32 rows, one a lane, and 8
// warps splitting the witnesses) and distances.  It walks the balls in
// windows from ball 0 outward, all the witnesses once a window; a pair
// whose distance lies in the window adds 1 to its row's shared-memory
// histogram at its first ball by integer atomics; warp 0 then carries each
// row's count through the window up to its first failing ball, and the
// block leaves after the window in which its last open row fails.
// - Culling, per warp and slice of 32 witnesses, one alias combo a lane: a
//   combo is dropped where the offsets of the rows' and witnesses' boxes
//   cannot meet the rmax box or the least distance they allow is past the
//   window's last ball, and the slice is skipped where one combo holds
//   every pair in the rmax box at or below the window's lower edge
//   (those pairs were counted in an earlier window).  The box distances
//   use the pair's rounded operations, and rounding is monotone, so no
//   count moves.
// - The first ball inside the window: a 1,024-bucket index over its r2
//   (bucket(d) monotone in d) gives a start at or below it, and a short
//   forward scan of r2 finds it.
// - A slice of one witness repeated (the engine's padding witnesses,
//   which its padding rows meet at distance 0) takes one pair a row,
//   counted for all of them.
// - Sentinel rows (at 2^20 or beyond on every axis; no witness reaches
//   them) stay out of the boxes, and a block of sentinels only writes the
//   first ball with T > 0 and returns.
//
// What bounds K10.  Device memory traffic is small (coordinates in, an
// int64 a row out); the work is the pairs inside each window's cut: a
// distance over the live combos, the search and an atomic, a chain of
// dependent shared-memory loads and integer work.  Latency is hidden by
// resident warps, so the window is sized for residency, not for the
// histogram (ops/ci_cuda.py:tail_window): the widest window at which 4
// blocks (32 warps) share an SM, ~766 balls with 16-bit counts (~57 KB a
// block) and ~406 with 32-bit ones, where one window of every ball (161
// KB at the adult cell's 2,243 balls) held one block of 8 warps.  The
// launch bound holds the registers at 64 for that residency.  Counts are
// 16 bits, two to a word, wherever Kw < 65,536 (a count never exceeds Kw,
// so a half never carries into its neighbour), else 32 bits.  On an H100
// 80GB HBM3 at 700 W the adult cell's batch (16 x 32,768 rows against
// 32,768 witnesses, 2,243 balls) took 136 ms in one window of 8 warps an
// SM, 42 ms in windows of 766 at 32, 24 ms with the index, 20 ms with a
// combo a lane and 11.7 ms with the one-point slices; before those last
// two, timing variants put the pairs at ~90 % and the walk with its culls
// at ~10 % (no hardware counters are readable there).
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

// The box (min, max per axis) of the warp's values where ok.  Some lane of
// the warp is always ok (lane 0 holds a center and a witness; K10 boxes
// only blocks with a real row), so no box is empty.
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
constexpr int TAIL_BLOCKS = 4;         // blocks an SM K10's window is sized for
constexpr int BUCKETS = 1024;          // the first-ball search's index
constexpr int SENT_MIN = 1 << 20;      // a center at or past this on every
                                       // axis is a sentinel
constexpr int MAX_DEVICES = 64;        // cards whose K10 opt-in is remembered

template <bool WIDE>
__host__ __device__ __forceinline__ int hist_words(int bins) {
  return WIDE ? bins : (bins + 1) / 2;
}

template <bool WIDE>
__device__ __forceinline__ void hist_add(unsigned* h, int b, int l,
                                         unsigned n) {
  if (WIDE)
    atomicAdd(&h[b * CW + l], n);
  else
    atomicAdd(&h[(b >> 1) * CW + l], n << ((b & 1) << 4));
}

template <bool WIDE>
__device__ __forceinline__ int hist_get(const unsigned* h, int b, int l) {
  if (WIDE) return (int)h[b * CW + l];
  return (int)((h[(b >> 1) * CW + l] >> ((b & 1) << 4)) & 0xffffu);
}

// The bucket of a squared distance d >= base in the first-ball search's
// index: rounding and truncation are monotone, so it never falls as d
// grows.
__device__ __forceinline__ int bucket(float d, float base, float inv) {
  return min(BUCKETS - 1,
             max(0, __float2int_rz(__fmul_rn(__fsub_rn(d, base), inv))));
}

template <int NC, bool WIDE>
__global__ void __launch_bounds__(THREADS, TAIL_BLOCKS) tail_balls_kernel(
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
  unsigned short* s_start = (unsigned short*)(s_T + wbins);
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
  // Every warp holds the same 32 rows, so `real` and the block's exit
  // below agree in every warp.
  const bool real = has && !(vi >= SENT_MIN && vj >= SENT_MIN &&
                             vk >= SENT_MIN);

  // Warp 0's lane l: its row's count below the window, and its result.
  int below = 0;
  long long res = nb;
  bool open = has;

  if (!__any_sync(FULL, real)) {
    // Sentinels only: every count is 0, so each row fails at the first
    // ball with T > 0.
    if (w == 0 && has) {
      int j = 0;
      while (j < nb && T[j] <= 0) ++j;
      out[cbase + row] = j;
    }
    return;
  }
  const Box cbox = warp_box(vi, vj, vk, real);
  // Lane k < NC holds the shift of alias combo k for the slices' tests.
  int sh[3] = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < NC; ++k)
    if (l == k) {
      sh[0] = cb.p[k];
      sh[1] = cb.q[k];
      sh[2] = cb.s[k];
    }

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
    // The first-ball search's index: d falls in bucket
    // bucket(d) = min(BUCKETS - 1, (int)((d - base) * inv)), monotone in d,
    // and s_start[b] counts the window's balls in buckets below b, all of
    // them below any d in bucket b: a search starts there.
    const float base = b0 > 0 ? lo2 : 0.f;
    const float span = __fsub_rn(hi2, base);
    const float inv = span > 0.f ? __fdiv_rn((float)BUCKETS, span) : 0.f;
    for (int b = t; b < BUCKETS; b += THREADS) {
      int lo = 0, hi = nbw;           // the first ball of bucket >= b
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bucket(s_r2[mid], base, inv) < b) lo = mid + 1;
        else hi = mid;
      }
      s_start[b] = (unsigned short)lo;
    }
    __syncthreads();

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
      // Lane k < NC tests combo k: it is live where some pair of the boxes
      // may lie in the window (its offsets meet the rmax box and the least
      // distance is within hi2).  The slice adds nothing where one combo
      // holds every pair inside the rmax box at most lo2 away (dmin is
      // then <= lo2).
      bool lane_live = false, lane_inner = false;
      if (l < NC) {
        int m[3], f[3];
        bool in = true, all_in = true;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const int lo = wbox.lo[x] - cbox.hi[x] + sh[x];
          const int hi = wbox.hi[x] - cbox.lo[x] + sh[x];
          in = in && lo <= rmax && hi >= -rmax;
          all_in = all_in && lo >= -rmax && hi <= rmax;
          m[x] = least_abs(lo, hi);
          f[x] = max(-lo, hi);
        }
        lane_live = in && dist2(m[0], m[1], m[2], s0, s1, s2) <= hi2;
        lane_inner = all_in && dist2(f[0], f[1], f[2], s0, s1, s2) <= lo2;
      }
      const unsigned live = __ballot_sync(FULL, lane_live);
      if (live == 0u || __any_sync(FULL, lane_inner)) continue;

      // A slice of one witness repeated (the engine's padding witnesses)
      // puts a row's every pair at one distance: its first pair counts nw.
      const bool point = wbox.lo[0] == wbox.hi[0] &&
                         wbox.lo[1] == wbox.hi[1] && wbox.lo[2] == wbox.hi[2];
      const int pairs = point ? 1 : nw;
      const unsigned weight = point ? (unsigned)nw : 1u;
      for (int x = 0; x < pairs; ++x) {
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
        if (real && dmin > lo2 && dmin <= hi2) {
          // the window's first ball j with dmin <= r2[j]; dmin <= hi2
          // ends the scan by nbw - 1
          int j = s_start[bucket(dmin, base, inv)];
          while (s_r2[j] < dmin) ++j;
          hist_add<WIDE>(hist, j, l, weight);
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

// The K10 instance for (ncombo, wide), opted in once per card to the most
// dynamic shared memory a block may take; null on an error.
template <int NC, bool WIDE>
const void* opted_in(cudaError_t* err) {
  static int done[MAX_DEVICES] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return nullptr;
  const void* fn = (const void*)tail_balls_kernel<NC, WIDE>;
  if (dev < MAX_DEVICES && done[dev]) return fn;
  int optin = 0;
  cudaFuncAttributes attr;
  *err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
  if (*err == cudaSuccess) *err = cudaFuncGetAttributes(&attr, fn);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin - (int)attr.sharedSizeBytes);
  if (*err != cudaSuccess) return nullptr;
  if (dev < MAX_DEVICES) done[dev] = 1;
  return fn;
}

// (ncombo, wide) -> the opted-in instance, or null with *err set.
const void* tail_instance(int ncombo, bool wide, cudaError_t* err) {
  if (ncombo == 1)
    return wide ? opted_in<1, true>(err) : opted_in<1, false>(err);
  return wide ? opted_in<MAXCOMBO, true>(err) : opted_in<MAXCOMBO, false>(err);
}

// Dynamic shared memory of a window of bins: the histogram, then its
// r2 and T, then the search's index.
size_t tail_smem(int bins, bool wide) {
  const int words = wide ? hist_words<true>(bins) : hist_words<false>(bins);
  return (size_t)words * CW * sizeof(unsigned) +
         (size_t)bins * (sizeof(float) + sizeof(int)) +
         BUCKETS * sizeof(unsigned short);
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
                             int N, int R, int Kw, int nb, int wbins,
                             const int* combos, int ncombo, float s0,
                             float s1, float s2, int rmax, void* stream) {
  if (N < 1 || N > 65535 || R < 1 || Kw < 1 || nb < 0 || wbins < 1 ||
      (ncombo != 1 && ncombo != MAXCOMBO))
    return (int)cudaErrorInvalidValue;
  Combos cb = {};
  for (int k = 0; k < ncombo; ++k) {
    cb.p[k] = combos[3 * k];
    cb.q[k] = combos[3 * k + 1];
    cb.s[k] = combos[3 * k + 2];
  }
  cudaError_t err;
  const void* fn = tail_instance(ncombo, Kw >= NARROW_KW, &err);
  if (!fn) return (int)err;
  void* args[] = {&ci, &cj, &ck, &wi, &wj, &wk, &r2, &T, &out, &R, &Kw,
                  &nb, &wbins, &cb, &s0, &s1, &s2, &rmax};
  err = cudaLaunchKernel(fn, dim3((R + CW - 1) / CW, N), dim3(THREADS), args,
                         tail_smem(wbins, Kw >= NARROW_KW),
                         (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// What K10's window is sized from, for the card in use and the instance of
// (ncombo, wide): out[0..6] = shared memory an SM, opt-in shared memory a
// block, shared memory reserved a block, registers an SM, threads an SM,
// the kernel's registers a thread and its static shared memory.
extern "C" int vj_tail_limits(int ncombo, int wide, int* out) {
  if (ncombo != 1 && ncombo != MAXCOMBO) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const void* fn = tail_instance(ncombo, wide != 0, &err);
  if (!fn) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[5] = {
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrMaxThreadsPerMultiProcessor};
  for (int i = 0; i < 5 && err == cudaSuccess; ++i)
    err = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  out[5] = fa.numRegs;
  out[6] = (int)fa.sharedSizeBytes;
  return 0;
}

// The occupancy API's resident blocks an SM for K10 at a window of bins.
extern "C" int vj_tail_resident(int ncombo, int wide, int bins, int* blocks) {
  if ((ncombo != 1 && ncombo != MAXCOMBO) || bins < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const void* fn = tail_instance(ncombo, wide != 0, &err);
  if (!fn) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, THREADS, tail_smem(bins, wide != 0));
}
