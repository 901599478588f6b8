// N4's B-spline fit kernels for Hopper (sm_90a), with a plain C interface.
//
// K1  vj_fit_moment_partial    replaces ventjax/ops/n4_pallas.py:fit_moment_pallas
//     + vj_fit_moment_reduce
//     mom[n, c, d*ncp+e] = sum_p a[n,p] br[n,c,p] bc[n,d,p] bs[n,e,p]
//     (the Lee-BA fit numerator with cubed rows, denominator with squared).
// K2  vj_fit_delta_conv_field  replaces n4_pallas.py:fit_delta_conv_field_pallas
//     delta = B phi per voxel (flushed below 1e-18, times wv); the
//     done-frozen field update; the next log residual and its masked
//     min/max; ITK's convergence sums s1 = sum wv (e^-delta - 1) and
//     s2 = sum wv (e^-delta - 1)^2.
// K6  vj_fit_delta             replaces n4_pallas.py:fit_delta_pallas
//     the raw delta = B phi per voxel: no flush, no weight (padded voxels
//     hold whatever their basis rows give).
// K7  vj_fit_delta_conv        replaces n4_pallas.py:fit_delta_conv_pallas
//     d = delta flushed below 1e-18, times wv, and (s1, s2) as in K2.
// K2, K6 and K7 are one kernel body (delta_kernel) in three modes: the
// per-voxel delta, its flush and weight, the convergence sums and their
// fixed-order reductions are shared code, so K7's d and (s1, s2) equal
// K2's with done = 0 bit for bit, and flush(K6) * wv equals K7's d.
//
// K1 is two launches: vj_fit_moment_partial writes its per-chunk partials
// and vj_fit_moment_reduce adds any concatenation of them in chunk order,
// so the slabs of a compacted list (one launch a slab, each over whole
// chunks of the list) give one moment; vj_fit_fold_stats folds K2's
// per-chunk statistics (its part) as K2's last block does.
//
// Layout: basis rows are [N, ncp, P] float32 (voxel index fastest, so a
// warp reads 32 consecutive voxels of one row); vectors are [N, P]; the
// moment and phi are [N, ncp^3] with c slowest and e fastest.
//
// K1 on this card.  The least it can take is set by bytes: it reads each
// voxel's a and its 3*ncp row values once ((1 + 3 ncp) * 4 B per voxel) and
// writes ncp^3 floats per lane.  A voxel's row has at most 4 non-zero
// entries per axis, so only 64 of its ncp^3 products can be non-zero.  The
// kernel (moment_partial) keeps that arithmetic off the critical path:
// - register tiling: a thread owns a voxel at a time and a warp owns the
//   row c of the moment, so the thread reads a*br[c] and its bs row once and
//   adds EW products per bc value it reads, all from registers;
// - skipped zero rows: compacted voxels come in raster order, so a batch of
//   32 voxels touches a narrow window of c and of d.  A warp skips a batch
//   where a*br[c] is 0 throughout, and every thread skips the d rows that
//   are 0 throughout the batch (a per-batch bit mask made when the tile is
//   staged).  Adding an exact 0 to a float sum changes no bit, so the
//   skips give the bits of the same kernel without them;
// - every thread busy at every ncp: below ncp 8 two (or more) groups of
//   warps split each tile's batches and their sums are added in group
//   order; above ncp 11 the e axis is split over a third grid dimension, so
//   the registers a thread holds stay bounded;
// - rows staged into shared memory with 16-byte cp.async copies (4-byte
//   ones where P is not a multiple of 4), in a ring of three tiles, so two
//   are in flight while one is added up.
// Each warp then adds its 32 threads' partials in a fixed order (through a
// transpose in shared memory), and a second small kernel adds the chunks in
// chunk order, so every run gives the same bits.  It replaces a kernel in
// which each thread owned moment entries and issued three shared-memory
// loads per multiply-add over all ncp^3 products.
//
// K2 (and K6, K7) on this card.  The least it can take is set by bytes:
// 3*ncp rows and three vectors in, two vectors out per voxel (K6: the rows
// in, one vector out; K7: rows and wv in, one out).  The kernel
// (delta_kernel) streams those bytes with all of a voxel's loads issued
// before its arithmetic, and keeps the contraction off the critical path:
// - a thread loads its voxel's 3*ncp row values straight into registers
//   (warps read 32 consecutive voxels of a row: coalesced) and its vectors
//   beside them; with three blocks an SM (80 registers a thread up to
//   ncp 11) the 384 blocks of the slice run in one wave, and the loads in
//   flight cover the memory latency.  Staging the rows through shared
//   memory with cp.async, as K1 does, measured slower at ncp 5 to 11 and no
//   faster at ncp 4: here each row value is used by one thread only;
// - a windowed contraction: a voxel's row has at most 4 non-zero entries
//   per axis, so above ncp 4 each thread finds, from bit masks of its
//   non-zero rows, the 4-wide window of each axis, picks the window's
//   values by selects (registers take no runtime index) and contracts over
//   4 x 4 x 4 entries of phi (read from shared memory at per-thread
//   offsets) instead of ncp^3.  A warp in which some voxel has a non-zero
//   row outside its window (random rows, not N4's) takes the full
//   contraction, uniformly;
// - the per-lane statistics folded in: the last block of a lane, found by
//   a self-resetting ticket, adds the chunks' partials in chunk order, so
//   a call is one launch.
// Bits.  Only exact zeros are skipped, and the association stays g over e,
// h over d, raw over c, each ascending with one fma per term: adding an
// exact zero product leaves a float sum unchanged, so delta, field', logu'
// and K7's d are the bits of the full contraction for finite phi (0 * inf
// in a skipped term would be NaN there: non-finite phi is outside that).
// A thread takes the same voxels in the same order as before (voxel t +
// 256 i of its 2048-voxel chunk) and the reductions are the same trees, so
// the statistics keep their bits too.  What still bounds it: the memory
// system's rate for this access pattern (3*ncp row streams, 4 bytes per
// thread from each), not the arithmetic: an exploratory build that skipped
// the contraction altogether was barely faster.
//
// Why float32.  The Pallas kernels fed bf16 operands to the TPU's matrix
// unit.  Here the products run on the CUDA cores, where f32 costs the
// same instruction, and f32 keeps the kernels on the plain PyTorch version's
// algorithm (which the CPU path runs) up to summation order.
//
// Determinism.  Hopper has no sequential grid to carry a sum from one block
// to the next, and float atomics would reorder the sums from run to run,
// which would let N4's convergence test (and so each lane's iteration
// count) vary.  Each block therefore writes partial sums for its own voxel
// chunk, and the chunks are added in a fixed order: by a second small
// kernel for K1, by the last block of each lane for K2 and K7.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (never --use_fast_math), by ventjax_torch/_build.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXCP = 16;       // largest ncp the kernels take
constexpr int CHUNK = 2048;     // voxels per block (one partial sum each)
constexpr int K2_THREADS = 256;
constexpr int MAX_DEVICES = 64;   // cards whose K1 opt-in is remembered
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// K1.  One block per (voxel chunk, lane, e-range).  Warp w owns moment row
// c = w % NCP for e in [e0, e0 + EW) and every d, and voxel group
// g = w / NCP; each of its 32 threads walks its own voxels (voxel
// b*32 + thread of every batch b of the group) and keeps the partial sums
// acc[d][e] in registers.  Per voxel a thread reads a*br[c] and its bs row
// once, and for each d one bc value, then adds EW products: about one
// shared-memory load per EW multiply-adds, against three per multiply-add
// in a layout where threads own entries and share voxels.
template <int NCP>
struct MomentCfg {
  static constexpr int EW = NCP <= 11 ? NCP : 4;      // e entries per warp
  static constexpr int NER = (NCP + EW - 1) / EW;     // e-ranges (grid z)
  static constexpr int G = NCP >= 8 ? 1 : (NCP >= 3 ? 2 : 8 / NCP);
  static constexpr int WARPS = NCP * G;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int E = NCP * EW;                  // entries per warp
  static constexpr int ROWS = 1 + 3 * NCP;            // a, br, bc, bs rows
};
constexpr int TP = 256;         // voxels per staged tile
constexpr int NB = TP / 32;     // 32-voxel batches per tile
constexpr int SCR = 32 * 33;    // a warp's transpose scratch (floats)
constexpr int STAGES = 3;       // tiles in the ring: two in flight

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the rows of voxels [t0, t0 + TP) into tile[ROWS][TP] (row 0 = a,
// then br, bc, bs), zero past p1; 16-byte copies when vec4.
template <int NCP>
__device__ __forceinline__ void stage_tile(
    float* __restrict__ tile, const float* __restrict__ a_l,
    const float* __restrict__ br_l, const float* __restrict__ bc_l,
    const float* __restrict__ bs_l, int P, int t0, int p1, bool vec4) {
  using C = MomentCfg<NCP>;
  auto row = [&](int r) -> const float* {
    if (r == 0) return a_l;
    if (r <= NCP) return br_l + (size_t)(r - 1) * P;
    if (r <= 2 * NCP) return bc_l + (size_t)(r - 1 - NCP) * P;
    return bs_l + (size_t)(r - 1 - 2 * NCP) * P;
  };
  if (vec4) {
    for (int i = threadIdx.x; i < C::ROWS * (TP / 4); i += C::THREADS) {
      const int r = i / (TP / 4);
      const int q = (i - r * (TP / 4)) * 4;
      float* dst = tile + r * TP + q;
      const int p = t0 + q;
      if (p + 4 <= p1) {
        cp_async16(dst, row(r) + p);
      } else {
        for (int j = 0; j < 4; ++j) {
          if (p + j < p1) cp_async4(dst + j, row(r) + p + j);
          else dst[j] = 0.f;
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < C::ROWS * TP; i += C::THREADS) {
      const int r = i / TP;
      const int q = i - r * TP;
      if (t0 + q < p1) cp_async4(tile + r * TP + q, row(r) + t0 + q);
      else tile[r * TP + q] = 0.f;
    }
  }
  cp_async_commit();
}

template <int NCP>
__global__ void __launch_bounds__(MomentCfg<NCP>::THREADS) moment_partial(
    const float* __restrict__ a, const float* __restrict__ br,
    const float* __restrict__ bc, const float* __restrict__ bs,
    float* __restrict__ part, int P, int nchunk, int vec4) {
  using C = MomentCfg<NCP>;
  constexpr int S = STAGES;
  constexpr int EW = C::EW;
  constexpr int N2 = NCP * NCP;
  constexpr int TILE = C::ROWS * TP + NB;   // floats, then NB mask words
  extern __shared__ __align__(16) float smem[];

  const int lane = blockIdx.y;
  const int chunk = blockIdx.x;
  const int w = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int c = w % NCP;
  const int g = w / NCP;
  const int e0 = blockIdx.z * EW;
  const size_t rows = (size_t)lane * NCP * P;
  const float* a_l = a + (size_t)lane * P;
  const float* br_l = br + rows;
  const float* bc_l = bc + rows;
  const float* bs_l = bs + rows;

  float acc[NCP][EW];
#pragma unroll
  for (int d = 0; d < NCP; ++d)
#pragma unroll
    for (int e = 0; e < EW; ++e) acc[d][e] = 0.f;

  const int p0 = chunk * CHUNK;
  const int p1 = min(p0 + CHUNK, P);
  const int ntile = (p1 - p0 + TP - 1) / TP;
  // A ring of S tiles: S - 1 of them in flight while one is added up.
  // Every step commits one cp.async group (empty past the last tile), so
  // waiting for all but the newest S - 1 groups finds the current tile.
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < ntile)
      stage_tile<NCP>(smem + k * TILE, a_l, br_l, bc_l, bs_l, P,
                      p0 + k * TP, p1, vec4);
    else
      cp_async_commit();
  }
  for (int it = 0; it < ntile; ++it) {
    float* tile = smem + (it % S) * TILE;
    const int nx = it + S - 1;
    if (nx < ntile)
      stage_tile<NCP>(smem + (nx % S) * TILE, a_l, br_l, bc_l, bs_l, P,
                      p0 + nx * TP, p1, vec4);
    else
      cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    // Which bc rows each batch of the tile touches: the B-spline support
    // is 4 rows wide, and compacted voxels come in raster order, so a
    // batch of 32 voxels touches a narrow window of d.
    unsigned* dmask = reinterpret_cast<unsigned*>(tile + C::ROWS * TP);
    for (int b = w; b < NB; b += C::WARPS) {
      unsigned bits = 0;
#pragma unroll
      for (int d = 0; d < NCP; ++d)
        if (__any_sync(FULL, tile[(1 + NCP + d) * TP + b * 32 + t] != 0.f))
          bits |= 1u << d;
      if (t == 0) dmask[b] = bits;
    }
    __syncthreads();
    const float* s_a = tile;
    const float* s_br = tile + (1 + c) * TP;
    const float* s_bc = tile + (1 + NCP) * TP;
    const float* s_bs = tile + (1 + 2 * NCP + e0) * TP;
    for (int b = g; b < NB; b += C::G) {
      const int p = b * 32 + t;
      const float ab = s_a[p] * s_br[p];
      // A batch where a*br[c] is 0 for every voxel adds nothing to row c;
      // skipping it (and the zero d rows below) leaves every sum's bits
      // as they are, since adding an exact 0 does not change a float sum.
      if (!__any_sync(FULL, ab != 0.f)) continue;
      const unsigned dm = dmask[b];
      float sb[EW];
#pragma unroll
      for (int e = 0; e < EW; ++e)
        sb[e] = (EW == NCP || e0 + e < NCP) ? s_bs[e * TP + p] : 0.f;
#pragma unroll
      for (int d = 0; d < NCP; ++d) {
        if (dm & (1u << d)) {
          const float cd = ab * s_bc[d * TP + p];
#pragma unroll
          for (int e = 0; e < EW; ++e) acc[d][e] = fmaf(cd, sb[e], acc[d][e]);
        }
      }
    }
    __syncthreads();
  }

  // Sum each warp's 32 per-thread partials in a fixed order: 32 entries at
  // a time go through the warp's scratch (row = thread), and thread j adds
  // up column j.  Then groups are added in group order.
  float* scr = smem + w * SCR;
  constexpr int KR = (C::E + 31) / 32;
  float red[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int jj = k * 32 + j;
      if (jj < C::E) scr[t * 33 + j] = acc[jj / EW][jj % EW];
    }
    __syncwarp();
    float s = 0.f;
#pragma unroll 8
    for (int l = 0; l < 32; ++l) s += scr[l * 33 + t];
    red[k] = s;
    __syncwarp();
  }
  float* out = part + ((size_t)lane * nchunk + chunk) * (N2 * NCP);
  if constexpr (C::G == 1) {
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int jj = k * 32 + t;
      const int e = e0 + jj % EW;
      if (jj < C::E && e < NCP) out[c * N2 + (jj / EW) * NCP + e] = red[k];
    }
  } else {
    float* grp = smem + C::WARPS * SCR;     // [G][NCP][E]
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int jj = k * 32 + t;
      if (jj < C::E) grp[(g * NCP + c) * C::E + jj] = red[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < NCP * C::E; i += C::THREADS) {
      float s = grp[i];
#pragma unroll
      for (int h = 1; h < C::G; ++h) s += grp[h * NCP * C::E + i];
      const int cc = i / C::E;
      const int jj = i - cc * C::E;
      const int e = e0 + jj % EW;
      if (e < NCP) out[cc * N2 + (jj / EW) * NCP + e] = s;
    }
  }
}

template <int NCP>
size_t moment_smem() {
  using C = MomentCfg<NCP>;
  const size_t tiles = STAGES * (size_t)(C::ROWS * TP + NB) * sizeof(float);
  const size_t red = ((size_t)C::WARPS * SCR +
                      (C::G > 1 ? (size_t)C::G * NCP * C::E : 0)) *
                     sizeof(float);
  return tiles > red ? tiles : red;
}

template <int NCP>
int launch_moment(const float* a, const float* br, const float* bc,
                  const float* bs, float* part, int N, int P, int nchunk,
                  int vec4, cudaStream_t st) {
  using C = MomentCfg<NCP>;
  const size_t smem = moment_smem<NCP>();
  // the attribute is set once per kernel and device (it is per device)
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(
        moment_partial<NCP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  moment_partial<NCP><<<dim3(nchunk, N, C::NER), C::THREADS, smem, st>>>(
      a, br, bc, bs, part, P, nchunk, vec4);
  return (int)cudaGetLastError();
}

// K1, pass 2: out[lane, f] = sum over chunks in chunk order.
__global__ void reduce_chunks(const float* __restrict__ part,
                              float* __restrict__ out, int nchunk,
                              int width) {
  const int lane = blockIdx.y;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= width) return;
  const float* p = part + (size_t)lane * nchunk * width + f;
  float s = 0.f;
  for (int c = 0; c < nchunk; ++c) s += p[(size_t)c * width];
  out[(size_t)lane * width + f] = s;
}

// ---------------------------------------------------------------------------
// K2, K6 and K7: one kernel body (delta_kernel) in three modes.  One block
// per (2048-voxel chunk, lane); thread t takes voxels t, t + 256, ... of its
// chunk, and holds each voxel's 3*ncp row values in registers
// (v[c] = br[c], v[ncp + d] = bc[d], v[2 ncp + e] = bs[e]).

// What one launch of the shared delta kernel writes.
enum DeltaMode {
  RAW = 0,    // K6: out0 = raw delta; no statistics
  CONV = 1,   // K7: out0 = flushed delta * wv; stats = (s1, s2)
  FIELD = 2,  // K2: out0 = field', out1 = logu'; stats = (s1, s2, min, max)
};

// The full contraction of one voxel: raw = sum_c br[c] * sum_d bc[d] *
// sum_e phi[c, d*ncp+e] bs[e], each sum ascending, one fma per term; phi in
// shared memory, read as a broadcast.  Up to ncp 4 (N4's first level) the
// c loop is unrolled over the registers; above, it serves only rows with
// non-zeros outside a window (never N4's), so it keeps the code small: the
// loop over c is rolled and reads br[c] again (brc: this voxel's br, rows
// P apart; in: the voxel exists).
template <int NCP>
__device__ __forceinline__ float delta_full(const float* __restrict__ s_phi,
                                            const float (&v)[3 * NCP],
                                            const float* __restrict__ brc,
                                            int P, bool in) {
  constexpr int N2 = NCP * NCP;
  auto row_sum = [&](int c) {      // sum_d bc[d] sum_e phi[c, d, e] bs[e]
    const float* ph = s_phi + c * N2;
    float h = 0.f;
#pragma unroll
    for (int d = 0; d < NCP; ++d) {
      float g = 0.f;
#pragma unroll
      for (int e = 0; e < NCP; ++e)
        g = fmaf(ph[d * NCP + e], v[2 * NCP + e], g);
      h = fmaf(v[NCP + d], g, h);
    }
    return h;
  };
  float raw = 0.f;
  if constexpr (NCP <= 4) {
#pragma unroll
    for (int c = 0; c < NCP; ++c) {
      raw = fmaf(v[c], row_sum(c), raw);
      // keep the next row's phi loads below this one: hoisting all ncp^3
      // of them takes that many registers (and spills)
      asm volatile("" ::: "memory");
    }
  } else {
#pragma unroll 1
    for (int c = 0; c < NCP; ++c)
      raw = fmaf(in ? brc[(size_t)c * P] : 0.f, row_sum(c), raw);
  }
  return raw;
}

// x[i] = v[off + lo + i] for i < 4 and a runtime lo in [0, NCP - 4], by
// selects: registers take no runtime index.
template <int NCP>
__device__ __forceinline__ void pick4(const float (&v)[3 * NCP], int off,
                                      int lo, float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = v[off + i];
#pragma unroll
    for (int j = 1; j <= NCP - 4; ++j)
      if (lo == j) x[i] = v[off + j + i];
  }
}

// The same sums over the 4-wide windows starting at lc, ld, le, outside of
// which the voxel's rows are exactly 0: the terms left out are exact zeros,
// so the result has the bits of delta_full.  phi is read at per-thread
// offsets.
template <int NCP>
__device__ __forceinline__ float delta_window(
    const float* __restrict__ s_phi, const float (&v)[3 * NCP], int lc,
    int ld, int le) {
  constexpr int N2 = NCP * NCP;
  float rb[4], cb[4], sb[4];
  pick4<NCP>(v, 0, lc, rb);
  pick4<NCP>(v, NCP, ld, cb);
  pick4<NCP>(v, 2 * NCP, le, sb);
  const float* ph0 = s_phi + lc * N2 + ld * NCP + le;
  float raw = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* ph = ph0 + i * N2;
    float h = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float g = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) g = fmaf(ph[j * NCP + k], sb[k], g);
      h = fmaf(cb[j], g, h);
    }
    raw = fmaf(rb[i], h, raw);
  }
  return raw;
}

// Bit k set where row k of the axis starting at v[off] is non-zero.
template <int NCP>
__device__ __forceinline__ unsigned nonzero_rows(const float (&v)[3 * NCP],
                                                 int off) {
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < NCP; ++k) m |= (v[off + k] != 0.f ? 1u : 0u) << k;
  return m;
}

// Start of the 4-wide window that holds the non-zero rows of mask m (its
// first non-zero row, at most NCP - 4); sets wide when some non-zero row
// lies past the window.
template <int NCP>
__device__ __forceinline__ int window(unsigned m, bool& wide) {
  const int lo = m == 0u ? 0 : min(__ffs(m) - 1, NCP - 4);
  wide |= (m >> lo) > 15u;
  return lo;
}

// The raw delta of one voxel.  Every lane of the warp calls it (voxels past
// the chunk hold zero rows).
template <int NCP>
__device__ __forceinline__ float delta_voxel(const float* __restrict__ s_phi,
                                             const float (&v)[3 * NCP],
                                             const float* __restrict__ brc,
                                             int P, bool in) {
  if constexpr (NCP <= 4) {
    return delta_full<NCP>(s_phi, v, brc, P, in);   // the window: the axis
  } else {
    bool wide = false;
    const int lc = window<NCP>(nonzero_rows<NCP>(v, 0), wide);
    const int ld = window<NCP>(nonzero_rows<NCP>(v, NCP), wide);
    const int le = window<NCP>(nonzero_rows<NCP>(v, 2 * NCP), wide);
    if (__any_sync(FULL, wide)) return delta_full<NCP>(s_phi, v, brc, P, in);
    return delta_window<NCP>(s_phi, v, lc, ld, le);
  }
}

// The field update of one voxel: raw flushed below 1e-18, times its weight.
__device__ __forceinline__ float flush_weight(float raw, float w) {
  return (fabsf(raw) < 1e-18f ? 0.f : raw) * w;
}

// ITK's convergence sums of one voxel, added into a thread's running
// (s1, s2): s1 += w (e^-d - 1), s2 += w (e^-d - 1)^2.
__device__ __forceinline__ void conv_accum(float dl, float w, float& s1,
                                           float& s2) {
  const float e1 = expf(-dl) - 1.f;
  s1 += w * e1;
  s2 += w * e1 * e1;
}

// Fixed-order tree reduction over the block of NS per-thread statistics
// in red[NS][K2_THREADS]: slots 0 and 1 (s1, s2) add, slots 2 and 3 (when
// NS == 4) take the min and the max.  Thread 0 writes the block's NS
// values to out.
template <int NS>
__device__ __forceinline__ void block_stats(float (*red)[K2_THREADS],
                                            float* __restrict__ out) {
  const int t = threadIdx.x;
  __syncthreads();
  for (int s = K2_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      red[0][t] += red[0][t + s];
      red[1][t] += red[1][t + s];
      if constexpr (NS == 4) {
        red[2][t] = fminf(red[2][t], red[2][t + s]);
        red[3][t] = fmaxf(red[3][t], red[3][t + s]);
      }
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) out[i] = red[i][0];
  }
}

// Fold a lane's chunk statistics in chunk order: sums from 0 for slots
// 0-1, min and max for slots 2-3.  The block's threads load the partials
// together, K2_THREADS at a time, into buf (K2_THREADS floats of shared
// memory); NS threads fold them.
template <int NS>
__device__ __forceinline__ void fold_chunks(const float* __restrict__ part,
                                            float* __restrict__ stats,
                                            float* __restrict__ buf, int lane,
                                            int nchunk) {
  const int t = threadIdx.x;
  const float* p = part + (size_t)lane * nchunk * NS;
  float s = t < 2 ? 0.f : (t == 2 ? INFINITY : -INFINITY);
  constexpr int CPR = K2_THREADS / NS;         // chunks per round
  for (int c0 = 0; c0 < nchunk; c0 += CPR) {
    const int n = min(CPR, nchunk - c0) * NS;
    if (t < n) buf[t] = __ldcg(p + (size_t)c0 * NS + t);
    __syncthreads();
    if (t < NS) {
      for (int i = t; i < n; i += NS)
        s = t < 2 ? s + buf[i] : (t == 2 ? fminf(s, buf[i])
                                         : fmaxf(s, buf[i]));
    }
    __syncthreads();
  }
  if (t < NS) stats[(size_t)lane * NS + t] = s;
}

// The last block of a lane to finish (a ticket per lane, which atomicInc
// brings back to 0 as that block takes it) folds the chunks' statistics.
template <int NS>
__device__ __forceinline__ void fold_lane(const float* __restrict__ part,
                                          float* __restrict__ stats,
                                          unsigned* __restrict__ tickets,
                                          float* __restrict__ buf, int lane,
                                          int nchunk) {
  __shared__ bool last;
  const int t = threadIdx.x;
  if (t == 0) {
    __threadfence();           // this block's partial, before its ticket
    last = atomicInc(&tickets[lane], (unsigned)nchunk - 1u) ==
           (unsigned)nchunk - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_chunks<NS>(part, stats, buf, lane, nchunk);
}

// K2's fold on its own: one block per lane folds chunk statistics that
// launches over several slabs of one compacted list wrote, concatenated
// in chunk order.
__global__ void __launch_bounds__(K2_THREADS) fold_stats(
    const float* __restrict__ part, float* __restrict__ stats, int nchunk) {
  __shared__ float buf[K2_THREADS];
  fold_chunks<4>(part, stats, buf, blockIdx.x, nchunk);
}

// Three blocks an SM up to ncp 11 (80 registers a thread), so the 384
// blocks of the slice run in one wave; two above.
template <int NCP, int MODE>
__global__ void __launch_bounds__(K2_THREADS, NCP <= 11 ? 3 : 2) delta_kernel(
    const float* __restrict__ phi, const float* __restrict__ br,
    const float* __restrict__ bc, const float* __restrict__ bs,
    const float* __restrict__ wv, const float* __restrict__ field,
    const float* __restrict__ logv, const float* __restrict__ done,
    float* __restrict__ out0, float* __restrict__ out1,
    float* __restrict__ part, unsigned* __restrict__ tickets,
    float* __restrict__ stats, int P, int nchunk) {
  constexpr int N3 = NCP * NCP * NCP;
  constexpr int NS = MODE == FIELD ? 4 : 2;
  __shared__ float s_phi[N3];
  __shared__ float red[NS][K2_THREADS];
  const int lane = blockIdx.y;
  const int t = threadIdx.x;
  const size_t rows = (size_t)lane * NCP * P;
  const size_t vec = (size_t)lane * P;
  const int p0 = blockIdx.x * CHUNK;
  const int p1 = min(p0 + CHUNK, P);
  const float* phi_l = phi + (size_t)lane * N3;
  for (int i = t; i < N3; i += K2_THREADS) s_phi[i] = phi_l[i];
  __syncthreads();
  float live = 0.f;
  if constexpr (MODE == FIELD) live = 1.f - done[lane];
  float s1 = 0.f, s2 = 0.f, mn = INFINITY, mx = -INFINITY;
  // Every lane runs every trip (the windows' warp vote needs them all).
  for (int q = p0; q < p1; q += K2_THREADS) {
    const int p = q + t;
    const bool in = p < p1;
    // all of the voxel's loads first, then the arithmetic
    float v[3 * NCP];
#pragma unroll
    for (int k = 0; k < NCP; ++k) {
      v[k] = in ? br[rows + (size_t)k * P + p] : 0.f;
      v[NCP + k] = in ? bc[rows + (size_t)k * P + p] : 0.f;
      v[2 * NCP + k] = in ? bs[rows + (size_t)k * P + p] : 0.f;
    }
    float w = 0.f, fo = 0.f, lv = 0.f;
    if (in) {
      if constexpr (MODE != RAW) w = wv[vec + p];
      if constexpr (MODE == FIELD) {
        fo = field[vec + p];
        lv = logv[vec + p];
      }
    }
    const float raw = delta_voxel<NCP>(s_phi, v, br + rows + p, P, in);
    if (!in) continue;
    if constexpr (MODE == RAW) {
      out0[vec + p] = raw;
    } else {
      const float dl = flush_weight(raw, w);
      if constexpr (MODE == CONV) {
        out0[vec + p] = dl;
      } else {
        const float f2 = fo + live * dl;
        const float l2 = (lv - f2) * w;
        out0[vec + p] = f2;
        out1[vec + p] = l2;
        if (w > 0.f) {
          mn = fminf(mn, l2);
          mx = fmaxf(mx, l2);
        }
      }
      conv_accum(dl, w, s1, s2);
    }
  }
  if constexpr (MODE != RAW) {
    red[0][t] = s1;
    red[1][t] = s2;
    if constexpr (NS == 4) {
      red[2][t] = mn;
      red[3][t] = mx;
    }
    block_stats<NS>(red, part + ((size_t)lane * nchunk + blockIdx.x) * NS);
    fold_lane<NS>(part, stats, tickets, red[0], lane, nchunk);
  }
}

// Launch the shared delta kernel for a runtime ncp.
template <int MODE>
int launch_delta(const float* phi, const float* br, const float* bc,
                 const float* bs, const float* wv, const float* field,
                 const float* logv, const float* done, float* out0,
                 float* out1, float* part, unsigned* tickets, float* stats,
                 int N, int P, int ncp, int nchunk, cudaStream_t st) {
  const dim3 grid(nchunk, N);
#define VJ_DELTA(C)                                                          \
  case C:                                                                    \
    delta_kernel<C, MODE><<<grid, K2_THREADS, 0, st>>>(                      \
        phi, br, bc, bs, wv, field, logv, done, out0, out1, part, tickets,   \
        stats, P, nchunk);                                                   \
    break
  switch (ncp) {
    VJ_DELTA(1); VJ_DELTA(2); VJ_DELTA(3); VJ_DELTA(4);
    VJ_DELTA(5); VJ_DELTA(6); VJ_DELTA(7); VJ_DELTA(8);
    VJ_DELTA(9); VJ_DELTA(10); VJ_DELTA(11); VJ_DELTA(12);
    VJ_DELTA(13); VJ_DELTA(14); VJ_DELTA(15); VJ_DELTA(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VJ_DELTA
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

bool bad_shape(int N, int P, int ncp, int nchunk) {
  return N < 1 || N > 65535 || P < 1 || ncp < 1 || ncp > MAXCP ||
         nchunk != (P + CHUNK - 1) / CHUNK;
}

}  // namespace

extern "C" int vj_n4_chunk(void) { return CHUNK; }

extern "C" int vj_fit_moment_partial(const float* a, const float* br,
                                     const float* bc, const float* bs,
                                     float* part, int N, int P, int ncp,
                                     int nchunk, void* stream) {
  if (bad_shape(N, P, ncp, nchunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec4 = P % 4 == 0 && aligned16(a) && aligned16(br) &&
                   aligned16(bc) && aligned16(bs);
  int err;
#define VJ_MOMENT(C)                                                       \
  case C:                                                                  \
    err = launch_moment<C>(a, br, bc, bs, part, N, P, nchunk, vec4, st);   \
    break
  switch (ncp) {
    VJ_MOMENT(1); VJ_MOMENT(2); VJ_MOMENT(3); VJ_MOMENT(4);
    VJ_MOMENT(5); VJ_MOMENT(6); VJ_MOMENT(7); VJ_MOMENT(8);
    VJ_MOMENT(9); VJ_MOMENT(10); VJ_MOMENT(11); VJ_MOMENT(12);
    VJ_MOMENT(13); VJ_MOMENT(14); VJ_MOMENT(15); VJ_MOMENT(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VJ_MOMENT
  return err;
}

// part: [N, nchunk, ncp^3] partials of any number of chunks (the partials
// of several launches concatenated in chunk order) -> out [N, ncp^3].
extern "C" int vj_fit_moment_reduce(const float* part, float* out, int N,
                                    int ncp, int nchunk, void* stream) {
  if (N < 1 || N > 65535 || ncp < 1 || ncp > MAXCP || nchunk < 1)
    return (int)cudaErrorInvalidValue;
  const int n3 = ncp * ncp * ncp;
  reduce_chunks<<<dim3((n3 + 255) / 256, N), 256, 0, (cudaStream_t)stream>>>(
      part, out, nchunk, n3);
  return (int)cudaGetLastError();
}

// part: [N, nchunk, 4] chunk statistics of K2 (s1, s2, min, max), from one
// or several launches concatenated in chunk order -> stats [N, 4], folded
// as K2's last block folds them.
extern "C" int vj_fit_fold_stats(const float* part, float* stats, int N,
                                 int nchunk, void* stream) {
  if (N < 1 || N > 65535 || nchunk < 1) return (int)cudaErrorInvalidValue;
  fold_stats<<<N, K2_THREADS, 0, (cudaStream_t)stream>>>(part, stats, nchunk);
  return (int)cudaGetLastError();
}

// tickets: N unsigned ints, 0 before the launch and 0 again after it (the
// kernel's last block of each lane resets its own); part: N * nchunk * 4
// floats of scratch.
extern "C" int vj_fit_delta_conv_field(
    const float* phi, const float* br, const float* bc, const float* bs,
    const float* wv, const float* field, const float* logv, const float* done,
    float* nf, float* lu, float* part, unsigned* tickets, float* stats, int N,
    int P, int ncp, int nchunk, void* stream) {
  if (bad_shape(N, P, ncp, nchunk)) return (int)cudaErrorInvalidValue;
  return launch_delta<FIELD>(phi, br, bc, bs, wv, field, logv, done, nf, lu,
                             part, tickets, stats, N, P, ncp, nchunk,
                             (cudaStream_t)stream);
}

extern "C" int vj_fit_delta(const float* phi, const float* br,
                            const float* bc, const float* bs, float* out,
                            int N, int P, int ncp, int nchunk, void* stream) {
  if (bad_shape(N, P, ncp, nchunk)) return (int)cudaErrorInvalidValue;
  return launch_delta<RAW>(phi, br, bc, bs, nullptr, nullptr, nullptr,
                           nullptr, out, nullptr, nullptr, nullptr, nullptr, N,
                           P, ncp, nchunk, (cudaStream_t)stream);
}

// tickets and part as for vj_fit_delta_conv_field (part: N * nchunk * 2).
extern "C" int vj_fit_delta_conv(const float* phi, const float* br,
                                 const float* bc, const float* bs,
                                 const float* wv, float* d, float* part,
                                 unsigned* tickets, float* stats, int N, int P,
                                 int ncp, int nchunk, void* stream) {
  if (bad_shape(N, P, ncp, nchunk)) return (int)cudaErrorInvalidValue;
  return launch_delta<CONV>(phi, br, bc, bs, wv, nullptr, nullptr, nullptr, d,
                            nullptr, part, tickets, stats, N, P, ncp, nchunk,
                            (cudaStream_t)stream);
}
