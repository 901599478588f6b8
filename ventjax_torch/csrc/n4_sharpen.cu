// N4's histogram-sharpen kernels for Hopper (sm_90a), with a plain C interface.
//
// K4  vj_sharpen_hist_partial + vj_sharpen_hist_finish
//     replace ventjax/ops/n4_pallas.py:sharpen_hist_pallas
//     hist[n, b] = sum_p wv (1 - f) [b = floor(t)] + wv f [b = floor(t) + 1],
//     t = clip((logu - binmin) / slope, 0, bins - 1) * wv, f = t - floor(t);
//     the fractional (triangle-kernel) histogram of each lane's masked
//     log residual.
// K5  vj_sharpen_resid  replaces n4_pallas.py:sharpen_resid_pallas
//     a = flush((logu - interp(e_loc, t + 1) * wv) * wv) / max(sv, 1e-30),
//     and 0 where wv = 0: the B-spline fit target from the expectation table
//     e_loc [N, bins + 2] that the FFT chain between the two computes.
// K4 is two launches: vj_sharpen_hist_partial (the per-chunk fixed-point
// partials) and vj_sharpen_hist_finish (their sum, over any concatenation
// of partials along the chunk axis, to float32), so slabs of one lane give
// one histogram.
//
// Index guard.  A lane whose weights are all 0 has the range (+inf, -inf),
// and a constant lane has slope 0; either way (logu - binmin) / slope can be
// NaN.  fmaxf(NaN, 0) is 0, so the clip sends NaN to slot 0 (the plain
// version does the same with nan_to_num), and every slot index is clamped to
// [0, bins] before it touches memory.  K5 writes 0 where wv = 0, so such
// lanes give finite output.
//
// Determinism (K4).  Float atomics, in shared or device memory, add in an
// order that changes from run to run, and N4's convergence test can flip on
// the last bit of a sum.  Each contribution is therefore rounded once to a
// 64-bit fixed-point integer (2^-32 units; a lane's total stays below 2^63
// while sum |wv| < 2^31) and added as integers, which are associative:
// every run, and every partition of the sum over threads, blocks and
// chunks, gives the same bits.  A second kernel adds the chunk partials and
// converts to float32.  The result is the exact sum to within 2^-33 per
// contribution, closer to it than a float32 running sum.
//
// Bit-exactness (K5).  Every operation is written with the _rn intrinsics so
// that nvcc cannot contract a multiply and an add into an FMA: the kernel
// then computes exactly what the plain PyTorch version computes, op by op.
//
// What bounds them on this card.  Both read two to three float32 vectors of
// [N, P] once (K5 writes one), a few hundred KB per lane: device-memory
// bandwidth and launch latency, not arithmetic.  So the SM needs many bytes
// in flight: K5 gives each thread four consecutive voxels, read with three
// 16-byte loads (logu, wv, sv) issued before the lane's table is staged
// and before any arithmetic, and written with one float4 store; 1,024-voxel
// blocks put the slice's 48 x 16 blocks on the card in one wave.  Where P
// is not a multiple of 4 or a pointer is not 16-byte aligned, the same
// blocks read four scalars a thread, neighbouring threads on neighbouring
// voxels.  K4's danger is contention:
// once N4 has narrowed the residual, most voxels of a warp fall into one
// or two bins, and per-voxel atomics on one shared-memory address
// serialise.  K4 (hist_partial) therefore adds warp-aggregated: the lanes
// of a warp that share a slot find each other with __match_any_sync, sum
// their fixed-point contributions with shuffles (reduce_peers, log2 of the
// group size steps), and one lane of each group does the two atomics; a
// block keeps one shared histogram.  Blocks of 1,024 voxels (four per
// thread, read with 16-byte loads where P is a multiple of 4) fill the
// card at the slice's shapes.  The TPU kernels' (hi, lo) one-hot matmuls
// and double-bf16 splits were matrix-unit workarounds for a scatter and a
// gather; here a voxel adds to its own bin and reads its own table entry,
// in float32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (never --use_fast_math), by ventjax_torch/_build.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;           // voxels per K4 and K5 block: 4 a thread
constexpr int MAX_SLOTS = 768;        // bins + 2 at most
constexpr float FIX = 4294967296.0f;  // 2^32 fixed-point units per 1.0
constexpr double UNFIX = 1.0 / 4294967296.0;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

// t = clip((logu - binmin) / slope, 0, bins - 1) * wv; NaN clips to 0.
__device__ __forceinline__ float t_index(float logu, float w, float bmn,
                                         float slope, float top) {
  const float x = __fdiv_rn(__fsub_rn(logu, bmn), slope);
  return __fmul_rn(fminf(fmaxf(x, 0.f), top), w);
}

// floor(v) as a slot index in [0, bins].
__device__ __forceinline__ int slot(float fl, int bins) {
  if (!(fl >= 0.f)) return 0;
  if (fl > (float)bins) return bins;
  return (int)fl;
}

// Sum x and y over the lanes of `peers` (the lanes of this one's group),
// into the group's lowest lane: a tree over the group's members, each step
// adding the next remaining member's value and retiring every other one.
// Integer sums, so the order does not matter.  Every lane of the warp
// calls it, each with its own group.
__device__ __forceinline__ void reduce_peers(unsigned peers, long long& x,
                                             long long& y) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));   // rank within the group
  unsigned rest = peers & (0xfffffffeu << lane);   // members above this lane
  while (__any_sync(FULL, rest != 0u)) {
    const int next = __ffs(rest);                  // 1-based, 0 if none
    const long long tx = __shfl_sync(FULL, x, (next - 1) & 31);
    const long long ty = __shfl_sync(FULL, y, (next - 1) & 31);
    if (next) {
      x += tx;
      y += ty;
    }
    rest &= __ballot_sync(FULL, !(rel & 1));
    rel >>= 1;
  }
}

// One voxel's two fixed-point contributions, added warp-aggregated into the
// block's histogram h.  Every lane of the warp calls it (a lane past the
// end passes w = 0, which adds 0 to slot 0).
__device__ __forceinline__ void hist_add(float lu, float w, float bmn,
                                         float sl, float top, int bins,
                                         u64* h) {
  const float t = t_index(lu, w, bmn, sl, top);
  const float fl = floorf(t);
  const float f = __fsub_rn(t, fl);
  const int i0 = slot(fl, bins);
  long long v0 = __float2ll_rn(__fmul_rn(w, __fsub_rn(1.f, f)) * FIX);
  long long v1 = __float2ll_rn(__fmul_rn(w, f) * FIX);
  const unsigned peers = __match_any_sync(FULL, i0);
  reduce_peers(peers, v0, v1);
  if ((peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0u) {   // group leader
    if (v0 != 0) atomicAdd(h + i0, (u64)v0);
    if (v1 != 0) atomicAdd(h + i0 + 1, (u64)v1);
  }
}

// K4, pass 1: one block per (voxel chunk of CHUNK, lane); one
// fixed-point histogram per block in shared memory, written out as the
// chunk's partial.
__global__ void __launch_bounds__(THREADS) hist_partial(
    const float* __restrict__ logu, const float* __restrict__ wv,
    const float* __restrict__ binmin, const float* __restrict__ slope,
    u64* __restrict__ part, int P, int bins, int nchunk, int vec4) {
  __shared__ u64 s_hist[MAX_SLOTS];
  const int slots = bins + 2;
  const int lane = blockIdx.y;
  const int chunk = blockIdx.x;
  for (int i = threadIdx.x; i < slots; i += THREADS) s_hist[i] = 0;

  const float* lu_l = logu + (size_t)lane * P;
  const float* wv_l = wv + (size_t)lane * P;
  const float bmn = binmin[lane];
  const float sl = slope[lane];
  const float top = (float)(bins - 1);
  const int p0 = chunk * CHUNK;
  const int p = p0 + 4 * threadIdx.x;
  float lu[4] = {0.f, 0.f, 0.f, 0.f};
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec4) {
    // voxels p .. p + 3; P is a multiple of 4, so they are all in or all out
    if (p < P) {
      const float4 l4 = *reinterpret_cast<const float4*>(lu_l + p);
      const float4 w4 = *reinterpret_cast<const float4*>(wv_l + p);
      lu[0] = l4.x; lu[1] = l4.y; lu[2] = l4.z; lu[3] = l4.w;
      w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
    }
  } else {
    // scalar reads, neighbouring threads on neighbouring voxels
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = p0 + j * THREADS + threadIdx.x;
      if (q < P) {
        lu[j] = lu_l[q];
        w[j] = wv_l[q];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    hist_add(lu[j], w[j], bmn, sl, top, bins, s_hist);
  __syncthreads();
  u64* out = part + ((size_t)lane * nchunk + chunk) * slots;
  for (int i = threadIdx.x; i < slots; i += THREADS) out[i] = s_hist[i];
}

// K4, pass 2: hist[lane, b] = float32 of the chunk partials' sum, b < bins.
// A block takes 32 bins of one lane; warp k adds the chunks k, k + 8, ...
// for them, and the eight warp sums are added (integers: any order).
__global__ void __launch_bounds__(THREADS) hist_finish(
    const u64* __restrict__ part, float* __restrict__ hist, int bins,
    int nchunk) {
  __shared__ u64 s_sum[THREADS / 32][32];
  const int lane = blockIdx.y;
  const int t = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + t;
  const int slots = bins + 2;
  u64 acc = 0;
  if (b < bins) {
    const u64* p = part + (size_t)lane * nchunk * slots + b;
    for (int c = k; c < nchunk; c += THREADS / 32) acc += p[(size_t)c * slots];
  }
  s_sum[k][t] = acc;
  __syncthreads();
  if (k == 0 && b < bins) {
#pragma unroll
    for (int j = 1; j < THREADS / 32; ++j) acc += s_sum[j][t];
    hist[(size_t)lane * bins + b] = (float)((double)(long long)acc * UNFIX);
  }
}

// K5 for one voxel: interpolate the table at t + 1, the residual, its
// flush and normalisation; 0 where w = 0.
__device__ __forceinline__ float resid_one(float lu, float w, float sv,
                                           const float* s_e, float bmn,
                                           float sl, float top, int bins) {
  const float s = __fadd_rn(t_index(lu, w, bmn, sl, top), 1.f);
  const float fl = floorf(s);
  const float fs = __fsub_rn(s, fl);
  const int j0 = slot(fl, bins);
  const float v = __fadd_rn(__fmul_rn(__fsub_rn(1.f, fs), s_e[j0]),
                            __fmul_rn(fs, s_e[j0 + 1]));
  float r = __fmul_rn(__fsub_rn(lu, __fmul_rn(v, w)), w);
  if (fabsf(r) < 1e-18f) r = 0.f;
  return w > 0.f ? __fdiv_rn(r, fmaxf(sv, 1e-30f)) : 0.f;
}

// K5: one block per (voxel chunk of CHUNK, lane), four voxels a thread; the
// voxels' loads are issued first, then the lane's table is staged in shared
// memory.
__global__ void __launch_bounds__(THREADS) resid_kernel(
    const float* __restrict__ logu, const float* __restrict__ wv,
    const float* __restrict__ sv, const float* __restrict__ e_loc,
    const float* __restrict__ binmin, const float* __restrict__ slope,
    float* __restrict__ a, int P, int bins, int vec4) {
  __shared__ float s_e[MAX_SLOTS];
  const int slots = bins + 2;
  const int lane = blockIdx.y;
  const size_t vec = (size_t)lane * P;
  const int p0 = blockIdx.x * CHUNK;
  const int p = p0 + 4 * threadIdx.x;
  float lu[4] = {0.f, 0.f, 0.f, 0.f};
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec4) {
    // voxels p .. p + 3; P is a multiple of 4, so they are all in or all out
    if (p < P) {
      const float4 l4 = __ldg(reinterpret_cast<const float4*>(logu + vec + p));
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(wv + vec + p));
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(sv + vec + p));
      lu[0] = l4.x; lu[1] = l4.y; lu[2] = l4.z; lu[3] = l4.w;
      w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
      s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = p0 + j * THREADS + threadIdx.x;
      if (q < P) {
        lu[j] = __ldg(logu + vec + q);
        w[j] = __ldg(wv + vec + q);
        s[j] = __ldg(sv + vec + q);
      }
    }
  }
  for (int i = threadIdx.x; i < slots; i += THREADS)
    s_e[i] = e_loc[(size_t)lane * slots + i];
  __syncthreads();

  const float bmn = binmin[lane];
  const float sl = slope[lane];
  const float top = (float)(bins - 1);
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = resid_one(lu[j], w[j], s[j], s_e, bmn, sl, top, bins);
  if (vec4) {
    if (p < P)
      *reinterpret_cast<float4*>(a + vec + p) =
          make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = p0 + j * THREADS + threadIdx.x;
      if (q < P) a[vec + q] = o[j];
    }
  }
}

bool bad_shape(int N, int P, int bins) {
  return N < 1 || N > 65535 || P < 1 || bins < 2 || bins + 2 > MAX_SLOTS;
}

}  // namespace

extern "C" int vj_sharpen_chunk(void) { return CHUNK; }
extern "C" int vj_sharpen_max_slots(void) { return MAX_SLOTS; }

extern "C" int vj_sharpen_hist_partial(const float* logu, const float* wv,
                                       const float* binmin,
                                       const float* slope, void* part, int N,
                                       int P, int bins, int nchunk,
                                       void* stream) {
  if (bad_shape(N, P, bins) || nchunk != (P + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  const int vec4 = P % 4 == 0 && ((size_t)logu & 15) == 0 &&
                   ((size_t)wv & 15) == 0;
  hist_partial<<<dim3(nchunk, N), THREADS, 0, (cudaStream_t)stream>>>(
      logu, wv, binmin, slope, (u64*)part, P, bins, nchunk, vec4);
  return (int)cudaGetLastError();
}

// part: [N, nchunk, bins + 2] fixed-point partials of any number of chunks
// (several launches' partials concatenated along the chunk axis).
extern "C" int vj_sharpen_hist_finish(const void* part, float* hist, int N,
                                      int bins, int nchunk, void* stream) {
  if (N < 1 || N > 65535 || bins < 2 || bins + 2 > MAX_SLOTS || nchunk < 1)
    return (int)cudaErrorInvalidValue;
  hist_finish<<<dim3((bins + 31) / 32, N), THREADS, 0,
                (cudaStream_t)stream>>>((const u64*)part, hist, bins, nchunk);
  return (int)cudaGetLastError();
}

extern "C" int vj_sharpen_resid(const float* logu, const float* wv,
                                const float* sv, const float* e_loc,
                                const float* binmin, const float* slope,
                                float* a, int N, int P, int bins,
                                void* stream) {
  if (bad_shape(N, P, bins)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec4 = P % 4 == 0 && ((size_t)logu & 15) == 0 &&
                   ((size_t)wv & 15) == 0 && ((size_t)sv & 15) == 0 &&
                   ((size_t)a & 15) == 0;
  resid_kernel<<<dim3((P + CHUNK - 1) / CHUNK, N), THREADS, 0, st>>>(
      logu, wv, sv, e_loc, binmin, slope, a, P, bins, vec4);
  return (int)cudaGetLastError();
}
