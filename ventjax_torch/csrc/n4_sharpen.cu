// N4's histogram-sharpen kernels for Hopper (sm_90a), with a plain C interface.
//
// K4  vj_sharpen_hist   replaces ventjax/ops/n4_pallas.py:sharpen_hist_pallas
//     hist[n, b] = sum_p wv (1 - f) [b = floor(t)] + wv f [b = floor(t) + 1],
//     t = clip((logu - binmin) / slope, 0, bins - 1) * wv, f = t - floor(t);
//     the fractional (triangle-kernel) histogram of each lane's masked
//     log residual.
// K5  vj_sharpen_resid  replaces n4_pallas.py:sharpen_resid_pallas
//     a = flush((logu - interp(e_loc, t + 1) * wv) * wv) / max(sv, 1e-30),
//     and 0 where wv = 0: the B-spline fit target from the expectation table
//     e_loc [N, bins + 2] that the FFT chain between the two computes.
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
// while sum |wv| < 2^31) and added with integer atomics, which are
// associative: every run gives the same bits.  Each warp owns a copy of the
// histogram in shared memory (fewer collisions), a block folds its copies
// into a per-chunk partial, and a second kernel adds the chunks and converts
// to float32.  The result is the exact sum to within 2^-33 per contribution,
// closer to it than a float32 running sum.
//
// Bit-exactness (K5).  Every operation is written with the _rn intrinsics so
// that nvcc cannot contract a multiply and an add into an FMA: the kernel
// then computes exactly what the plain PyTorch version computes, op by op.
//
// What bounds them on this card.  Both read two to three float32 vectors of
// [N, P] once (K5 writes one), a few hundred KB per lane: device-memory
// bandwidth and launch latency, not arithmetic.  K4's shared-memory 64-bit
// atomics serialise within a warp when lanes hit one bin; the per-warp
// copies keep warps from contending with each other.  The TPU kernels'
// (hi, lo) one-hot matmuls and double-bf16 splits were matrix-unit
// workarounds for a scatter and a gather; here a voxel adds to its own bin
// and reads its own table entry, in float32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (never --use_fast_math), by ventjax_torch/_build.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;   // histogram copies per block
constexpr int CHUNK = 4096;           // voxels per block
constexpr int MAX_SLOTS = 768;        // WARPS * MAX_SLOTS * 8 B = 48 KiB
constexpr float FIX = 4294967296.0f;  // 2^32 fixed-point units per 1.0
constexpr double UNFIX = 1.0 / 4294967296.0;

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

// K4, pass 1: one block per (voxel chunk, lane); per-warp fixed-point
// histograms in shared memory, folded into the chunk's partial.
__global__ void __launch_bounds__(THREADS) hist_partial(
    const float* __restrict__ logu, const float* __restrict__ wv,
    const float* __restrict__ binmin, const float* __restrict__ slope,
    u64* __restrict__ part, int P, int bins, int nchunk) {
  extern __shared__ u64 s_hist[];   // [WARPS][slots]
  const int slots = bins + 2;
  const int lane = blockIdx.y;
  const int chunk = blockIdx.x;
  for (int i = threadIdx.x; i < WARPS * slots; i += THREADS) s_hist[i] = 0;
  __syncthreads();

  u64* mine = s_hist + (threadIdx.x / 32) * slots;
  const size_t vec = (size_t)lane * P;
  const float bmn = binmin[lane];
  const float sl = slope[lane];
  const float top = (float)(bins - 1);
  const int p1 = min((chunk + 1) * CHUNK, P);
  for (int p = chunk * CHUNK + threadIdx.x; p < p1; p += THREADS) {
    const float w = wv[vec + p];
    const float t = t_index(logu[vec + p], w, bmn, sl, top);
    const float fl = floorf(t);
    const float f = __fsub_rn(t, fl);
    const int i0 = slot(fl, bins);
    const float w0 = __fmul_rn(w, __fsub_rn(1.f, f));
    const float w1 = __fmul_rn(w, f);
    if (w0 != 0.f) atomicAdd(mine + i0, (u64)__float2ll_rn(w0 * FIX));
    if (w1 != 0.f) atomicAdd(mine + i0 + 1, (u64)__float2ll_rn(w1 * FIX));
  }
  __syncthreads();
  u64* out = part + ((size_t)lane * nchunk + chunk) * slots;
  for (int s = threadIdx.x; s < slots; s += THREADS) {
    u64 acc = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += s_hist[w * slots + s];
    out[s] = acc;
  }
}

// K4, pass 2: hist[lane, b] = float32 of the chunk partials' sum, b < bins.
__global__ void hist_finish(const u64* __restrict__ part,
                            float* __restrict__ hist, int bins, int nchunk) {
  const int lane = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= bins) return;
  const int slots = bins + 2;
  const u64* p = part + (size_t)lane * nchunk * slots + b;
  u64 acc = 0;
  for (int c = 0; c < nchunk; ++c) acc += p[(size_t)c * slots];
  hist[(size_t)lane * bins + b] = (float)((double)(long long)acc * UNFIX);
}

// K5: one block per (voxel chunk, lane), the lane's table in shared memory.
__global__ void __launch_bounds__(THREADS) resid_kernel(
    const float* __restrict__ logu, const float* __restrict__ wv,
    const float* __restrict__ sv, const float* __restrict__ e_loc,
    const float* __restrict__ binmin, const float* __restrict__ slope,
    float* __restrict__ a, int P, int bins) {
  __shared__ float s_e[MAX_SLOTS];
  const int slots = bins + 2;
  const int lane = blockIdx.y;
  for (int i = threadIdx.x; i < slots; i += THREADS)
    s_e[i] = e_loc[(size_t)lane * slots + i];
  __syncthreads();

  const size_t vec = (size_t)lane * P;
  const float bmn = binmin[lane];
  const float sl = slope[lane];
  const float top = (float)(bins - 1);
  const int p1 = min((blockIdx.x + 1) * CHUNK, P);
  for (int p = blockIdx.x * CHUNK + threadIdx.x; p < p1; p += THREADS) {
    const float w = wv[vec + p];
    const float lu = logu[vec + p];
    const float s = __fadd_rn(t_index(lu, w, bmn, sl, top), 1.f);
    const float fl = floorf(s);
    const float fs = __fsub_rn(s, fl);
    const int j0 = slot(fl, bins);
    const float v = __fadd_rn(__fmul_rn(__fsub_rn(1.f, fs), s_e[j0]),
                              __fmul_rn(fs, s_e[j0 + 1]));
    float r = __fmul_rn(__fsub_rn(lu, __fmul_rn(v, w)), w);
    if (fabsf(r) < 1e-18f) r = 0.f;
    a[vec + p] = w > 0.f ? __fdiv_rn(r, fmaxf(sv[vec + p], 1e-30f)) : 0.f;
  }
}

bool bad_shape(int N, int P, int bins) {
  return N < 1 || N > 65535 || P < 1 || bins < 2 || bins + 2 > MAX_SLOTS;
}

}  // namespace

extern "C" int vj_sharpen_chunk(void) { return CHUNK; }
extern "C" int vj_sharpen_max_slots(void) { return MAX_SLOTS; }

extern "C" int vj_sharpen_hist(const float* logu, const float* wv,
                               const float* binmin, const float* slope,
                               void* part, float* hist, int N, int P, int bins,
                               int nchunk, void* stream) {
  if (bad_shape(N, P, bins) || nchunk != (P + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)WARPS * (bins + 2) * sizeof(u64);
  hist_partial<<<dim3(nchunk, N), THREADS, smem, st>>>(
      logu, wv, binmin, slope, (u64*)part, P, bins, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist_finish<<<dim3((bins + 255) / 256, N), 256, 0, st>>>(
      (const u64*)part, hist, bins, nchunk);
  return (int)cudaGetLastError();
}

extern "C" int vj_sharpen_resid(const float* logu, const float* wv,
                                const float* sv, const float* e_loc,
                                const float* binmin, const float* slope,
                                float* a, int N, int P, int bins,
                                void* stream) {
  if (bad_shape(N, P, bins)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  resid_kernel<<<dim3((P + CHUNK - 1) / CHUNK, N), THREADS, 0, st>>>(
      logu, wv, sv, e_loc, binmin, slope, a, P, bins);
  return (int)cudaGetLastError();
}
