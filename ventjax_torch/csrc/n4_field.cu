// N4's dense bias field for Hopper (sm_90a), with a plain C interface.
//
// vj_n4_field  field[n, h, w, s] =
//     sum over levels L of  sum_c th_L[h, c] sum_d tw_L[w, d] sum_e ts_L[s, e]
//                           phi_L[n, c, d * ncp_L + e],
// the separable evaluation of each level's B-spline lattice phi_L on the
// full grid (the counterpart of the dense einsum at ventjax/ops/n4.py:500-512,
// which ventjax computes outside any kernel; there is no Pallas counterpart).
//
// Each 1-D basis row (bspline_basis_1d) has at most four non-zero columns,
// span .. span + 3, so the tables hold, per level and axis position, the
// span and its four weights: spans [L, H + W + D] int32 and weights
// [L, H + W + D, 4] float32, positions in (h, w, s) order.
//
// Fixed order, per voxel.  Every value is added in this written order, with
// __fmul_rn / __fadd_rn (no FMA contraction, no fast math, no atomics):
//   g(c, d, s) = ((ts0 phi[c, d, es] + ts1 phi[c, d, es + 1]) + ts2 ...) + ...
//   f(c, w, s) = ((tw0 g(c, ds, s) + tw1 g(c, ds + 1, s)) + tw2 ...) + ...
//   lvl        = ((th0 f(cs, w, s) + th1 f(cs + 1, w, s)) + th2 ...) + ...
//   field      = ((lvl_0 + lvl_1) + lvl_2) + ...   (levels ascending)
// A lane's output depends on that lane's lattices and the shared tables
// only, so it has the same bits at any batch size, and the plain PyTorch
// version (ops/n4_field_cuda.py), which runs the same float32 operations
// in the same order, gives the same bits.
//
// Layout.  A thread owns one (w, s) column of one lane and ROWS rows of h:
// per level it computes its column's f(c, w, s) for every c once (each
// g(c, d, s) it needs is its own), keeps them in its own column of shared
// memory, and then evaluates its ROWS voxels from them, keeping their
// running sums over the levels in registers.  A block's THREADS threads
// hold consecutive columns, so every row's store is contiguous.  The
// lane's lattices (sum of ncp^3 floats, 7.3 KB at the defaults) are staged
// in shared memory beside the f columns when both fit in 48 KB, else read
// through the cache.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (never --use_fast_math), by ventjax_torch/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;        // (w, s) columns a block
constexpr int ROWS = 32;            // h rows a thread
constexpr int MAX_LEVELS = 8;       // ops/n4_field_cuda.py: MAX_LEVELS
constexpr int MAX_NCP = 400;        // ops/n4_field_cuda.py: MAX_NCP
constexpr size_t STAGE_BYTES = 48 * 1024;

struct Levels {
  int n;                      // number of levels
  int ncp[MAX_LEVELS];        // control points per axis at each level
  int off[MAX_LEVELS];        // offset of each level's lattice in a lane
};

__global__ void __launch_bounds__(THREADS)
field_kernel(const float* __restrict__ phi, const int* __restrict__ spans,
             const float* __restrict__ weights, float* __restrict__ field,
             int H, int W, int D, int stride, Levels lv, int fcols,
             int staged) {
  extern __shared__ float smem[];
  float* fcol = smem + threadIdx.x;   // f(c) of this thread at c * THREADS
  const int n = blockIdx.z;
  const float* lane = phi + (size_t)n * stride;
  if (staged) {
    float* sphi = smem + fcols * THREADS;
    for (int i = threadIdx.x; i < stride; i += THREADS) sphi[i] = lane[i];
    __syncthreads();
    lane = sphi;
  }
  const int WD = W * D;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= WD) return;                // after the block's only barrier
  const int w = p / D;
  const int s = p % D;
  const int h0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, H - h0);
  const int T = H + W + D;

  float total[ROWS];
  for (int L = 0; L < lv.n; ++L) {
    const int ncp = lv.ncp[L];
    const int* sp = spans + L * T;
    const float* wt = weights + (size_t)L * T * 4;
    const int cw = sp[H + w], cs = sp[H + W + s];
    float tw[4], ts[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tw[j] = wt[(H + w) * 4 + j];
      ts[j] = wt[(H + W + s) * 4 + j];
    }
    const float* pl = lane + lv.off[L];
    for (int c = 0; c < ncp; ++c) {
      const float* pc = pl + c * ncp * ncp;
      float f = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float* pd = pc + (cw + b) * ncp + cs;
        float g = __fmul_rn(ts[0], pd[0]);
        g = __fadd_rn(g, __fmul_rn(ts[1], pd[1]));
        g = __fadd_rn(g, __fmul_rn(ts[2], pd[2]));
        g = __fadd_rn(g, __fmul_rn(ts[3], pd[3]));
        const float t = __fmul_rn(tw[b], g);
        f = b == 0 ? t : __fadd_rn(f, t);
      }
      fcol[c * THREADS] = f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < rows) {
        const int h = h0 + r;
        const float* fc = fcol + sp[h] * THREADS;
        const float* th = wt + h * 4;
        float lvl = __fmul_rn(th[0], fc[0]);
        lvl = __fadd_rn(lvl, __fmul_rn(th[1], fc[THREADS]));
        lvl = __fadd_rn(lvl, __fmul_rn(th[2], fc[2 * THREADS]));
        lvl = __fadd_rn(lvl, __fmul_rn(th[3], fc[3 * THREADS]));
        total[r] = L == 0 ? lvl : __fadd_rn(total[r], lvl);
      }
    }
  }
  float* out = field + (size_t)n * H * WD + (size_t)h0 * WD + p;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (r < rows) out[(size_t)r * WD] = total[r];
}

}  // namespace

extern "C" int vj_n4_field(const float* phi, const int* spans,
                           const float* weights, float* field, int N, int H,
                           int W, int D, int levels, const int* ncps,
                           int stride, void* stream) {
  if (N < 1 || H < 1 || W < 1 || D < 1 || levels < 1 ||
      levels > MAX_LEVELS || N > 65535)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = levels;
  int off = 0, fcols = 0;
  for (int L = 0; L < levels; ++L) {
    if (ncps[L] < 4 || ncps[L] > MAX_NCP) return (int)cudaErrorInvalidValue;
    lv.ncp[L] = ncps[L];
    lv.off[L] = off;
    off += ncps[L] * ncps[L] * ncps[L];
    fcols = ncps[L] > fcols ? ncps[L] : fcols;
  }
  for (int L = levels; L < MAX_LEVELS; ++L) lv.ncp[L] = lv.off[L] = 0;
  if (off != stride) return (int)cudaErrorInvalidValue;
  const long long V = (long long)H * W * D;
  if (V > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const size_t fbytes = (size_t)fcols * THREADS * sizeof(float);
  const int staged = fbytes + (size_t)stride * sizeof(float) <= STAGE_BYTES;
  const size_t smem = fbytes + (staged ? (size_t)stride * sizeof(float) : 0);
  if (smem > STAGE_BYTES) {
    const cudaError_t e = cudaFuncSetAttribute(
        field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((W * D + THREADS - 1) / THREADS),
                  (unsigned)((H + ROWS - 1) / ROWS), (unsigned)N);
  field_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      phi, spans, weights, field, H, W, D, stride, lv, fcols, staged);
  return (int)cudaGetLastError();
}
