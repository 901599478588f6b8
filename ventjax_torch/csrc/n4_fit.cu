// N4's B-spline fit kernels for Hopper (sm_90a), with a plain C interface.
//
// K1  vj_fit_moment            replaces ventjax/ops/n4_pallas.py:fit_moment_pallas
//     mom[n, c, d*ncp+e] = sum_p a[n,p] br[n,c,p] bc[n,d,p] bs[n,e,p]
//     (the Lee-BA fit numerator with cubed rows, denominator with squared).
// K2  vj_fit_delta_conv_field  replaces n4_pallas.py:fit_delta_conv_field_pallas
//     delta = B phi per voxel (flushed below 1e-18, times wv); the
//     done-frozen field update; the next log residual and its masked
//     min/max; ITK's convergence sums s1 = sum wv (e^-delta - 1) and
//     s2 = sum wv (e^-delta - 1)^2.
//
// Layout: basis rows are [N, ncp, P] float32 (voxel index fastest, so a
// warp reads 32 consecutive voxels of one row); vectors are [N, P]; the
// moment and phi are [N, ncp^3] with c slowest and e fastest.
//
// What bounds them on this card.  K1 does ncp^3 multiply-adds per voxel
// (1331 at ncp = 11) against 3*ncp row reads, so it is bound by issuing the
// three shared-memory operand loads of each multiply-add, not by device
// memory.  K2 does ncp^3 multiply-adds per voxel with phi broadcast from
// shared memory, and streams 3*ncp rows plus five vectors.  Neither is
// near the tensor cores; making them fast is later work.
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
// chunk, and a second small kernel reduces the chunks in a fixed order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (never --use_fast_math), by ventjax_torch/_build.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXCP = 16;       // largest ncp the kernels take
constexpr int CHUNK = 2048;     // voxels per block (one partial sum each)
constexpr int TP = 64;          // voxels per shared-memory tile in K1
constexpr int K1_THREADS = 256;
constexpr int K2_THREADS = 256;

// K1, pass 1: one block per (voxel chunk, lane).  Thread t owns the moment
// entries f = t, t + 256, ... (ACC of them) and walks the chunk tile by
// tile; a tile holds a*br, bc and bs voxel-major, so the 32 lanes of a warp
// read neighbouring entries (or one broadcast entry) of one voxel.
template <int ACC>
__global__ void __launch_bounds__(K1_THREADS) moment_partial(
    const float* __restrict__ a, const float* __restrict__ br,
    const float* __restrict__ bc, const float* __restrict__ bs,
    float* __restrict__ part, int P, int ncp, int nchunk) {
  __shared__ float s_ab[TP * MAXCP];
  __shared__ float s_bc[TP * MAXCP];
  __shared__ float s_bs[TP * MAXCP];
  const int lane = blockIdx.y;
  const int chunk = blockIdx.x;
  const int n2 = ncp * ncp;
  const int n3 = n2 * ncp;
  const size_t rows = (size_t)lane * ncp * P;
  const float* a_l = a + (size_t)lane * P;
  const float* br_l = br + rows;
  const float* bc_l = bc + rows;
  const float* bs_l = bs + rows;

  int oc[ACC], od[ACC], oe[ACC];
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    int f = threadIdx.x + j * K1_THREADS;
    if (f >= n3) f = 0;  // surplus slot: computed, never written
    oc[j] = f / n2;
    od[j] = (f / ncp) % ncp;
    oe[j] = f % ncp;
    acc[j] = 0.f;
  }
  const int p0 = chunk * CHUNK;
  const int p1 = min(p0 + CHUNK, P);
  for (int t0 = p0; t0 < p1; t0 += TP) {
    const int nt = min(TP, p1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < ncp * TP; i += K1_THREADS) {
      const int k = i / TP;
      const int p = i - k * TP;
      float vab = 0.f, vbc = 0.f, vbs = 0.f;
      if (p < nt) {
        const size_t g = (size_t)k * P + t0 + p;
        vab = a_l[t0 + p] * br_l[g];
        vbc = bc_l[g];
        vbs = bs_l[g];
      }
      s_ab[p * MAXCP + k] = vab;
      s_bc[p * MAXCP + k] = vbc;
      s_bs[p * MAXCP + k] = vbs;
    }
    __syncthreads();
    for (int p = 0; p < nt; ++p) {
      const float* ab = s_ab + p * MAXCP;
      const float* cb = s_bc + p * MAXCP;
      const float* sb = s_bs + p * MAXCP;
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] += ab[oc[j]] * (cb[od[j]] * sb[oe[j]]);
    }
  }
  float* out = part + ((size_t)lane * nchunk + chunk) * n3;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int f = threadIdx.x + j * K1_THREADS;
    if (f < n3) out[f] = acc[j];
  }
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

// K2, pass 1: one block per (voxel chunk, lane), one thread per voxel at a
// time.  phi sits in shared memory and every lane of a warp reads the same
// coefficient (a broadcast); the bc and bs rows of the voxel sit in
// registers, the br row is read once per c.
template <int NCP>
__global__ void __launch_bounds__(K2_THREADS) delta_field_partial(
    const float* __restrict__ phi, const float* __restrict__ br,
    const float* __restrict__ bc, const float* __restrict__ bs,
    const float* __restrict__ wv, const float* __restrict__ field,
    const float* __restrict__ logv, const float* __restrict__ done,
    float* __restrict__ nf, float* __restrict__ lu, float* __restrict__ part,
    int P, int nchunk) {
  constexpr int N2 = NCP * NCP;
  constexpr int N3 = N2 * NCP;
  __shared__ float s_phi[N3];
  __shared__ float red[4][K2_THREADS];
  const int lane = blockIdx.y;
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  const float* phi_l = phi + (size_t)lane * N3;
  for (int i = t; i < N3; i += K2_THREADS) s_phi[i] = phi_l[i];
  __syncthreads();

  const size_t rows = (size_t)lane * NCP * P;
  const size_t vec = (size_t)lane * P;
  const float live = 1.f - done[lane];
  float s1 = 0.f, s2 = 0.f, mn = INFINITY, mx = -INFINITY;
  const int p1 = min((chunk + 1) * CHUNK, P);
  for (int p = chunk * CHUNK + t; p < p1; p += K2_THREADS) {
    float cb[NCP], sb[NCP];
#pragma unroll
    for (int k = 0; k < NCP; ++k) {
      cb[k] = bc[rows + (size_t)k * P + p];
      sb[k] = bs[rows + (size_t)k * P + p];
    }
    float raw = 0.f;
    for (int c = 0; c < NCP; ++c) {
      const float* ph = s_phi + c * N2;
      float h = 0.f;
#pragma unroll
      for (int d = 0; d < NCP; ++d) {
        float g = 0.f;
#pragma unroll
        for (int e = 0; e < NCP; ++e) g += ph[d * NCP + e] * sb[e];
        h += cb[d] * g;
      }
      raw += br[rows + (size_t)c * P + p] * h;
    }
    const float w = wv[vec + p];
    const float dl = (fabsf(raw) < 1e-18f ? 0.f : raw) * w;
    const float f2 = field[vec + p] + live * dl;
    const float l2 = (logv[vec + p] - f2) * w;
    nf[vec + p] = f2;
    lu[vec + p] = l2;
    const float e1 = expf(-dl) - 1.f;
    s1 += w * e1;
    s2 += w * e1 * e1;
    if (w > 0.f) {
      mn = fminf(mn, l2);
      mx = fmaxf(mx, l2);
    }
  }
  red[0][t] = s1;
  red[1][t] = s2;
  red[2][t] = mn;
  red[3][t] = mx;
  __syncthreads();
  for (int s = K2_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      red[0][t] += red[0][t + s];
      red[1][t] += red[1][t + s];
      red[2][t] = fminf(red[2][t], red[2][t + s]);
      red[3][t] = fmaxf(red[3][t], red[3][t + s]);
    }
    __syncthreads();
  }
  if (t == 0) {
    float* o = part + ((size_t)lane * nchunk + chunk) * 4;
    o[0] = red[0][0];
    o[1] = red[1][0];
    o[2] = red[2][0];
    o[3] = red[3][0];
  }
}

// K2, pass 2: one thread per lane folds the chunks' (s1, s2, min, max).
__global__ void reduce_stats(const float* __restrict__ part,
                             float* __restrict__ stats, int N, int nchunk) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const float* p = part + (size_t)lane * nchunk * 4;
  float s1 = 0.f, s2 = 0.f, mn = INFINITY, mx = -INFINITY;
  for (int c = 0; c < nchunk; ++c) {
    s1 += p[4 * c];
    s2 += p[4 * c + 1];
    mn = fminf(mn, p[4 * c + 2]);
    mx = fmaxf(mx, p[4 * c + 3]);
  }
  stats[4 * lane] = s1;
  stats[4 * lane + 1] = s2;
  stats[4 * lane + 2] = mn;
  stats[4 * lane + 3] = mx;
}

bool bad_shape(int N, int P, int ncp, int nchunk) {
  return N < 1 || N > 65535 || P < 1 || ncp < 1 || ncp > MAXCP ||
         nchunk != (P + CHUNK - 1) / CHUNK;
}

}  // namespace

extern "C" int vj_n4_chunk(void) { return CHUNK; }

extern "C" int vj_fit_moment(const float* a, const float* br, const float* bc,
                             const float* bs, float* part, float* out, int N,
                             int P, int ncp, int nchunk, void* stream) {
  if (bad_shape(N, P, ncp, nchunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(nchunk, N);
  const int n3 = ncp * ncp * ncp;
  const int acc = (n3 + K1_THREADS - 1) / K1_THREADS;
#define VJ_MOMENT(A) \
  moment_partial<A><<<grid, K1_THREADS, 0, st>>>(a, br, bc, bs, part, P, ncp, nchunk)
  if (acc <= 1) VJ_MOMENT(1);
  else if (acc <= 2) VJ_MOMENT(2);
  else if (acc <= 4) VJ_MOMENT(4);
  else if (acc <= 6) VJ_MOMENT(6);
  else if (acc <= 8) VJ_MOMENT(8);
  else if (acc <= 12) VJ_MOMENT(12);
  else VJ_MOMENT(16);
#undef VJ_MOMENT
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_chunks<<<dim3((n3 + 255) / 256, N), 256, 0, st>>>(part, out, nchunk, n3);
  return (int)cudaGetLastError();
}

extern "C" int vj_fit_delta_conv_field(
    const float* phi, const float* br, const float* bc, const float* bs,
    const float* wv, const float* field, const float* logv, const float* done,
    float* nf, float* lu, float* part, float* stats, int N, int P, int ncp,
    int nchunk, void* stream) {
  if (bad_shape(N, P, ncp, nchunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(nchunk, N);
#define VJ_DELTA(C)                                                        \
  case C:                                                                  \
    delta_field_partial<C><<<grid, K2_THREADS, 0, st>>>(                   \
        phi, br, bc, bs, wv, field, logv, done, nf, lu, part, P, nchunk); \
    break
  switch (ncp) {
    VJ_DELTA(1); VJ_DELTA(2); VJ_DELTA(3); VJ_DELTA(4);
    VJ_DELTA(5); VJ_DELTA(6); VJ_DELTA(7); VJ_DELTA(8);
    VJ_DELTA(9); VJ_DELTA(10); VJ_DELTA(11); VJ_DELTA(12);
    VJ_DELTA(13); VJ_DELTA(14); VJ_DELTA(15); VJ_DELTA(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VJ_DELTA
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_stats<<<(N + 127) / 128, 128, 0, st>>>(part, stats, N, nchunk);
  return (int)cudaGetLastError();
}
