// The CI map's rank-densify construction for Hopper (sm_90a), plain C
// interface.
//
// K9  vj_rank           replaces ventjax/ops/ci_pallas.py:rank_pallas
//     rank[n, v] = (sum_{u <= v} d01[n, u]) - 1, int32, one lane per row.
// K8  vj_densify_rank   replaces ci_pallas.py:densify_rank_pallas
//     out[n, v] = cv[n, rank[n, v]] where d01[n, v] and 0 <= rank < k,
//     else 0 (the scatter's mode="drop" for defect voxels past the pad).
//
// The identity: the compacted defect indices ascend, so the j-th defect
// voxel in row-major order owns cv[j], and dense = cv[rank] on the defects.
//
// K9's scan.  The Pallas kernel carried its running offset in SMEM across a
// sequential grid; Hopper's blocks run in no order.  So a first kernel
// counts each 4096-voxel tile's defects, and the write kernel of tile b adds
// the counts of tiles 0..b-1 itself (a strided sum over at most V / 4096
// integers: no inter-block order, no atomics).  Inside a tile, 256 threads
// take 16 rounds of 256 consecutive voxels; a warp's __ballot_sync and
// __popc give each voxel its count within the warp, and one warp scans the
// 128 (round, warp) counts.  Integer sums are exact, so the result is
// bit-equal to torch.cumsum(d01) - 1.
//
// K8 is a gather: the (hi, lo) one-hot table-select matmul at HIGHEST
// precision was the TPU's way to a gather.  Here each voxel loads its own
// cv entry; values are copied, never computed, so the map is bit-equal to
// the scatter.  K8 stays a kernel of its own (it could later be fused into
// K9's write pass) so that each is held against its Pallas counterpart.
//
// What bounds them on this card: device-memory bandwidth.  K9 reads d01
// twice (1 byte a voxel) and writes 4 bytes a voxel; K8 reads 5 bytes a
// voxel plus the cv entries of defect voxels and writes 4.  Ragged V is
// masked in every pass: any V is taken.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (never --use_fast_math), by ventjax_torch/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 16;
constexpr int TILE = THREADS * ROUNDS;   // voxels per block
constexpr unsigned FULL = 0xffffffffu;

// Sum of one int per thread across the block (every thread gets it).
__device__ int block_sum(int x, int* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  const int warp = threadIdx.x / 32;
  __syncthreads();   // s_warp may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) s_warp[warp] = x;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += s_warp[w];
  return s;
}

// K9, pass 1: counts[lane, b] = number of set voxels in tile b.
__global__ void __launch_bounds__(THREADS) rank_count(
    const unsigned char* __restrict__ d, int* __restrict__ counts, int V,
    int ntile) {
  __shared__ int s_warp[WARPS];
  const int lane = blockIdx.y;
  const int v0 = blockIdx.x * TILE;
  const unsigned char* row = d + (size_t)lane * V;
  int c = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int v = v0 + r * THREADS + threadIdx.x;
    c += (v < V && row[v] != 0) ? 1 : 0;
  }
  c = block_sum(c, s_warp);
  if (threadIdx.x == 0) counts[(size_t)lane * ntile + blockIdx.x] = c;
}

// K9, pass 2: the tile's offset from the earlier tiles' counts, then each
// voxel's inclusive count minus one.
__global__ void __launch_bounds__(THREADS) rank_write(
    const unsigned char* __restrict__ d, const int* __restrict__ counts,
    int* __restrict__ rank, int V, int ntile) {
  __shared__ int s_warp[WARPS];
  __shared__ int s_pre[ROUNDS * WARPS];   // exclusive prefix per (round, warp)
  const int lane = blockIdx.y;
  const int tile = blockIdx.x;
  const int wid = threadIdx.x / 32;
  const int lid = threadIdx.x & 31;
  const int* cnt = counts + (size_t)lane * ntile;
  int off = 0;
  for (int c = threadIdx.x; c < tile; c += THREADS) off += cnt[c];
  off = block_sum(off, s_warp);

  const int v0 = tile * TILE;
  const unsigned char* row = d + (size_t)lane * V;
  unsigned ballot[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int v = v0 + r * THREADS + threadIdx.x;
    ballot[r] = __ballot_sync(FULL, v < V && row[v] != 0);
    if (lid == 0) s_pre[r * WARPS + wid] = __popc(ballot[r]);
  }
  __syncthreads();
  if (wid == 0) {
    // 128 counts in (round, warp) order: 4 consecutive ones per lane.
    int e[4], sum = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = s_pre[lid * 4 + i];
      sum += e[i];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (lid >= o) inc += y;
    }
    int run = inc - sum;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s_pre[lid * 4 + i] = run;
      run += e[i];
    }
  }
  __syncthreads();
  const unsigned below = (1u << lid) - 1u;
  int* out = rank + (size_t)lane * V;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int v = v0 + r * THREADS + threadIdx.x;
    if (v < V) {
      const int set = (ballot[r] >> lid) & 1u;
      out[v] = off + s_pre[r * WARPS + wid] + __popc(ballot[r] & below) +
               set - 1;
    }
  }
}

// K8: one thread per voxel.
__global__ void __launch_bounds__(THREADS) densify_kernel(
    const int* __restrict__ rank, const unsigned char* __restrict__ d,
    const float* __restrict__ cv, float* __restrict__ out, int V, int k) {
  const int lane = blockIdx.y;
  const size_t base = (size_t)lane * V;
  const float* tab = cv + (size_t)lane * k;
  for (int v = blockIdx.x * THREADS + threadIdx.x; v < V;
       v += gridDim.x * THREADS) {
    const int r = rank[base + v];
    const bool keep = d[base + v] != 0 && r >= 0 && r < k;
    out[base + v] = keep ? tab[r] : 0.f;
  }
}

}  // namespace

extern "C" int vj_rank_tile(void) { return TILE; }

extern "C" int vj_rank(const unsigned char* d, int* counts, int* rank, int N,
                       int V, int ntile, void* stream) {
  if (N < 1 || N > 65535 || V < 1 || ntile != (V + TILE - 1) / TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(ntile, N);
  rank_count<<<grid, THREADS, 0, st>>>(d, counts, V, ntile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank_write<<<grid, THREADS, 0, st>>>(d, counts, rank, V, ntile);
  return (int)cudaGetLastError();
}

extern "C" int vj_densify_rank(const int* rank, const unsigned char* d,
                               const float* cv, float* out, int N, int V,
                               int k, void* stream) {
  if (N < 1 || N > 65535 || V < 1 || k < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (V + THREADS * 4 - 1) / (THREADS * 4);
  densify_kernel<<<dim3(blocks, N), THREADS, 0, (cudaStream_t)stream>>>(
      rank, d, cv, out, V, k);
  return (int)cudaGetLastError();
}
