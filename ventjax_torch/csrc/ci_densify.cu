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
// precision was the TPU's way to a gather.  Here each defect voxel loads its
// own cv entry; values are copied, never computed, so the map is bit-equal
// to the scatter.  K8 stays a kernel of its own (it could later be fused
// into K9's write pass) so that each is held against its Pallas counterpart.
//
// What bounds them on this card: device-memory bandwidth.  K9 reads d01
// twice (1 byte a voxel) and writes 4 bytes a voxel.  K8's output is 0
// wherever d01 is 0, which is nearly every voxel (>= 99.8 % at the slice's
// K 512, ~98.8 % on severe maps), so the rank of a voxel without a defect
// is never needed: K8 must move 5 bytes a voxel (d01 in, map out), the
// 32-byte rank sectors that hold a defect, and cv.  densify_vec16 moves
// just that: a warp owns 512 consecutive voxels, a thread reads 16 of them
// with one 16-byte load of d01 and writes four float4 chunks, rank is
// loaded only for the bytes that are set, and a warp whose 512 voxels hold
// no defect (__any_sync) loads no rank at all.
// Every load of a thread is issued before its stores.  The grid is the
// blocks the card holds at once (one wave), each warp striding over
// 512-voxel spans.  Where V is not a multiple of 16 or d01 / out are not
// 16-byte aligned, densify_scalar takes one voxel a thread and still reads
// rank only under a set flag.  Ragged V is masked in every pass: any V is
// taken.
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

// K8, 16-byte path: the [N, V] map as N * V / 16 groups of 16 voxels (V is
// a multiple of 16, so a group never straddles two lanes); warp w of the
// grid takes the 32 groups w * 32 .. w * 32 + 31 (512 voxels, 128 float4
// chunks), then strides on by the grid's warps, so every lane of a warp
// runs the same iterations.  Lane t loads group w * 32 + t, and writes
// chunks q * 32 + t (q = 0..3) of the warp's span, so each store
// instruction of the warp covers 512 consecutive bytes; the flags of chunk
// q * 32 + t are word t % 4 of lane 8 q + t / 4's group, fetched by
// shuffles where the span holds a defect.
constexpr int GROUP = 16;

__global__ void __launch_bounds__(THREADS) densify_vec16(
    const int* __restrict__ rank, const unsigned char* __restrict__ d,
    const float* __restrict__ cv, float* __restrict__ out, int V, int k,
    long long ngroup) {
  const int lid = threadIdx.x & 31;
  const long long nwarp = (long long)gridDim.x * WARPS;
  const long long nchunk = ngroup * (GROUP / 4);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       w * 32 < ngroup; w += nwarp) {
    const long long g = w * 32 + lid;
    uint4 m = make_uint4(0u, 0u, 0u, 0u);
    if (g < ngroup) m = __ldg(reinterpret_cast<const uint4*>(d) + g);
    const long long c0 = w * 128 + lid;   // this lane's chunks: c0 + 32 q
    if (!__any_sync(FULL, (m.x | m.y | m.z | m.w) != 0u)) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < GROUP / 4; ++q)
        if (c0 + 32 * q < nchunk) o4[c0 + 32 * q] = z;
      continue;
    }
    unsigned word[GROUP / 4];
#pragma unroll
    for (int q = 0; q < GROUP / 4; ++q) {
      const int src = 8 * q + (lid >> 2);
      const unsigned x = __shfl_sync(FULL, m.x, src);
      const unsigned y = __shfl_sync(FULL, m.y, src);
      const unsigned z = __shfl_sync(FULL, m.z, src);
      const unsigned u = __shfl_sync(FULL, m.w, src);
      const int sel = lid & 3;
      word[q] = sel == 0 ? x : sel == 1 ? y : sel == 2 ? z : u;
    }
    // every rank load first (-1 for a voxel without a defect), then every
    // table load, then the stores
    int r[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const long long v = 4 * (c0 + 32 * (j >> 2)) + (j & 3);
      r[j] = ((word[j >> 2] >> (8 * (j & 3))) & 0xffu) ? __ldg(rank + v) : -1;
    }
    float f[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const float* tab = cv + (4 * (c0 + 32 * (j >> 2)) / V) * (long long)k;
      f[j] = (r[j] >= 0 && r[j] < k) ? __ldg(tab + r[j]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < GROUP / 4; ++q)
      if (c0 + 32 * q < nchunk)
        o4[c0 + 32 * q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2],
                                      f[4 * q + 3]);
  }
}

// K8, scalar path (any V, any alignment): one thread per voxel.
__global__ void __launch_bounds__(THREADS) densify_scalar(
    const int* __restrict__ rank, const unsigned char* __restrict__ d,
    const float* __restrict__ cv, float* __restrict__ out, int V, int k) {
  const int lane = blockIdx.y;
  const size_t base = (size_t)lane * V;
  const float* tab = cv + (size_t)lane * k;
  for (int v = blockIdx.x * THREADS + threadIdx.x; v < V;
       v += gridDim.x * THREADS) {
    float o = 0.f;
    if (d[base + v] != 0) {
      const int r = rank[base + v];
      if (r >= 0 && r < k) o = tab[r];
    }
    out[base + v] = o;
  }
}

// Blocks of densify_vec16 the current device holds at once.
int densify_wave() {
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, densify_vec16,
                                                      THREADS, 0) !=
            cudaSuccess)
      return 0;
    wave = sms * per_sm;
  }
  return wave;
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
  cudaStream_t st = (cudaStream_t)stream;
  if (V % GROUP == 0 && ((size_t)d & 15) == 0 && ((size_t)out & 15) == 0) {
    const long long ngroup = (long long)N * (V / GROUP);
    const long long need = (ngroup + THREADS - 1) / THREADS;
    const int wave = densify_wave();
    if (wave == 0) {
      const cudaError_t err = cudaGetLastError();
      return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
    }
    const int blocks = (int)(need < wave ? need : wave);
    densify_vec16<<<blocks, THREADS, 0, st>>>(rank, d, cv, out, V, k, ngroup);
  } else {
    const int blocks = (V + THREADS * 4 - 1) / (THREADS * 4);
    densify_scalar<<<dim3(blocks, N), THREADS, 0, st>>>(rank, d, cv, out, V,
                                                        k);
  }
  return (int)cudaGetLastError();
}
