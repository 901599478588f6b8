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
// K9's scan, in one launch that reads d01 once.  The Pallas kernel carried
// its running offset in SMEM across a sequential grid; Hopper's blocks run
// in no order.  So each block takes the next 16384-voxel tile of its row
// from the row's ticket (an integer atomicInc, so a block only ever waits
// on tiles that took their tickets before it and are running: no order of
// scheduling can deadlock), counts its tile, publishes the count in the
// tile's status word and finds the tile's offset by a decoupled look-back:
// warp 0 reads the status words of the 32 tiles before it at once and adds
// their counts down to the nearest tile that has published its inclusive
// prefix.  A status word is 0 (not yet published), A | count or P | prefix
// in one 32-bit store (V < 2^30, so a prefix fits in 30 bits).  The row's
// last block to finish (a second ticket) clears the row's status words, and
// both tickets wrap to 0 as their last block takes them, so the workspace
// is zero before and after every call and no memset runs beside the kernel.
// Inside a tile, each of 512 threads holds 16 flags from one 16-byte load
// in each of two rounds; the two rounds' counts are scanned together,
// packed in the low and high 16 bits of one word (a round of a block holds
// at most 8192 flags).  The wait for the earlier tiles is the largest cost
// beyond the bytes (a variant that skipped it measured ~2 us less), and it
// shrinks with the tiles a row has: 512-thread blocks measured faster than
// 256-thread ones.  The ranks are 80 % of the bytes, so a warp stores its
// 512 ranks of a round as four int4 store instructions of 512 consecutive
// bytes each: lane t stores chunk q * 32 + t and fetches that chunk's flags
// and offset from the lane that loaded them by shuffles.  Integer sums are
// exact (no float atomics), so the result is bit-equal to
// torch.cumsum(d01) - 1.
//
// K8 is a gather: the (hi, lo) one-hot table-select matmul at HIGHEST
// precision was the TPU's way to a gather.  Here each defect voxel loads its
// own cv entry; values are copied, never computed, so the map is bit-equal
// to the scatter.  K8 stays a kernel of its own (it could later be fused
// into K9's write pass) so that each is held against its Pallas counterpart.
//
// What bounds them on this card: device-memory bandwidth.  K9 reads d01
// once (1 byte a voxel) and writes 4 bytes a voxel.  K8's output is 0
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
// rank only under a set flag; likewise K9's scalar instance loads and
// stores a voxel at a time, still in one launch.  Ragged V is masked in
// every pass: any V is taken.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (never --use_fast_math), by ventjax_torch/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;                     // K8
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 16;                        // flags in a 16-byte load
constexpr int RANK_THREADS = 512;                // K9
constexpr int RANK_WARPS = RANK_THREADS / 32;
constexpr int ROUNDS = 2;                        // K9: 16-byte loads a thread
constexpr int TILE = RANK_THREADS * GROUP * ROUNDS;   // K9: voxels a block
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ST_A = 1u << 30;              // status: the tile's count
constexpr unsigned ST_P = 2u << 30;              // status: inclusive prefix
constexpr unsigned ST_VAL = ST_A - 1u;

// 0x01 in each byte of w that is not 0, else 0x00.
__device__ __forceinline__ unsigned nz4(unsigned w) {
  return __vcmpne4(w, 0u) & 0x01010101u;
}

__device__ __forceinline__ unsigned nz_count(const uint4& m) {
  return __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
}

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// The exclusive prefix of tile (> 0) of a row, by warp 0: each lane waits
// for one status word of the 32 tiles below the window's top, then the warp
// adds the counts down to the nearest inclusive prefix (tile 0 publishes
// one at once, so a window never reaches below it).
__device__ unsigned look_back(const unsigned* status, int tile, int lid) {
  unsigned excl = 0u;
  for (int top = tile - 1;; top -= 32) {
    const int idx = top - lid;
    unsigned s = ST_P;
    if (idx >= 0) {
      do {
        s = load_status(status + idx);
      } while (s == 0u);
    }
    const unsigned pmask = __ballot_sync(FULL, s >= ST_P);
    unsigned v = s & ST_VAL;
    if (pmask != 0u && lid >= __ffs(pmask)) v = 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    excl += v;
    if (pmask != 0u) return excl;
  }
}

// K9.  ws: tickets[N], finish tickets[N], status[N][ntile], all zero before
// and after the call.  VEC: V % 16 == 0 and d, rank 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(RANK_THREADS, 2) rank_scan(
    const unsigned char* __restrict__ d, int* __restrict__ rank,
    unsigned* __restrict__ ws, int N, int V, int ntile) {
  static_assert(ROUNDS == 2, "the packed scan holds two rounds");
  __shared__ unsigned s_warp[RANK_WARPS];
  __shared__ int s_tile;
  __shared__ unsigned s_off;
  __shared__ bool s_last;
  const int row = blockIdx.y;
  const int lid = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  unsigned* status = ws + 2 * (size_t)N + (size_t)row * ntile;
  if (threadIdx.x == 0)
    s_tile = (int)atomicInc(ws + row, (unsigned)ntile - 1u);
  __syncthreads();
  const int tile = s_tile;
  const unsigned char* drow = d + (size_t)row * V;

  uint4 m[ROUNDS];   // per-byte flags (0x00 / 0x01) of the thread's groups
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int v =
        tile * TILE + r * RANK_THREADS * GROUP + threadIdx.x * GROUP;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (VEC) {
      if (v < V) x = __ldg(reinterpret_cast<const uint4*>(drow + v));
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < GROUP; ++k)
        if (v + k < V) w[k >> 2] |= (unsigned)drow[v + k] << (8 * (k & 3));
      x = make_uint4(w[0], w[1], w[2], w[3]);
    }
    m[r] = make_uint4(nz4(x.x), nz4(x.y), nz4(x.z), nz4(x.w));
  }

  // block scan of both rounds' counts at once (round 1 in the high half)
  const unsigned c = nz_count(m[0]) | (nz_count(m[1]) << 16);
  unsigned inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, inc, o);
    if (lid >= o) inc += y;
  }
  if (lid == 31) s_warp[wid] = inc;
  __syncthreads();
  unsigned below = 0u, total = 0u;
#pragma unroll
  for (int w = 0; w < RANK_WARPS; ++w) {
    const unsigned t = s_warp[w];
    below += w < wid ? t : 0u;
    total += t;
  }
  const unsigned ex = below + inc - c;     // exclusive, both rounds packed
  const unsigned t0 = total & 0xffffu;     // round 0's count
  const unsigned agg = t0 + (total >> 16);

  if (wid == 0) {
    if (lid == 0) store_status(status + tile, (tile == 0 ? ST_P : ST_A) | agg);
    const unsigned excl = tile > 0 ? look_back(status, tile, lid) : 0u;
    if (lid == 0) {
      if (tile > 0) store_status(status + tile, ST_P | (excl + agg));
      s_off = excl;
      __threadfence();   // this block's status stores before its ticket
      s_last = atomicInc(ws + N + row, (unsigned)ntile - 1u) ==
               (unsigned)ntile - 1u;
    }
  }
  __syncthreads();
  if (s_last)   // every block of the row is past its look-back
    for (int i = threadIdx.x; i < ntile; i += RANK_THREADS) status[i] = 0u;

  int* rrow = rank + (size_t)row * V;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    // voxels before this thread's group of round r
    const unsigned base = s_off + (r == 0 ? (ex & 0xffffu) : t0 + (ex >> 16));
    const int g0 = tile * TILE + r * RANK_THREADS * GROUP;
    if (VEC) {
      // the warp's 512 voxels of the round as 128 int4 chunks; chunk
      // q * 32 + t holds word t % 4 of lane 8 q + t / 4's group
      const int span = g0 + 512 * wid;
      int4* o4 = reinterpret_cast<int4*>(rrow + span);
      const int sel = lid & 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int src = 8 * q + (lid >> 2);
        const unsigned x = __shfl_sync(FULL, m[r].x, src);
        const unsigned y = __shfl_sync(FULL, m[r].y, src);
        const unsigned z = __shfl_sync(FULL, m[r].z, src);
        const unsigned u = __shfl_sync(FULL, m[r].w, src);
        const unsigned b = __shfl_sync(FULL, base, src);
        const unsigned w = sel == 0 ? x : sel == 1 ? y : sel == 2 ? z : u;
        const unsigned pre = (sel > 0 ? __popc(x) : 0) +
                             (sel > 1 ? __popc(y) : 0) +
                             (sel > 2 ? __popc(z) : 0);
        const unsigned p = w * 0x01010101u;   // inclusive count by byte
        const int r0 = (int)(b + pre) - 1;
        const int chunk = 32 * q + lid;
        if (span + 4 * chunk < V)
          o4[chunk] = make_int4(r0 + (int)(p & 0xffu),
                                r0 + (int)((p >> 8) & 0xffu),
                                r0 + (int)((p >> 16) & 0xffu),
                                r0 + (int)(p >> 24));
      }
    } else {
      const int v = g0 + threadIdx.x * GROUP;
      const unsigned w[4] = {m[r].x, m[r].y, m[r].z, m[r].w};
      unsigned run = base;
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        run += (w[k >> 2] >> (8 * (k & 3))) & 1u;
        if (v + k < V) rrow[v + k] = (int)run - 1;
      }
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

// counts: the look-back workspace, N * (ntile + 2) ints, zero before the
// call; the kernel leaves it zero.
extern "C" int vj_rank(const unsigned char* d, int* counts, int* rank, int N,
                       int V, int ntile, void* stream) {
  if (N < 1 || N > 65535 || V < 1 || V >= (1 << 30) ||
      ntile != (V + TILE - 1) / TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* ws = reinterpret_cast<unsigned*>(counts);
  const dim3 grid(ntile, N);
  if (V % GROUP == 0 && ((size_t)d & 15) == 0 && ((size_t)rank & 15) == 0)
    rank_scan<true><<<grid, RANK_THREADS, 0, st>>>(d, rank, ws, N, V, ntile);
  else
    rank_scan<false><<<grid, RANK_THREADS, 0, st>>>(d, rank, ws, N, V,
                                                    ntile);
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
