// Deterministic scatter-add (the group_point backward) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel votenet_tpu/ops/pallas/scatter.py:43
// `_scatter_kernel` (wrapper `scatter_add_pallas`, :86), which the JAX
// package routes from votenet_tpu/ops/grouping.py:364-387 `scatter_add` in
// the backward of `group_point` (`_group_point_tpu_bwd`, :401-416).
//
// What it computes: out[b, n, c] = sum over k with idx[b, k] == n of
// g[b, k, c], for g (B, K, C) f32 and idx (B, K) int32 in [0, N), into
// out (B, N, C) f32. Every (b, n, c) is summed in ascending k, starting
// from +0.0, in round-to-nearest f32 adds: the order of a sequential
// np.add.at, so the result is bit-identical to it and the same on every run.
// An index outside [0, N) is dropped.
//
// What bounds it on the H100: the floor is reading g once, B*K*C*4 bytes
// (about 0.8 GB over the four scatters of a full-width B=8 training step:
// sa2, sa3, sa4 and the proposal layer), 0.25 ms at 3.35 TB/s. Above that
// floor, latency: each block walks all K indices of its batch row (two
// barriers per 1024 indices), and its adds wait on loads of scattered g
// rows. Tall tiles make few blocks, each with many dependent loads; short
// tiles make many blocks that mostly walk indices. The wrapper's tile height
// balances the two (ops/cuda/scatter.py tile_rows); measured, the four B=8
// scatters take ~1.25 ms, ~0.64 TB/s of g. The TPU kernel's one-hot matmuls
// and its hi/mid/lo bf16 split exist because the MXU multiplies in bf16; f32
// adds are native here and need neither.
//
// Design: no atomics. A block owns a tile of up to 64 destination rows of one
// batch row (and up to kMaxCols channels; grid.z splits wider C), with the
// tile's accumulator in dynamic shared memory (64 rows x 256 channels x 4 B
// = 64 KB, above the 48 KB default, hence cudaFuncSetAttribute). It streams
// the batch row's indices in ascending k, kChunk at a time (the next chunk's
// loads in flight while the current one is added). A warp ballot per 32
// indices picks those that fall in the tile; the hits of a chunk are
// compacted into a list in ascending k (a popcount prefix over the ballot
// words). Then the adds: the block's threads form groups of W (32-256), a
// group owns the tile rows r with r % (threads / W) == its number, and each
// thread of a group owns channel columns (one float4 of them where C allows,
// else one float). A group walks the list kUnroll entries at a time, starts
// the loads of its own entries together, then adds them in list order. No
// two threads touch one (n, c), so the order of every sum is fixed. Last the
// block writes its whole tile, zeros included. (A first version, one float
// column per thread and always 64-row tiles, ran the four B=8 scatters in
// 4.7 ms.) A sorted-segment design, one pass over the indices instead of one
// per tile, is left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;                   // indices per thread per chunk
constexpr int kChunk = kThreads * kRounds;   // 1024 indices per chunk
constexpr int kWords = kWarps * kRounds;     // 32 ballot words per chunk
constexpr int kMaxTileRows = 64;             // destination rows per block, at most
constexpr int kRowBits = 6;                  // log2(kMaxTileRows)
constexpr int kMaxCols = 512;                // channels per block
constexpr int kUnroll = 16;                  // list entries per step of the adds

static_assert(kWords <= 32, "one ballot word per lane of a warp");
static_assert((1 << kRowBits) == kMaxTileRows, "row bits");
static_assert(kChunk << kRowBits < (1 << 30), "packed list entries fit an int");

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void add(float* a, float v) { *a = __fadd_rn(*a, v); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void add(float4* a, float4 v) {
    float4 x = *a;
    x.x = __fadd_rn(x.x, v.x);
    x.y = __fadd_rn(x.y, v.y);
    x.z = __fadd_rn(x.z, v.z);
    x.w = __fadd_rn(x.w, v.w);
    *a = x;
  }
};

// grid = (ceil(N / tile_rows), B, ceil(C / kMaxCols)), block = kThreads,
// dynamic shared memory = tile_rows * min(C, kMaxCols) floats. VEC = 4 needs
// C % 4 == 0 and g 16-byte aligned. group_threads is 32, 64, 128 or 256.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                       int K, int N, int C, int tile_rows, int group_threads,
                       float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  extern __shared__ __align__(16) float acc[];  // (tile_rows, cols), row-major
  __shared__ unsigned words[kWords];       // ballot of round r, warp w at r*kWarps+w
  __shared__ int list[kChunk];             // (k - base) << kRowBits | row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * tile_rows;
  const int c0 = blockIdx.z * kMaxCols;
  const int cols = min(C - c0, kMaxCols);
  const int* ib = idx + static_cast<size_t>(blockIdx.y) * K;
  const float* gb = g + static_cast<size_t>(blockIdx.y) * K * C + c0;
  // the adds: group `grp` owns rows r with (r & group_mask) == grp
  const int group_mask = kThreads / group_threads - 1;
  const int grp = tid / group_threads;
  const int gt = tid - grp * group_threads;
  const int ncv = cols / VEC;
  const int stride = C / VEC;
  T* accv = reinterpret_cast<T*>(acc);

  for (int i = tid; i < tile_rows * cols; i += kThreads) acc[i] = 0.0f;

  int cur[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = r * kThreads + tid;
    cur[r] = k < K ? __ldg(ib + k) : -1;
  }
  for (int base = 0; base < K; base += kChunk) {
    int nxt[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int k = base + kChunk + r * kThreads + tid;
      nxt[r] = k < K ? __ldg(ib + k) : -1;
    }
    unsigned mine[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      // unsigned difference: a row below n0 (or the -1 past K) wraps high
      const bool hit = static_cast<unsigned>(cur[r]) - static_cast<unsigned>(n0) <
                       static_cast<unsigned>(tile_rows);
      mine[r] = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) words[r * kWarps + warp] = mine[r];
    }
    __syncthreads();  // words of this chunk; the previous chunk's adds are done

    // every thread takes the prefix of the 32 words itself: its own words'
    // offsets into the list and the chunk's hit count
    int total = 0;
    int offset[kRounds];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (w % kWarps == warp) offset[w / kWarps] = total;
      total += __popc(words[w]);
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (mine[r] >> lane & 1u) {
        const int slot = offset[r] + __popc(mine[r] & below);
        list[slot] = ((r * kThreads + tid) << kRowBits) | (cur[r] - n0);
      }
    }
    __syncthreads();  // the list of this chunk

    const T* gc = reinterpret_cast<const T*>(gb + static_cast<size_t>(base) * C);
    for (int cv = gt; cv < ncv; cv += group_threads) {
      for (int i = 0; i < total; i += kUnroll) {
        T v[kUnroll];
        int row[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = i + u < total ? list[i + u] : 0;
          row[u] = (i + u < total && ((e & (kMaxTileRows - 1)) & group_mask) == grp)
                       ? (e & (kMaxTileRows - 1))
                       : -1;
          if (row[u] >= 0) v[u] = __ldg(gc + static_cast<size_t>(e >> kRowBits) * stride + cv);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (row[u] >= 0) Vec<VEC>::add(accv + row[u] * ncv + cv, v[u]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) cur[r] = nxt[r];
  }
  __syncthreads();

  const int rows = min(tile_rows, N - n0);
  float* ob = out + (static_cast<size_t>(blockIdx.y) * N + n0) * C + c0;
  for (int i = tid; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    ob[static_cast<size_t>(r) * C + c] = acc[i];
  }
}

template <int VEC>
int launch(const float* g, const int* idx, int B, int K, int N, int C,
           int tile_rows, int group_threads, float* out, cudaStream_t stream) {
  const int cols = C < kMaxCols ? C : kMaxCols;
  const size_t smem = static_cast<size_t>(tile_rows) * cols * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_add_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + tile_rows - 1) / tile_rows, B, (C + kMaxCols - 1) / kMaxCols);
  scatter_add_kernel<VEC><<<grid, kThreads, smem, stream>>>(
      g, idx, K, N, C, tile_rows, group_threads, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the scatter-add on `stream`: g (B, K, C) f32, idx (B, K) int32,
// out (B, N, C) f32, all contiguous device buffers; every element of out is
// written. tile_rows (1-64) is the height of a block's tile. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a tile_rows outside
// 1-64).
int votenet_scatter_add(const float* g, const int* idx, int B, int K, int N,
                        int C, int tile_rows, float* out, void* stream) {
  if (tile_rows < 1 || tile_rows > kMaxTileRows) return cudaErrorInvalidValue;
  const bool vec4 = C % 4 == 0 && reinterpret_cast<size_t>(g) % 16 == 0;
  const int cols = C < kMaxCols ? C : kMaxCols;
  const int ncv = vec4 ? cols / 4 : cols;
  int group_threads = 32;
  while (group_threads < ncv && group_threads < kThreads) group_threads *= 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<4>(g, idx, B, K, N, C, tile_rows, group_threads, out, s)
              : launch<1>(g, idx, B, K, N, C, tile_rows, group_threads, out, s);
}

}  // extern "C"
