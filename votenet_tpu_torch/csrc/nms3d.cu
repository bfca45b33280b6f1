// Greedy oriented 3D NMS on Hopper (sm_90a): the walk over the priority
// order, on the card, in one launch.
//
// The port's own kernel: the JAX package has no Pallas kernel for NMS. Its
// votenet_tpu/ops/nms3d.py:40-58 `_jacobi_greedy` iterates a fixpoint in a
// lax.while_loop on the device; the port's plain version is the same
// fixpoint in PyTorch, which must ask the host after every round whether
// anything changed (one sync a round). This kernel replaces that loop on a
// CUDA tensor: no round trip to the host at all.
//
// What it computes, for each batch row b (one CTA): the suppression
// relation supp[j, i] = higher(j, i) & (iou[j, i] > thr) & cand[j], where
// higher(j, i) means j comes before i in `order` (score descending, index
// ascending: a stable argsort of the caller's), then the greedy: walking
// `order`, box i is kept iff cand[i] and no kept box j before it has
// supp[j, i]. That is the fixpoint of "kept = cand & ~any(kept & supp)"
// which the Jacobi loop reaches (votenet_tpu/ops/nms3d.py:40-45: "exactly
// the greedy solution").
//
// Design: the CTA packs supp into bit rows in shared memory, row j as
// ceil(N / 32) words (8 words, 32 bytes a row at N = 256: 8 KiB in all).
// Each warp takes whole rows; a lane reads iou[j, i] for i = 32 w + lane
// (coalesced, kBatch words' loads in flight before their ballots) and
// __ballot_sync makes word w. A row of a non-candidate j is all zero and
// its IoUs are not read. Then warp 0 walks the order: lane l holds word l
// of the running `blocked` mask (N <= 32 * 32), box i's bit comes from lane
// i / 32 by a shuffle, and a kept box ORs its row into `blocked`, one word a
// lane. The walk is N dependent steps (shuffle, test, OR); the loads of
// each step's row do not depend on `blocked` and run ahead of it.
//
// What bounds it (NVIDIA H100 80GB HBM3): the bytes, the candidates' IoU
// rows read once (at most B * N * N * 4: ~0.6 us at B = 8, N = 256, at
// 3.35 TB/s); the real floor is the walk's N dependent steps of a few tens
// of cycles each, several us, which no parallelism across rows shortens.
//
// Exactness: the threshold test is the only float operation, `iou > thr`
// in f32 on the same IoU floats the plain version compares (the caller
// computes them with the same PyTorch code on both routes), with thr the
// f32 rounding of the Python threshold, as PyTorch's comparison with a
// Python scalar rounds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // 32 warps a CTA: the packing's rows in parallel
constexpr int kMaxBoxes = 1024; // 32 words a row: one word a lane of the walking warp
constexpr int kBatch = 8;       // words of a row whose loads a lane issues before their ballots

__global__ void __launch_bounds__(kThreads)
    nms_greedy_kernel(const float* __restrict__ iou, const int* __restrict__ order,
                      const uint8_t* __restrict__ cand, int N, float thr,
                      uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = (N + 31) / 32;
  uint32_t* bits = smem;                                  // N * W words
  int* rank = reinterpret_cast<int*>(bits + N * W);       // rank[i]: i's position in the order
  int* ord = rank + N;                                    // ord[p]: the p-th box
  uint8_t* cnd = reinterpret_cast<uint8_t*>(ord + N);     // cnd[i]: i is a candidate

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(b) * N;
  for (int p = tid; p < N; p += kThreads) {
    const int i = order[row0 + p];
    ord[p] = i;
    rank[i] = p;
    cnd[p] = cand[row0 + p];
  }
  __syncthreads();

  // pack supp: warp `warp` takes rows warp, warp + 32, ...
  const float* m = iou + row0 * N;
  for (int j = warp; j < N; j += kThreads / 32) {
    uint32_t* out = bits + j * W;
    if (!cnd[j]) {  // a non-candidate suppresses nothing
      for (int w = lane; w < W; w += 32) out[w] = 0u;
      continue;
    }
    const int rj = rank[j];
    const float* mj = m + static_cast<size_t>(j) * N;
    for (int w0 = 0; w0 < W; w0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = 32 * (w0 + k) + lane;
        v[k] = (w0 + k < W && i < N) ? mj[i] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (w0 + k < W) {  // uniform across the warp
          const int i = 32 * (w0 + k) + lane;
          const bool s = i < N && rj < rank[i] && v[k] > thr;
          const uint32_t word = __ballot_sync(0xffffffffu, s);
          if (lane == 0) out[w0 + k] = word;
        }
      }
    }
  }
  __syncthreads();

  // the greedy walk: one warp, lane l holds word l of `blocked`
  if (warp != 0) return;
  uint32_t blocked = 0u;
  for (int p = 0; p < N; ++p) {
    const int i = ord[p];
    const uint32_t row = lane < W ? bits[i * W + lane] : 0u;  // independent of `blocked`
    const uint32_t w = __shfl_sync(0xffffffffu, blocked, i >> 5);
    const bool kept = cnd[i] && !((w >> (i & 31)) & 1u);
    if (kept) blocked |= row;
    if (lane == 0) keep[row0 + i] = kept ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches the greedy on `stream`: iou (B, N, N) f32, order (B, N) int32 (a
// permutation of 0..N-1 per row, highest priority first), cand (B, N) and
// keep (B, N) one byte a box (0 or 1). Returns the cudaError_t of the
// launch; N above kMaxBoxes (1024, mirrored by ops/cuda/nms3d.py) is
// cudaErrorInvalidValue.
int votenet_nms3d(const float* iou, const int* order, const uint8_t* cand, int B,
                  int N, float thr, uint8_t* keep, void* stream) {
  if (B < 1 || N < 1 || N > kMaxBoxes) return cudaErrorInvalidValue;
  const int W = (N + 31) / 32;
  const size_t smem = static_cast<size_t>(N) * W * 4 + static_cast<size_t>(N) * 9;
  cudaError_t err =
      cudaFuncSetAttribute(nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_greedy_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      iou, order, cand, N, thr, keep);
  return cudaGetLastError();
}

}  // extern "C"
