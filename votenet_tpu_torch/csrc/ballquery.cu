// Exact ball query on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel votenet_tpu/ops/pallas/ballquery.py:71
// `_bq_kernel` (wrapper `query_ball_point_pallas`, :156), which the JAX
// package routes from votenet_tpu/ops/grouping.py:111-122.
//
// What it computes: for every query q of (B, M) over the points of its batch
// row (B, N), a point k is a hit iff d2(q, k) < r2, strictly; idx holds the
// first `nsample` hits in index order, cnt the hit count saturated at
// nsample. Slots past the last hit repeat the first hit, and an empty ball
// is all index 0 (votenet_tpu/ops/grouping.py:536-544 finalize_first_k,
// applied here in the kernel).
//
// What bounds it on the H100: the distance tests, B*M*N of them in the
// worst case, each three loads through L2 and a few FLOPs, so L2 bandwidth
// and instruction throughput; a query whose ball fills early stops early.
// The TPU kernel's MXU extraction (chunk counts, one-hot gathers,
// triangular-matmul ranks, ballquery.py:107-150) exists because the TPU has
// no cheap compaction; here a warp compacts 32 points at a time with one
// ballot.
//
// Design: one warp per query. The warp walks the points in index order, 32
// at a time: each lane tests one point, __ballot_sync gathers the hits, and
// a popcount under the lanes-below mask gives each hit its slot. The walk
// stops once nsample hits are found. Staging point tiles in shared memory
// for the warps of a block is left for a later change.
//
// Bit-exactness hazards:
// - FMA contraction. d2 is ((dx*dx + dy*dy) + dz*dz) in round-to-nearest f32
//   with no fused multiply-add (__fmul_rn/__fadd_rn; the build also passes
//   -fmad=false), the order of votenet_tpu/ops/common.py pairwise_sqdist.
// - r2 rounding. r2 arrives as float32(radius) * float32(radius), squared in
//   f32 on the host, as the JAX XLA twin does (grouping.py:194). The Pallas
//   kernel instead rounds float(radius)**2 taken in double (ballquery.py:217);
//   the two differ by one ulp at radius 0.2, 0.4 and 0.8.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// grid = ceil(B*M / kWarpsPerBlock), block = 32 * kWarpsPerBlock.
// xyz (B, N, 3), new_xyz (B, M, 3) f32; idx (B, M, nsample), cnt (B, M) i32.
__global__ void ballquery_kernel(const float* __restrict__ xyz,
                                 const float* __restrict__ new_xyz, int N,
                                 int M, int total, float r2, int nsample,
                                 int* __restrict__ idx, int* __restrict__ cnt) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= total) return;  // uniform across the warp
  const float* p = xyz + static_cast<size_t>(q / M) * N * 3;
  const float qx = new_xyz[3 * static_cast<size_t>(q)];
  const float qy = new_xyz[3 * static_cast<size_t>(q) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(q) + 2];
  int* out = idx + static_cast<size_t>(q) * nsample;
  const unsigned below = (1u << lane) - 1u;

  int found = 0;  // the same in every lane
  int first = 0;
  for (int base = 0; base < N && found < nsample; base += 32) {
    const int k = base + lane;
    const bool hit =
        k < N && sqdist(qx, qy, qz, p[3 * k], p[3 * k + 1], p[3 * k + 2]) < r2;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0u) continue;
    if (found == 0) first = base + __ffs(mask) - 1;
    const int slot = found + __popc(mask & below);
    if (hit && slot < nsample) out[slot] = k;
    found += __popc(mask);
  }
  const int c = found < nsample ? found : nsample;
  const int fill = c > 0 ? first : 0;
  for (int s = c + lane; s < nsample; s += 32) out[s] = fill;
  if (lane == 0) cnt[q] = c;
}

}  // namespace

extern "C" {

// Launches the ball query on `stream`; returns the cudaError_t of the launch.
int votenet_ball_query(const float* xyz, const float* new_xyz, int B, int N,
                       int M, float r2, int nsample, int* idx, int* cnt,
                       void* stream) {
  const int total = B * M;
  const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ballquery_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, N, M, total, r2, nsample, idx, cnt);
  return cudaGetLastError();
}

}  // extern "C"
