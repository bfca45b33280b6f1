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
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): the distance
// tests, B*M*N of them where the balls hold fewer than nsample points (sa1:
// r=0.2 over 20480 points, up to 335 M tests at B=8), fewer where a ball
// fills early. Each test is ~9 f32 operations that must not fuse (3
// subtract, 3 multiply, 2 add, compare), so the CUDA cores' rate for
// instructions other than FMA, about half the FMA peak that the operations
// bound divides by, sets the floor: ~2x that bound.
//
// Design: one thread per query. A block owns kQueries queries of one batch
// row and walks the row's points in shared-memory tiles of kTile points,
// double buffered: cp.async fills the next tile while the current one is
// tested. The tile keeps the points' (x, y, z) layout, so every thread reads
// four points with three 16-byte broadcast loads (all lanes one address: no
// bank conflict) and tests kGroup points against its query held in
// registers before it looks at the hits (independent tests, whose latencies
// overlap), then appends the hits to its own slots; the order within a
// thread is the index order, so no ballot or compaction is needed. A thread
// whose ball is full stops testing, and the block leaves the point loop
// once every query of it is full (__syncthreads_and), which keeps the early
// exit. Points are read from L2 once per block instead of once per query.
//
// Routes (ops/cuda/ballquery.py ballquery_route): with few queries (sa1 at
// B=1: 2048 queries, 16 blocks for 132 SMs) the grid would underfill the
// card, and a thread's tests are a latency chain that only other warps
// hide, so each row's points are cut into `nseg` segments of seg_pts points
// (a multiple of kTile), one block per (query block, segment). A block then
// writes its segment's first <= nsample hits and their count to a scratch,
// and bq_merge_kernel concatenates the segments in order up to nsample and
// pads: exact by construction. With nseg == 1 the kernel writes idx and cnt
// and pads itself.
//
// Bit-exactness hazards:
// - FMA contraction. d2 is ((dx*dx + dy*dy) + dz*dz) in round-to-nearest f32
//   with no fused multiply-add (__fmul_rn/__fadd_rn; the build also passes
//   -fmad=false), the order of votenet_tpu/ops/common.py pairwise_sqdist.
// - r2 rounding. r2 arrives as float32(radius) * float32(radius), squared in
//   f32 on the host, as the JAX XLA twin does (grouping.py:194). The Pallas
//   kernel instead rounds float(radius)**2 taken in double (ballquery.py:217);
//   the two differ by one ulp at radius 0.2, 0.4 and 0.8.
// - Tile padding. Slots past a tile's last point hold +inf coordinates:
//   their d2 is +inf (or NaN), never < r2.
//
// Emit variant (EMIT, ops/cuda/ballquery.py query_ball_point_emit_xyz_cuda):
// replaces the prototype benchmarks/bq_emit_xyz_proto.py:44
// `_bq_emit_kernel`, the same query that also writes the grouped
// coordinates gxyz (B, M, nsample, 3) f32, equal bit for bit to
// group_point(xyz, idx), so the gather that follows each ball query is not
// needed. On the unsplit route the kernel writes a hit's x, y, z from the
// shared-memory tile as it appends the hit, and pads with the first hit's
// (kept in registers) or, for an empty ball, with point 0's. On the split
// route the merge pass writes them as it concatenates the segments, copied
// by index from xyz (an L2 hit: the row was just read). Every value is a
// copy of an input float, so the result is exact by construction. The
// prototype's cost on the TPU, a one-hot contraction per coordinate, has no
// counterpart here: the copy costs 12 bytes a slot of stores.

// fast_bf16 variant (FAST, ops/cuda/ballquery.py, bq_precision="fast_bf16"):
// the port's own kernel for a mode that reaches no Pallas kernel in the JAX
// package (votenet_tpu/ops/grouping.py:111-122 routes it to the XLA twin,
// whose hit test is the matmul expansion of votenet_tpu/ops/common.py:60-76).
// The port follows that twin's TPU semantics, where the einsum's default
// precision feeds the cross term bf16 operands: d2 = (a2 + b2) - 2 * ab with
// a2, b2 the f32 norms of the unrounded query and point, ((x*x + y*y) +
// z*z), and ab = (x'x'' + y'y'') + z'z'' over the coordinates rounded to
// bf16 (nearest, ties to even): each product of two bf16 values is exact in
// f32, and no step fuses. A tile's rounded coordinates and norms are made
// once, when the tile lands, into a second shared array of float4 (x', y',
// z', b2); padding slots get b2 = +inf, so their d2 is +inf. Selection,
// padding of the output, counts, the split route and the merge pass are the
// exact kernel's. Not combined with EMIT.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQueries = 128;  // threads (queries) of a block
constexpr int kTile = 256;     // points of a shared-memory tile
constexpr int kGroup = 16;     // points a thread tests before it looks at the hits
static_assert(kTile % kGroup == 0 && kGroup % 4 == 0, "a tile is whole groups of 4-point loads");

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// |p|^2 of unrounded coordinates, ((x*x + y*y) + z*z), unfused
__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the fast_bf16 hit test's d2: (a2 + b2) - 2 * ab, ab over bf16-rounded
// coordinates (each product exact in f32), p = (x', y', z', b2)
__device__ __forceinline__ float sqdist_fast(float a2, float qx, float qy, float qz,
                                             float4 p) {
  const float ab = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                             __fmul_rn(qz, p.z));
  return __fsub_rn(__fadd_rn(a2, p.w), __fmul_rn(2.0f, ab));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// grid = (ceil(M / kQueries), nseg, B), block = kQueries.
// xyz (B, N, 3), new_xyz (B, M, 3) f32. nseg == 1: out_idx is idx
// (B, M, nsample) and out_cnt is cnt (B, M), padded here, and with EMIT
// gxyz (B, M, nsample, 3) too; nseg > 1 (EMIT false): out_idx is the
// scratch (B, M, nseg, nsample) and out_cnt (B, M, nseg) the hits of each
// segment (at most nsample), merged by bq_merge_kernel. FAST: the fast_bf16
// hit test (the note at the top), EMIT false.
template <bool EMIT, bool FAST>
__global__ void __launch_bounds__(kQueries)
    ballquery_kernel(const float* __restrict__ xyz,
                     const float* __restrict__ new_xyz, int N, int M,
                     int seg_pts, int nseg, float r2, int nsample,
                     int* __restrict__ out_idx, int* __restrict__ out_cnt,
                     float* __restrict__ gxyz) {
  __shared__ __align__(16) float tile[2][kTile * 3];
  __shared__ float4 ftile[FAST ? kTile : 1];  // FAST: (x', y', z', b2) of the current tile

  const int tid = threadIdx.x;
  const int m = blockIdx.x * kQueries + tid;
  const int seg = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = m < M;
  const size_t q = static_cast<size_t>(b) * M + m;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  const int k_begin = seg * seg_pts;
  const int k_end = min(N, k_begin + seg_pts);
  const int ntiles = (k_end - k_begin + kTile - 1) / kTile;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    qx = new_xyz[3 * q];
    qy = new_xyz[3 * q + 1];
    qz = new_xyz[3 * q + 2];
  }
  // FAST: the query's f32 norm, then its coordinates rounded to bf16
  const float a2 = FAST ? sqnorm(qx, qy, qz) : 0.0f;
  if constexpr (FAST) {
    qx = round_bf16(qx);
    qy = round_bf16(qy);
    qz = round_bf16(qz);
  }
  int* out = out_idx + (q * nseg + seg) * nsample;

  // tile t of this segment into buffer t & 1; +inf past the last point
  auto load = [&](int t) {
    const int k0 = k_begin + t * kTile;
    const int n3 = min(kTile, k_end - k0) * 3;
    float* dst = tile[t & 1];
    const float* src = p + static_cast<size_t>(k0) * 3;
    for (int e = tid; e < kTile * 3; e += kQueries) {
      if (e < n3) {
        cp_async4(dst + e, src + e);
      } else {
        dst[e] = __int_as_float(0x7f800000);
      }
    }
    cp_async_commit();
  };

  int found = active ? 0 : nsample;  // an idle thread counts as full
  int first = 0;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;  // EMIT: the first hit's coordinates
  float* g = EMIT ? gxyz + q * nsample * 3 : nullptr;
  load(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in shared memory for every thread
    const int k0 = k_begin + t * kTile;
    if constexpr (FAST) {  // the tile's rounded coordinates and norms, once
      const float* c = tile[t & 1];
      const int n = min(kTile, k_end - k0);
      for (int e = tid; e < kTile; e += kQueries) {
        ftile[e] = e < n ? make_float4(round_bf16(c[3 * e]), round_bf16(c[3 * e + 1]),
                                       round_bf16(c[3 * e + 2]),
                                       sqnorm(c[3 * e], c[3 * e + 1], c[3 * e + 2]))
                         : make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
      }
      __syncthreads();
    }
    if (found < nsample) {
      const float4* v = reinterpret_cast<const float4*>(tile[t & 1]);
      const int ngroups = (min(kTile, k_end - k0) + kGroup - 1) / kGroup;
      for (int j = 0; j < ngroups; ++j) {
        // kGroup points, four at a time from three 16-byte loads: independent
        // tests, so their latencies overlap
        unsigned hits = 0u;
        if constexpr (FAST) {
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            hits |= static_cast<unsigned>(sqdist_fast(a2, qx, qy, qz, ftile[j * kGroup + i]) < r2)
                    << i;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kGroup / 4; ++i) {
            const float4 a = v[3 * (j * kGroup / 4 + i)];
            const float4 c = v[3 * (j * kGroup / 4 + i) + 1];
            const float4 e = v[3 * (j * kGroup / 4 + i) + 2];
            hits |= (static_cast<unsigned>(sqdist(qx, qy, qz, a.x, a.y, a.z) < r2) |
                     static_cast<unsigned>(sqdist(qx, qy, qz, a.w, c.x, c.y) < r2) << 1 |
                     static_cast<unsigned>(sqdist(qx, qy, qz, c.z, c.w, e.x) < r2) << 2 |
                     static_cast<unsigned>(sqdist(qx, qy, qz, e.y, e.z, e.w) < r2) << 3)
                    << (4 * i);
          }
        }
        while (hits != 0u && found < nsample) {  // in index order
          const int k = k0 + j * kGroup + __ffs(hits) - 1;
          hits &= hits - 1u;
          if (found == 0) first = k;
          if constexpr (EMIT) {  // the hit's coordinates, from the tile
            const float* c = tile[t & 1] + 3 * (k - k0);
            g[3 * found] = c[0];
            g[3 * found + 1] = c[1];
            g[3 * found + 2] = c[2];
            if (found == 0) {
              fx = c[0];
              fy = c[1];
              fz = c[2];
            }
          }
          out[found++] = k;
        }
        if (found == nsample) break;
      }
    }
    // every query full: the block is done. Also the barrier after which the
    // buffer of tile t may be refilled (by load(t + 2)).
    if (__syncthreads_and(found >= nsample)) break;
  }
  cp_async_wait<0>();  // no copy may land after the block has left
  if (!active) return;

  if (nseg == 1) {
    const int fill = found > 0 ? first : 0;
    for (int s = found; s < nsample; ++s) out[s] = fill;
    if constexpr (EMIT) {
      if (found == 0) {  // an empty ball: point 0
        fx = p[0];
        fy = p[1];
        fz = p[2];
      }
      for (int s = found; s < nsample; ++s) {
        g[3 * s] = fx;
        g[3 * s + 1] = fy;
        g[3 * s + 2] = fz;
      }
    }
    out_cnt[q] = found;
  } else {
    out_cnt[q * nseg + seg] = found;
  }
}

// One warp per query: the segments' hits in segment order, up to nsample,
// then finalize_first_k's padding; with EMIT also each slot's coordinates
// into gxyz (B, M, nsample, 3), copied from xyz (B, N, 3) by index.
// grid = ceil(B*M / 8), block = 256.
template <bool EMIT>
__global__ void bq_merge_kernel(const int* __restrict__ seg_idx,
                                const int* __restrict__ seg_cnt, int total,
                                int nseg, int nsample, int* __restrict__ idx,
                                int* __restrict__ cnt, const float* __restrict__ xyz,
                                int N, int M, float* __restrict__ gxyz) {
  const int q = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= total) return;  // uniform across the warp
  int* out = idx + static_cast<size_t>(q) * nsample;
  const float* p = EMIT ? xyz + static_cast<size_t>(q / M) * N * 3 : nullptr;
  float* g = EMIT ? gxyz + static_cast<size_t>(q) * nsample * 3 : nullptr;
  int c = 0;
  for (int s = 0; s < nseg && c < nsample; ++s) {
    const size_t qs = static_cast<size_t>(q) * nseg + s;
    const int n = min(seg_cnt[qs], nsample - c);
    const int* src = seg_idx + qs * nsample;
    for (int i = lane; i < n; i += 32) {
      const int k = src[i];
      out[c + i] = k;
      if constexpr (EMIT) {
        g[3 * (c + i)] = p[3 * k];
        g[3 * (c + i) + 1] = p[3 * k + 1];
        g[3 * (c + i) + 2] = p[3 * k + 2];
      }
    }
    c += n;
  }
  __syncwarp();
  const int fill = c > 0 ? out[0] : 0;
  for (int s = c + lane; s < nsample; s += 32) {
    out[s] = fill;
    if constexpr (EMIT) {
      g[3 * s] = p[3 * fill];
      g[3 * s + 1] = p[3 * fill + 1];
      g[3 * s + 2] = p[3 * fill + 2];
    }
  }
  if (lane == 0) cnt[q] = c;
}

}  // namespace

extern "C" {

// Launches the ball query on `stream`; returns the cudaError_t of the
// launches. nseg == 1: one kernel writes idx and cnt. nseg > 1: seg_idx
// (B*M*nseg*nsample int32) and seg_cnt (B*M*nseg int32) are scratch, and a
// merge kernel writes idx and cnt. seg_pts is a multiple of the tile. A
// non-null gxyz (B*M*nsample*3 f32) runs the emit variant, which also
// writes the grouped coordinates there. fast_bf16 != 0 runs the fast_bf16
// hit test (not with gxyz).
int votenet_ball_query(const float* xyz, const float* new_xyz, int B, int N,
                       int M, float r2, int nsample, int nseg, int seg_pts,
                       int fast_bf16, int* seg_idx, int* seg_cnt, int* idx, int* cnt,
                       float* gxyz, void* stream) {
  if ((fast_bf16 && gxyz != nullptr) ||
      B < 1 || N < 1 || M < 1 || nsample < 1 || nseg < 1 || seg_pts < 1 ||
      seg_pts % kTile != 0 || (nseg - 1) * seg_pts >= N ||
      static_cast<long long>(nseg) * seg_pts < N || B > 65535 || nseg > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kQueries - 1) / kQueries, nseg, B);
  const bool emit = gxyz != nullptr;
  if (nseg == 1) {
    if (emit) {
      ballquery_kernel<true, false><<<grid, kQueries, 0, s>>>(xyz, new_xyz, N, M, seg_pts, 1,
                                                              r2, nsample, idx, cnt, gxyz);
    } else if (fast_bf16) {
      ballquery_kernel<false, true><<<grid, kQueries, 0, s>>>(xyz, new_xyz, N, M, seg_pts, 1,
                                                              r2, nsample, idx, cnt, nullptr);
    } else {
      ballquery_kernel<false, false><<<grid, kQueries, 0, s>>>(xyz, new_xyz, N, M, seg_pts, 1,
                                                               r2, nsample, idx, cnt, nullptr);
    }
    return cudaGetLastError();
  }
  if (fast_bf16) {
    ballquery_kernel<false, true><<<grid, kQueries, 0, s>>>(
        xyz, new_xyz, N, M, seg_pts, nseg, r2, nsample, seg_idx, seg_cnt, nullptr);
  } else {
    ballquery_kernel<false, false><<<grid, kQueries, 0, s>>>(
        xyz, new_xyz, N, M, seg_pts, nseg, r2, nsample, seg_idx, seg_cnt, nullptr);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = B * M;
  if (emit) {
    bq_merge_kernel<true><<<(total + 7) / 8, 256, 0, s>>>(seg_idx, seg_cnt, total, nseg,
                                                          nsample, idx, cnt, xyz, N, M, gxyz);
  } else {
    bq_merge_kernel<false><<<(total + 7) / 8, 256, 0, s>>>(seg_idx, seg_cnt, total, nseg,
                                                           nsample, idx, cnt, nullptr, N, M, nullptr);
  }
  return cudaGetLastError();
}

}  // extern "C"
