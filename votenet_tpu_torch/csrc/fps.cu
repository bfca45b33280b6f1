// Farthest-point sampling on Hopper (sm_90a), one thread-block cluster per
// batch row.
//
// Replaces the two Pallas TPU kernels of votenet_tpu/ops/pallas/fps.py:
// `_fps_kernel` (:47, batches on the sublanes, the JAX route at B > 2) and
// `_fps_rowwise_kernel` (:79, one batch row per program, B <= 2). One kernel
// serves both routes.
//
// What it computes (the semantics of votenet_tpu/ops/sampling.py
// farthest_point_sample_xla): slot 0 is index 0; every later slot picks the
// argmax of the running minimum of squared distances to the points picked so
// far (initialised to 1e38), lowest index on ties.
//
// What bounds it on the H100: the npoint steps are strictly sequential.
// The arithmetic is ~10 f32 operations a point and step (3.35 GFLOP at sa1,
// B=8: 50 us at 67 TFLOP/s) and the coordinates are read once; so each step
// is bound by latency: the argmax's reductions and barriers, not bandwidth.
//
// Design: a batch row is split over a cluster of `cs` CTAs (1-16, chosen by
// the wrapper, ops/cuda/fps.py fps_plan), 256 threads each. CTA rank
// r owns the contiguous slice [r*S, (r+1)*S) of the row, S = ceil(N / cs),
// and each thread owns the points r*S + tid + p*256, p < PPT. Their x, y, z
// and running minimum stay in registers for the whole run (PPT = 1-32:
// up to 131072 points at cs = 16). Where the wrapper's cluster leaves more
// than 32 points a thread (eval's sa1 at B=64: its 64 clusters of 8 or 4
// CTAs are not all resident, so cs falls to 2) the staged instance takes
// the row: PPT = 40, 212 registers, one CTA an SM, so 64 rows of 20480
// points are all on chip in one wave of clusters of 2. It also copies its
// slice of xyz into shared memory, so that a thread's scan keeps only
// (value, slot), three instructions a point fewer than the five-word
// candidate, and its warp reads the winner's coordinates there once a
// step. Past that the PPT = 0 variant reads the coordinates from device
// memory each step and keeps the minimum in a wrapper-allocated global
// scratch (7.9 us a step at sa1's B=64 shape against the staged 1.04).
// With cs > 1 a step has no barrier, neither of the CTA nor of the cluster:
//  1. every thread updates its minima against the last pick and keeps its
//     best (value, index, x, y, z); two redux.sync over the value's bits and
//     the index find the warp's winner;
//  2. lanes 0..cs-1 of every warp send the warp's winner into slot
//     (rank, warp) of CTA `lane`'s shared memory with st.async, which
//     counts its bytes on that CTA's mbarrier for the step (double-buffered
//     by step parity);
//  3. every warp waits on its own CTA's mbarrier until all cs * 8
//     candidates of the step have landed, reduces them itself, and so knows
//     the pick and its coordinates. Rank 0 writes out[j].
// No device-memory access remains in the loop except that write (and the
// PPT = 0 variant's loads). Why two buffers suffice: a warp sends step j + 2
// into buffer p only after its CTA received step j + 1 from every warp of
// the cluster, and each warp sent step j + 1 after it finished reading
// buffer p at step j; thread 0 re-arms the mbarrier of buffer p for step
// j + 2 right after its step-j wait, before its own warp sends step j + 1.
// A cluster barrier a step (barrier.cluster) cost more than this one-sided
// signal. With cs = 1 the warps' winners go through the CTA's own shared
// memory and one __syncthreads a step, which is cheaper than st.async to
// itself. Sending one candidate per CTA instead of per warp (a
// __syncthreads and a CTA reduction first) was slower at 8 CTAs.
//
// Bit-exactness hazards:
// - FMA contraction. d2 is ((dx*dx + dy*dy) + dz*dz) in round-to-nearest f32
//   with no fused multiply-add, written with __fmul_rn/__fadd_rn (the build
//   also passes -fmad=false). A contracted d2 rounds differently and changes
//   which point wins a step.
// - Ties, also across CTA boundaries. A thread scans its points in ascending
//   index and replaces its best only on a strictly greater value; every
//   reduction (warp, CTA, cluster) prefers the lower index on equal values.
//   Points past the row's end carry a minimum of -1 and threads without a
//   point carry (-1, INT_MAX): neither beats a real point (minimum >= 0).
//
// Noscalar variant (NOSCALAR, ops/cuda/fps.py fps_rowwise_noscalar_cuda):
// replaces the prototype benchmarks/fps_noscalar_proto.py:47
// `_fps_rowwise_noscalar_kernel`, which takes the pick's coordinates from
// masked sums instead of a round trip through scalar memory. Here the
// question is the exchange: a candidate is (value, index), 8 bytes and one
// st.async, where the production candidate carries x, y, z too (20 bytes,
// two st.async on the latency chain of every step). Once every warp has
// reduced the step's candidates to the pick, the warp that owns the pick
// takes its coordinates by three masked sums over its points' registers
// (the bits of each coordinate where the index is the pick, 0 elsewhere,
// summed by redux.sync: one nonzero term, so exact, -0.0 kept) and sends
// them to every CTA of the cluster, 16 bytes on a second mbarrier a step;
// every warp waits for them. So a step has two exchanges in turn where the
// production kernel has one. With one CTA the second exchange is a second
// __syncthreads. Register variants only (PPT > 0): the coordinates are never
// read again from device memory.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxPpt = 32;

struct __align__(16) Cand {
  float v;
  int i;
  float x, y, z;
};

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` in the CTA of rank `rank`.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of st.async traffic in this phase.
__device__ __forceinline__ void bar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Store c into the remote slot `slot` (a shared::cluster address) and count
// its 20 bytes on the remote mbarrier `bar`.
__device__ __forceinline__ void send(unsigned slot, unsigned bar, const Cand& c) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(
          slot),
      "r"(__float_as_uint(c.v)), "r"(static_cast<unsigned>(c.i)), "r"(__float_as_uint(c.x)),
      "r"(__float_as_uint(c.y)), "r"(bar)
      : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(slot + 16),
               "r"(__float_as_uint(c.z)), "r"(bar)
               : "memory");
}

constexpr unsigned kCandBytes = 20;  // what send() moves

// The noscalar variant's candidate.
struct __align__(8) Pick {
  float v;
  int i;
};

constexpr unsigned kPickBytes = 8;   // what send_pick() moves
constexpr unsigned kCoordBytes = 16;  // what send_xyz() moves

// Store (v, i) into the remote slot `slot` and count its 8 bytes on the
// remote mbarrier `bar`.
__device__ __forceinline__ void send_pick(unsigned slot, unsigned bar, float v, int i) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];" ::"r"(slot),
               "r"(__float_as_uint(v)), "r"(static_cast<unsigned>(i)), "r"(bar)
               : "memory");
}

// Store the bits of (x, y, z) and a pad into the remote slot `slot` and
// count its 16 bytes on the remote mbarrier `bar`.
__device__ __forceinline__ void send_xyz(unsigned slot, unsigned bar, unsigned x, unsigned y, unsigned z) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(
                   slot),
               "r"(x), "r"(y), "r"(z), "r"(0u), "r"(bar)
               : "memory");
}

// (v, i) beats (bv, bi): larger value, or the same value at a lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Warp argmax of (v, i), v < 0 meaning "no point": every lane ends with the
// largest v and the lowest index holding it, or (-1, INT_MAX). A
// non-negative float's bits order like the float, so two redux.sync do it.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  const unsigned bits = v >= 0.0f ? __float_as_uint(v) : 0u;
  const unsigned top = __reduce_max_sync(0xffffffffu, bits);
  i = __reduce_min_sync(0xffffffffu, bits == top && v >= 0.0f ? i : INT_MAX);
  v = i == INT_MAX ? -1.0f : __uint_as_float(top);
}

// The coordinates of the lane holding index wi (any lane when none does).
__device__ __forceinline__ void owner_xyz(const Cand& mine, int wi, float* x, float* y, float* z) {
  const unsigned own = __ballot_sync(0xffffffffu, mine.i == wi);
  const int src = own ? __ffs(own) - 1 : 0;
  *x = __shfl_sync(0xffffffffu, mine.x, src);
  *y = __shfl_sync(0xffffffffu, mine.y, src);
  *z = __shfl_sync(0xffffffffu, mine.z, src);
}

// grid = B * cs CTAs in clusters of cs, block = kThreads.
// xyz (B, N, 3) f32, out (B, npoint) i32, scratch (B, N) f32 for PPT == 0.
// NOSCALAR (PPT > 0 only): the noscalar variant. STAGED (the staged route,
// PPT > 0 only): the CTA's slice of xyz also in dynamic shared memory, so
// that a thread's scan keeps (value, slot) alone and a warp reads its
// winner's coordinates there once a step.
template <int PPT, bool NOSCALAR, bool STAGED = false>
__global__ void __launch_bounds__(kThreads)
    fps_cluster_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out,
                       float* __restrict__ scratch) {
  static_assert(!NOSCALAR || PPT > 0, "the noscalar variant keeps its points in registers");
  static_assert(!STAGED || (PPT > 0 && !NOSCALAR), "the staged scan keeps its points in registers");
  __shared__ Cand cand[2][kMaxCluster * kWarps];  // slot rank * kWarps + warp
  __shared__ Pick pk[2][kMaxCluster * kWarps];    // NOSCALAR: the step's candidates, as cand
  __shared__ uint4 coord[2];                      // NOSCALAR: the bits of the pick's x, y, z
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ __align__(8) unsigned long long cbar[2];  // NOSCALAR: coord's mbarriers
  extern __shared__ float staged[];                    // STAGED: x, y, z of the slice's points
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  const int S = (N + cs - 1) / cs;
  const int lo = min(N, rank * S), hi = min(N, lo + S);
  const unsigned step_bytes = (NOSCALAR ? kPickBytes : kCandBytes) * kWarps * cs;
  const unsigned bar_addr[2] = {smem_addr(&bar[0]), smem_addr(&bar[1])};
  const unsigned cbar_addr[2] = {smem_addr(&cbar[0]), smem_addr(&cbar[1])};

  constexpr int kRegs = PPT > 0 ? PPT : 1;
  float px[kRegs], py[kRegs], pz[kRegs], pm[kRegs];
  float* mind = PPT == 0 ? scratch + static_cast<size_t>(b) * N : nullptr;
  if constexpr (PPT > 0) {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      const int i = lo + tid + q * kThreads;
      const bool in = i < hi;
      px[q] = in ? p[3 * i] : 0.0f;
      py[q] = in ? p[3 * i + 1] : 0.0f;
      pz[q] = in ? p[3 * i + 2] : 0.0f;
      pm[q] = in ? 1e38f : -1.0f;
    }
  } else {
    for (int i = lo + tid; i < hi; i += kThreads) mind[i] = 1e38f;
  }
  if constexpr (STAGED) {
    for (int t = tid; t < 3 * (hi - lo); t += kThreads) staged[t] = p[3 * lo + t];
  }
  if (tid == 0 && cs > 1) {
    bar_init(bar_addr[0], 1);
    bar_init(bar_addr[1], 1);
    if constexpr (NOSCALAR) {
      bar_init(cbar_addr[0], 1);
      bar_init(cbar_addr[1], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (npoint > 1) bar_arm(bar_addr[1], step_bytes);  // step 1
    if (npoint > 2) bar_arm(bar_addr[0], step_bytes);  // step 2
    if constexpr (NOSCALAR) {
      if (npoint > 1) bar_arm(cbar_addr[1], kCoordBytes);
      if (npoint > 2) bar_arm(cbar_addr[0], kCoordBytes);
    }
  }
  float cx = p[0], cy = p[1], cz = p[2];
  if (rank == 0 && tid == 0) out[static_cast<size_t>(b) * npoint] = 0;
  cluster.sync();  // every peer has started and armed before the first send

  // this warp's slot and the step's mbarrier in CTA `lane` (lanes < cs)
  const unsigned peer = static_cast<unsigned>(lane < cs ? lane : 0);
  const unsigned slot_off = static_cast<unsigned>((rank * kWarps + warp) * (NOSCALAR ? sizeof(Pick) : sizeof(Cand)));
  const void* const slots_at[2] = {NOSCALAR ? static_cast<const void*>(pk[0]) : static_cast<const void*>(cand[0]),
                                   NOSCALAR ? static_cast<const void*>(pk[1]) : static_cast<const void*>(cand[1])};
  const unsigned remote_cand[2] = {map_rank(smem_addr(slots_at[0]), peer) + slot_off,
                                   map_rank(smem_addr(slots_at[1]), peer) + slot_off};
  const unsigned remote_bar[2] = {map_rank(bar_addr[0], peer), map_rank(bar_addr[1], peer)};
  // NOSCALAR: the pick's coordinates and their mbarrier in CTA `lane`
  unsigned remote_coord[2] = {0u, 0u}, remote_cbar[2] = {0u, 0u};
  if constexpr (NOSCALAR) {
    for (int i = 0; i < 2; ++i) {
      remote_coord[i] = map_rank(smem_addr(&coord[i]), peer);
      remote_cbar[i] = map_rank(cbar_addr[i], peer);
    }
  }
  const int slots = cs * kWarps;

  for (int j = 1; j < npoint; ++j) {
    const int par = j & 1;
    if constexpr (NOSCALAR) {
      Pick best = {-1.0f, INT_MAX};
#pragma unroll
      for (int q = 0; q < kRegs; ++q) {
        const float m = fminf(pm[q], sqdist(px[q], py[q], pz[q], cx, cy, cz));
        pm[q] = m;
        if (m > best.v) best = {m, lo + tid + q * kThreads};
      }
      warp_argmax(best.v, best.i);
      if (cs == 1) {
        if (lane == 0) pk[par][warp] = best;
        __syncthreads();
      } else {
        if (lane < cs) send_pick(remote_cand[par], remote_bar[par], best.v, best.i);
        bar_wait(bar_addr[par], ((j - 1) >> 1) & 1);
        if (tid == 0 && j + 2 < npoint) bar_arm(bar_addr[par], step_bytes);
      }
      Pick mine = {-1.0f, INT_MAX};
      for (int s = lane; s < slots; s += 32) {
        const Pick c = pk[par][s];
        if (beats(c.v, c.i, mine.v, mine.i)) mine = c;
      }
      warp_argmax(mine.v, mine.i);
      const int pick = mine.i;
      // the warp that owns the pick: its coordinates by masked sums over
      // the points' registers, sent to every CTA
      const int rel = pick - lo;
      if (rel >= 0 && rel < hi - lo && (rel % kThreads) / 32 == warp) {
        unsigned bx = 0u, by = 0u, bz = 0u;
#pragma unroll
        for (int q = 0; q < kRegs; ++q) {
          const bool at = lo + tid + q * kThreads == pick;
          bx += at ? __float_as_uint(px[q]) : 0u;
          by += at ? __float_as_uint(py[q]) : 0u;
          bz += at ? __float_as_uint(pz[q]) : 0u;
        }
        bx = __reduce_add_sync(0xffffffffu, bx);
        by = __reduce_add_sync(0xffffffffu, by);
        bz = __reduce_add_sync(0xffffffffu, bz);
        if (cs == 1) {
          if (lane == 0) coord[par] = make_uint4(bx, by, bz, 0u);
        } else if (lane < cs) {
          send_xyz(remote_coord[par], remote_cbar[par], bx, by, bz);
        }
      }
      if (cs == 1) {
        __syncthreads();
      } else {
        bar_wait(cbar_addr[par], ((j - 1) >> 1) & 1);
        if (tid == 0 && j + 2 < npoint) bar_arm(cbar_addr[par], kCoordBytes);
      }
      const uint4 c = coord[par];
      cx = __uint_as_float(c.x);
      cy = __uint_as_float(c.y);
      cz = __uint_as_float(c.z);
      if (rank == 0 && tid == 0) out[static_cast<size_t>(b) * npoint + j] = pick;
      continue;
    }
    Cand best = {-1.0f, INT_MAX, 0.0f, 0.0f, 0.0f};
    if constexpr (STAGED) {  // (value, slot) alone; the index once the thread's best is known
      int bq = 0;
#pragma unroll
      for (int q = 0; q < kRegs; ++q) {
        const float m = fminf(pm[q], sqdist(px[q], py[q], pz[q], cx, cy, cz));
        pm[q] = m;
        if (m > best.v) {
          best.v = m;
          bq = q;
        }
      }
      if (best.v >= 0.0f) best.i = lo + tid + bq * kThreads;
    } else if constexpr (PPT > 0) {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) {
        const float m = fminf(pm[q], sqdist(px[q], py[q], pz[q], cx, cy, cz));
        pm[q] = m;
        if (m > best.v) best = {m, lo + tid + q * kThreads, px[q], py[q], pz[q]};
      }
    } else {
      for (int i = lo + tid; i < hi; i += kThreads) {
        const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
        const float m = fminf(mind[i], sqdist(x, y, z, cx, cy, cz));
        mind[i] = m;
        if (m > best.v) best = {m, i, x, y, z};
      }
    }
    Cand win = best;
    warp_argmax(win.v, win.i);
    if constexpr (STAGED) {
      const float* w = staged + 3 * (win.i == INT_MAX ? 0 : win.i - lo);  // one word for the whole warp
      win.x = w[0];
      win.y = w[1];
      win.z = w[2];
    } else {
      owner_xyz(best, win.i, &win.x, &win.y, &win.z);
    }
    if (cs == 1) {  // one CTA: its own shared memory and one barrier
      if (lane == 0) cand[par][warp] = win;
      __syncthreads();
    } else {
      if (lane < cs) send(remote_cand[par], remote_bar[par], win);
      bar_wait(bar_addr[par], ((j - 1) >> 1) & 1);  // step j is use (j - 1) / 2 of its buffer
      if (tid == 0 && j + 2 < npoint) bar_arm(bar_addr[par], step_bytes);  // step j + 2
    }
    Cand mine = {-1.0f, INT_MAX, 0.0f, 0.0f, 0.0f};
    for (int s = lane; s < slots; s += 32) {
      const Cand c = cand[par][s];
      if (beats(c.v, c.i, mine.v, mine.i)) mine = c;
    }
    float pv = mine.v;
    int pick = mine.i;
    warp_argmax(pv, pick);
    owner_xyz(mine, pick, &cx, &cy, &cz);
    if (rank == 0 && tid == 0) out[static_cast<size_t>(b) * npoint + j] = pick;
  }
  cluster.sync();  // no CTA leaves while a peer's sends to it may be in flight
}

// One instance of the kernel: its launch and its resident-cluster count.
template <int PPT, bool NOSCALAR = false, bool STAGED = false>
struct Fps {
  static constexpr int smem = STAGED ? 3 * kThreads * PPT * static_cast<int>(sizeof(float)) : 0;

  // The attributes a launch of cs CTAs a cluster needs, set on the current
  // device; then the launch's configuration (attr is filled in place).
  static cudaError_t configure(int grid, int cs, cudaStream_t stream, cudaLaunchConfig_t* config,
                               cudaLaunchAttribute* attr) {
    const auto kernel = fps_cluster_kernel<PPT, NOSCALAR, STAGED>;
    if (cs > 8) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    if (smem > 0) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    *config = {};
    config->gridDim = dim3(grid);
    config->blockDim = dim3(kThreads);
    config->dynamicSmemBytes = smem;
    config->stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = cs;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    config->attrs = attr;
    config->numAttrs = 1;
    return cudaSuccess;
  }

  static cudaError_t launch(const float* xyz, int B, int N, int npoint, int cs, int* out, float* scratch,
                            cudaStream_t stream) {
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr;
    const cudaError_t err = configure(B * cs, cs, stream, &config, &attr);
    if (err != cudaSuccess) return err;
    return cudaLaunchKernelEx(&config, fps_cluster_kernel<PPT, NOSCALAR, STAGED>, xyz, N, npoint, out, scratch);
  }

  // cudaOccupancyMaxActiveClusters, or minus a cudaError_t.
  static int max_clusters(int cs) {
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr;
    cudaError_t err = configure(cs, cs, nullptr, &config, &attr);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, fps_cluster_kernel<PPT, NOSCALAR, STAGED>, &config);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
};

// The staged route's instance: 40 points a thread in registers (10240 a
// CTA, one CTA an SM), the slice staged in shared memory.
constexpr int kStagedPpt = 40;
using Staged = Fps<kStagedPpt, false, true>;

bool valid_cluster(int cs) { return cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16; }

bool valid_args(int cs, int ppt) {
  switch (ppt) {
    case 0: case 1: case 2: case 4: case 5: case 8: case 10: case 16: case 20: case 32:
      return valid_cluster(cs);
    default:
      return false;
  }
}

}  // namespace

extern "C" {

// Launches FPS on `stream` over clusters of `cs` CTAs (1, 2, 4, 8 or 16), each
// thread keeping `ppt` points in registers (1, 2, 4, 5, 8, 10, 16, 20 or 32, with
// 256 * ppt * cs >= N), or ppt = 0: coordinates from device memory and the
// running minimum in `scratch`, a (B, N) f32 device buffer (else null).
// noscalar != 0 launches the noscalar variant (ppt > 0 only). Returns the
// cudaError_t of the launch.
int votenet_fps(const float* xyz, int B, int N, int npoint, int cs, int ppt, int noscalar, int* out,
                float* scratch, void* stream) {
  if (!valid_args(cs, ppt) || (ppt == 0 && scratch == nullptr) ||
      (ppt > 0 && static_cast<long long>(kThreads) * ppt * cs < N) || (noscalar != 0 && noscalar != 1) ||
      (noscalar && ppt == 0))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noscalar) {
    switch (ppt) {
      case 1: return Fps<1, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
      case 2: return Fps<2, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
      case 4: return Fps<4, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
      case 5: return Fps<5, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
      case 8: return Fps<8, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
      case 10: return Fps<10, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
      case 16: return Fps<16, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
      case 20: return Fps<20, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
      default: return Fps<kMaxPpt, true>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    }
  }
  switch (ppt) {
    case 0: return Fps<0>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    case 1: return Fps<1>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    case 2: return Fps<2>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    case 4: return Fps<4>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    case 5: return Fps<5>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    case 8: return Fps<8>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    case 10: return Fps<10>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    case 16: return Fps<16>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    case 20: return Fps<20>::launch(xyz, B, N, npoint, cs, out, scratch, s);
    default: return Fps<kMaxPpt>::launch(xyz, B, N, npoint, cs, out, scratch, s);
  }
}

// How many clusters of `cs` CTAs of the `ppt` variant can be resident on the
// current device at once (cudaOccupancyMaxActiveClusters); a negative value
// is minus a cudaError_t.
int votenet_fps_max_clusters(int cs, int ppt) {
  if (!valid_args(cs, ppt)) return -static_cast<int>(cudaErrorInvalidValue);
  switch (ppt) {
    case 0: return Fps<0>::max_clusters(cs);
    case 1: return Fps<1>::max_clusters(cs);
    case 2: return Fps<2>::max_clusters(cs);
    case 4: return Fps<4>::max_clusters(cs);
    case 5: return Fps<5>::max_clusters(cs);
    case 8: return Fps<8>::max_clusters(cs);
    case 10: return Fps<10>::max_clusters(cs);
    case 16: return Fps<16>::max_clusters(cs);
    case 20: return Fps<20>::max_clusters(cs);
    default: return Fps<kMaxPpt>::max_clusters(cs);
  }
}

// The staged route: FPS over clusters of `cs` CTAs (1, 2, 4, 8 or 16), each
// thread keeping kStagedPpt points in registers, kThreads * kStagedPpt * cs
// >= N. Returns the cudaError_t of the launch.
int votenet_fps_staged(const float* xyz, int B, int N, int npoint, int cs, int* out, void* stream) {
  if (!valid_cluster(cs) || static_cast<long long>(kThreads) * kStagedPpt * cs < N) return cudaErrorInvalidValue;
  return Staged::launch(xyz, B, N, npoint, cs, out, nullptr, static_cast<cudaStream_t>(stream));
}

// As votenet_fps_max_clusters, for the staged route's instance.
int votenet_fps_staged_max_clusters(int cs) {
  if (!valid_cluster(cs)) return -static_cast<int>(cudaErrorInvalidValue);
  return Staged::max_clusters(cs);
}

const char* votenet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
