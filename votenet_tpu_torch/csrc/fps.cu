// Farthest-point sampling on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of votenet_tpu/ops/pallas/fps.py:
// `_fps_kernel` (:47, batches on the sublanes, the JAX route at B > 2) and
// `_fps_rowwise_kernel` (:79, one batch row per program, B <= 2). One kernel
// serves both routes: one CTA per batch row.
//
// What it computes (the semantics of votenet_tpu/ops/sampling.py
// farthest_point_sample_xla): slot 0 is index 0; every later slot picks the
// argmax of the running minimum of squared distances to the points picked so
// far (initialised to 1e38), lowest index on ties.
//
// What bounds it on the H100: the npoint steps are strictly sequential, and
// each step is a pass over all N points plus a block-wide argmax with two
// barriers. At B = 1 one SM of 132 works; the rest idle. The per-step cost is
// latency (barriers, shuffles, L2 round trips for the coordinates), not
// bandwidth or FLOPs.
//
// What the design does about it: the running minimum lives in dynamic shared
// memory (4*N bytes: 80 KB at N = 20480, above the 48 KB default, hence
// cudaFuncSetAttribute); when it does not fit, the caller passes a global
// scratch buffer instead. The coordinates stay in device memory and are read
// through L2 (245 KB at N = 20480, resident after the first step). The argmax
// is a warp-shuffle reduction over (value, index) pairs and one more across
// the warps' winners. Splitting a row over several CTAs or a cluster is left
// for a later change.
//
// Bit-exactness hazards:
// - FMA contraction. d2 is ((dx*dx + dy*dy) + dz*dz) in round-to-nearest f32
//   with no fused multiply-add, written with __fmul_rn/__fadd_rn (the build
//   also passes -fmad=false). A contracted d2 rounds differently and changes
//   which point wins a step.
// - Ties. Each thread scans its points in ascending index order and replaces
//   its best only on a strictly greater value; the reductions prefer the
//   lower index on equal values. Threads with no point carry (-1, INT_MAX),
//   which never beats a real point (every real running minimum is >= 0).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) beats (bv, bi): larger value, or the same value at a lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// grid = B, block = a multiple of 32 up to 1024 threads.
// xyz (B, N, 3) f32, out (B, npoint) i32, scratch (B, N) f32 or null.
__global__ void fps_kernel(const float* __restrict__ xyz, int N, int npoint,
                           int* __restrict__ out, float* __restrict__ scratch) {
  extern __shared__ float smem_mind[];
  __shared__ float warp_val[32];
  __shared__ int warp_idx[32];
  __shared__ int picked;

  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  float* mind = scratch ? scratch + static_cast<size_t>(b) * N : smem_mind;
  int* o = out + static_cast<size_t>(b) * npoint;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  // each thread owns the points i = tid (mod nthreads) for the whole run,
  // so its slice of `mind` needs no barrier
  for (int i = tid; i < N; i += nthreads) mind[i] = 1e38f;
  if (tid == 0) o[0] = 0;

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float cx = p[3 * last], cy = p[3 * last + 1], cz = p[3 * last + 2];
    float bv = -1.0f;
    int bi = INT_MAX;
    for (int i = tid; i < N; i += nthreads) {
      const float d = sqdist(p[3 * i], p[3 * i + 1], p[3 * i + 2], cx, cy, cz);
      const float m = fminf(mind[i], d);
      mind[i] = m;
      if (m > bv) {
        bv = m;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_val[warp] = bv;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? warp_val[lane] : -1.0f;
      bi = lane < nwarps ? warp_idx[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        picked = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    last = picked;
  }
}

}  // namespace

extern "C" {

// Launches FPS on `stream`. `scratch` is null when the running minimum fits
// in shared memory (N * 4 bytes, see votenet_fps_smem_limit), else a (B, N)
// f32 device buffer. Returns the cudaError_t of the launch.
int votenet_fps(const float* xyz, int B, int N, int npoint, int* out,
                float* scratch, void* stream) {
  int threads = ((N + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = scratch ? 0 : static_cast<size_t>(N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, N, npoint, out, scratch);
  return cudaGetLastError();
}

// Bytes of dynamic shared memory the kernel may ask for: 200 KB of the
// 227 KB a Hopper block can use, leaving room for its static arrays.
int votenet_fps_smem_limit() { return 200 * 1024; }

const char* votenet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
