// Batch norm + ReLU on Hopper (sm_90a): four kernels over the channels-last
// (R, C) view of a batch-norm input (R rows: every axis but the last).
//
// The port's own kernels: the JAX package runs flax nn.BatchNorm + nn.relu
// (votenet_tpu/models/pointnet2.py:166-174, votenet_tpu/models/votenet.py:
// 61-68) as XLA fusions and reaches no Pallas kernel. In eager PyTorch the
// same arithmetic took four full passes in eval and some twenty in a
// training step; here the forward is K1 + K2 and the backward K3 + K4:
//
//   K1 bn_stats_kernel       per channel sum(x) and sum(x * x)
//   K2 bn_apply_kernel       y = ((x - mean) * mul) + bias, rounded to the
//                            output type (nearest even), then, when asked,
//                            the ReLU in the output type
//   K3 bn_bwd_reduce_kernel  per channel sum(g) and sum(g * (x - mean)), g
//                            = dy masked by the ReLU
//   K4 bn_bwd_apply_kernel   dx = ((g * mul) + a) + (b * x), or g * mul in
//                            eval, rounded to x's type
//
// mean, mul (rsqrt(var + eps) * weight), bias, a and b are per-channel f32
// vectors that the caller (votenet_tpu_torch/ops/batchnorm.py) computes
// with torch ops from K1's and K3's sums, so no division or rsqrt runs
// here. The ReLU's mask is recomputed from x by K2's arithmetic, so the
// backward needs x alone: g = 0 where the pre-ReLU output y <= 0, dy
// elsewhere (a NaN y passes its gradient: torch's threshold_backward). The
// ReLU is torch's clamp_min on the card: a NaN stays as it is, any other
// value becomes fmaxf(y, 0).
//
// Exactness: every float operation is one IEEE rounding (__fsub_rn,
// __fmul_rn, __fadd_rn, and -fmad=false besides), so K2 and K4 compute the
// floats of the plain stages in ops/batchnorm.py on the same device (each
// torch elementwise op rounds once). K1 and K3 add in an order of their
// own, fixed by the shape and the card's SM count: each thread its rows in
// ascending order, then the row groups of a CTA in order, then the CTAs'
// partial sums in order (no float atomics). Two runs give the same bits;
// torch.sum adds in another order, so against it they agree within a
// tolerance (chip_smoke.py BN_SUM_TOL).
//
// What bounds them (NVIDIA H100 80GB HBM3): bytes. At B = 8, sa1's first
// layer is 1,048,576 rows x 64 channels, 268 MB of f32: K2 reads and writes
// it (0.16 ms at 3.35 TB/s) with 4 operations an element, far below the
// f32 peak. All four kernels are single passes at one element a load.
//
// Design: a CTA of kThreads threads takes a chunk of consecutive rows and a
// tile of channels. A lane holds V consecutive channels: V = 4 (one 16-byte
// f32 or 8-byte bf16 access) where C % 4 == 0 and the pointers are aligned,
// else V = 1. The tile is W lanes (W = min(C / V, kThreads)); the CTA's
// kThreads / W row groups walk the chunk's rows in steps of that count, so
// the per-channel vectors stay in registers and a row group's loads are
// consecutive. K1 and K3 reduce their row groups through shared memory,
// write one partial pair a CTA and channel to a workspace, and the last
// CTA of a channel tile (an integer ticket) adds the partials in CTA order.
// Offsets are 64-bit: a B = 64 eval holds ~1.07e9 elements at sa1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

// v rounded to T (nearest, ties to even), as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v))) << 16);
  }
}

// the 16 bits of a float that is a bf16 value (round_to<bf16>'s output)
__device__ __forceinline__ uint32_t bf16_bits(float v) { return __float_as_uint(v) >> 16; }

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      v[0] = *p;
    } else {
      v[0] = __bfloat162float(*p);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
}

// stores values already rounded to T (round_to<T>)
template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      *p = v[0];
    } else {
      *p = __ushort_as_bfloat16(static_cast<unsigned short>(bf16_bits(v[0])));
    }
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16), bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
  }
}

// The normalised value before the ReLU, rounded to Tout, as a float.
template <typename Tout>
__device__ __forceinline__ float normalized(float x, float mean, float mul, float bias) {
  return round_to<Tout>(__fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias));
}

__device__ __forceinline__ float relu(float y) { return isnan(y) ? y : fmaxf(y, 0.0f); }

// The ReLU's backward: dy where y > 0 or y is NaN, else 0.
__device__ __forceinline__ float masked(float dy, float y, bool relu_on) { return relu_on && y <= 0.0f ? 0.0f : dy; }

// Where a thread works: its lane's first channel c (or -1 when idle), its
// row group, the number of row groups, and its CTA's rows [r0, r1).
struct Slot {
  int c, rg, groups;
  int64_t r0, r1;
};

template <int V>
__device__ __forceinline__ Slot slot(int64_t R, int C, int W, int64_t rows_per_cta) {
  Slot s;
  const int lane = threadIdx.x % W;
  s.rg = threadIdx.x / W;
  s.groups = kThreads / W;
  const int gl = blockIdx.y * W + lane;
  s.c = (s.rg < s.groups && gl < C / V) ? gl * V : -1;
  s.r0 = static_cast<int64_t>(blockIdx.x) * rows_per_cta;
  s.r1 = s.r0 + rows_per_cta < R ? s.r0 + rows_per_cta : R;
  return s;
}

template <int V>
__device__ __forceinline__ void load_channels(const float* __restrict__ v, int c, float (&out)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = v[c + j];
}

// The end of K1 and K3: the CTA's row groups added in order, one partial
// pair a channel to the workspace (ws_s, ws_q: gridDim.x rows of C), and
// the last CTA of this channel tile adds the partials in CTA order into
// out_s, out_q, and sets the tile's ticket back to 0.
template <int V>
__device__ void finish_sums(const Slot& s, int C, int W, const float (&acc_s)[V], const float (&acc_q)[V],
                            float* __restrict__ ws_s, float* __restrict__ ws_q, int* __restrict__ tickets,
                            float* __restrict__ out_s, float* __restrict__ out_q) {
  __shared__ float sh_s[kThreads * 4], sh_q[kThreads * 4];
  __shared__ bool last;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh_s[threadIdx.x * V + j] = acc_s[j];
    sh_q[threadIdx.x * V + j] = acc_q[j];
  }
  __syncthreads();
  if (s.rg == 0 && s.c >= 0) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float ps = 0.0f, pq = 0.0f;
      for (int g = 0; g < s.groups; ++g) {
        ps = __fadd_rn(ps, sh_s[(g * W + lane) * V + j]);
        pq = __fadd_rn(pq, sh_q[(g * W + lane) * V + j]);
      }
      ws_s[static_cast<int64_t>(blockIdx.x) * C + s.c + j] = ps;
      ws_q[static_cast<int64_t>(blockIdx.x) * C + s.c + j] = pq;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[blockIdx.y], 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;

  // the tile's n channels; P parts of the CTAs a channel when n < kThreads
  const int G = gridDim.x;
  const int c_lo = blockIdx.y * W * V;
  const int n = min(C, c_lo + W * V) - c_lo;
  const int P = n >= kThreads ? 1 : kThreads / n;
  for (int base = 0; base < n; base += kThreads) {
    const int ci = base + (P == 1 ? threadIdx.x : threadIdx.x % n);
    const int p = P == 1 ? 0 : threadIdx.x / n;
    float ps = 0.0f, pq = 0.0f;
    if (ci < n && p < P) {
      const int k0 = static_cast<int>(static_cast<int64_t>(G) * p / P);
      const int k1 = static_cast<int>(static_cast<int64_t>(G) * (p + 1) / P);
      for (int k = k0; k < k1; ++k) {
        ps = __fadd_rn(ps, __ldcg(ws_s + static_cast<int64_t>(k) * C + c_lo + ci));
        pq = __fadd_rn(pq, __ldcg(ws_q + static_cast<int64_t>(k) * C + c_lo + ci));
      }
    }
    __syncthreads();  // the shared arrays are reused
    sh_s[threadIdx.x] = ps;
    sh_q[threadIdx.x] = pq;
    __syncthreads();
    if (p == 0 && ci < n) {
      for (int q = 1; q < P; ++q) {
        ps = __fadd_rn(ps, sh_s[q * n + ci]);
        pq = __fadd_rn(pq, sh_q[q * n + ci]);
      }
      out_s[c_lo + ci] = ps;
      out_q[c_lo + ci] = pq;
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;  // every CTA has taken its ticket: ready for the next launch
}

// K1
template <typename Tin, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const Tin* __restrict__ x, int64_t R, int C, int W, int64_t rows_per_cta,
                    float* __restrict__ ws_s, float* __restrict__ ws_q, int* __restrict__ tickets,
                    float* __restrict__ sum, float* __restrict__ sumsq) {
  const Slot s = slot<V>(R, C, W, rows_per_cta);
  float acc_s[V] = {}, acc_q[V] = {};
  if (s.c >= 0) {
    for (int64_t r = s.r0 + s.rg; r < s.r1; r += s.groups) {
      float v[V];
      load<Tin, V>(x + r * C + s.c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc_s[j] = __fadd_rn(acc_s[j], v[j]);
        acc_q[j] = __fadd_rn(acc_q[j], __fmul_rn(v[j], v[j]));
      }
    }
  }
  finish_sums<V>(s, C, W, acc_s, acc_q, ws_s, ws_q, tickets, sum, sumsq);
}

// K2
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, int64_t R, int C, int W, int64_t rows_per_cta,
                    const float* __restrict__ mean, const float* __restrict__ mul, const float* __restrict__ bias,
                    bool relu_on) {
  const Slot s = slot<V>(R, C, W, rows_per_cta);
  if (s.c < 0) return;
  float m[V], k[V], b[V];
  load_channels<V>(mean, s.c, m);
  load_channels<V>(mul, s.c, k);
  load_channels<V>(bias, s.c, b);
  for (int64_t r = s.r0 + s.rg; r < s.r1; r += s.groups) {
    float v[V];
    load<Tin, V>(x + r * C + s.c, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = normalized<Tout>(v[j], m[j], k[j], b[j]);
      v[j] = relu_on ? relu(t) : t;
    }
    store<Tout, V>(y + r * C + s.c, v);
  }
}

// K3
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const Tin* __restrict__ x, const Tout* __restrict__ dy, int64_t R, int C, int W,
                         int64_t rows_per_cta, const float* __restrict__ mean, const float* __restrict__ mul,
                         const float* __restrict__ bias, bool relu_on, float* __restrict__ ws_s,
                         float* __restrict__ ws_q, int* __restrict__ tickets, float* __restrict__ sum_g,
                         float* __restrict__ sum_gx) {
  const Slot s = slot<V>(R, C, W, rows_per_cta);
  float acc_s[V] = {}, acc_q[V] = {};
  if (s.c >= 0) {
    float m[V], k[V], b[V];
    load_channels<V>(mean, s.c, m);
    load_channels<V>(mul, s.c, k);
    load_channels<V>(bias, s.c, b);
    for (int64_t r = s.r0 + s.rg; r < s.r1; r += s.groups) {
      float v[V], d[V];
      load<Tin, V>(x + r * C + s.c, v);
      load<Tout, V>(dy + r * C + s.c, d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float g = masked(d[j], normalized<Tout>(v[j], m[j], k[j], b[j]), relu_on);
        acc_s[j] = __fadd_rn(acc_s[j], g);
        acc_q[j] = __fadd_rn(acc_q[j], __fmul_rn(g, __fsub_rn(v[j], m[j])));
      }
    }
  }
  finish_sums<V>(s, C, W, acc_s, acc_q, ws_s, ws_q, tickets, sum_g, sum_gx);
}

// K4; a and b are null in eval (dx = g * mul)
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_apply_kernel(const Tin* __restrict__ x, const Tout* __restrict__ dy, Tin* __restrict__ dx, int64_t R,
                        int C, int W, int64_t rows_per_cta, const float* __restrict__ mean,
                        const float* __restrict__ mul, const float* __restrict__ bias, const float* __restrict__ a,
                        const float* __restrict__ b, bool relu_on) {
  const Slot s = slot<V>(R, C, W, rows_per_cta);
  if (s.c < 0) return;
  const bool stats = a != nullptr;
  float m[V], k[V], bi[V], ca[V] = {}, cb[V] = {};
  load_channels<V>(mean, s.c, m);
  load_channels<V>(mul, s.c, k);
  load_channels<V>(bias, s.c, bi);
  if (stats) {
    load_channels<V>(a, s.c, ca);
    load_channels<V>(b, s.c, cb);
  }
  for (int64_t r = s.r0 + s.rg; r < s.r1; r += s.groups) {
    float v[V], d[V];
    load<Tin, V>(x + r * C + s.c, v);
    load<Tout, V>(dy + r * C + s.c, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float g = masked(d[j], normalized<Tout>(v[j], m[j], k[j], bi[j]), relu_on);
      const float t = __fmul_rn(g, k[j]);
      v[j] = round_to<Tin>(stats ? __fadd_rn(__fadd_rn(t, ca[j]), __fmul_rn(cb[j], v[j])) : t);
    }
    store<Tin, V>(dx + r * C + s.c, v);
  }
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<Ta>, Tag<Tb>, V) for the runtime types (bf16 flags) and vector width
template <typename F>
cudaError_t dispatch(int a_bf16, int b_bf16, int vec, F&& f) {
  auto with_b = [&](auto ta) -> cudaError_t {
    auto with_v = [&](auto tb) -> cudaError_t {
      return vec ? f(ta, tb, std::integral_constant<int, 4>{}) : f(ta, tb, std::integral_constant<int, 1>{});
    };
    return b_bf16 ? with_v(Tag<bf16>{}) : with_v(Tag<float>{});
  };
  return a_bf16 ? with_b(Tag<bf16>{}) : with_b(Tag<float>{});
}

dim3 grid_of(int ctas, int tiles) { return dim3(static_cast<unsigned>(ctas), static_cast<unsigned>(tiles)); }

}  // namespace

extern "C" {

// Each takes the plan of ops/cuda/batchnorm.py::bn_plan: W lanes a CTA,
// `ctas` CTAs along the rows (rows_per_cta each) and `tiles` along the
// channels; vec selects V = 4. ws_* hold ctas x C floats each, tickets
// `tiles` ints that are 0 on entry and on exit (the reductions' last CTA
// sets its tile's back), so a stream can reuse them without a memset.
// Returns the launch's CUDA error (0).

int votenet_bn_stats(const void* x, int x_bf16, int64_t R, int C, int vec, int W, int ctas, int tiles,
                     int64_t rows_per_cta, float* ws_s, float* ws_q, int* tickets, float* sum, float* sumsq,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(x_bf16, 0, vec, [&](auto ta, auto, auto v) {
    using Tin = typename decltype(ta)::type;
    bn_stats_kernel<Tin, decltype(v)::value><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
        static_cast<const Tin*>(x), R, C, W, rows_per_cta, ws_s, ws_q, tickets, sum, sumsq);
    return cudaGetLastError();
  }));
}

int votenet_bn_apply(const void* x, int x_bf16, void* y, int y_bf16, int64_t R, int C, int vec, int W, int ctas,
                     int tiles, int64_t rows_per_cta, const float* mean, const float* mul, const float* bias,
                     int relu_on, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(x_bf16, y_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    bn_apply_kernel<Tin, Tout, decltype(v)::value><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
        static_cast<const Tin*>(x), static_cast<Tout*>(y), R, C, W, rows_per_cta, mean, mul, bias, relu_on != 0);
    return cudaGetLastError();
  }));
}

int votenet_bn_bwd_reduce(const void* x, int x_bf16, const void* dy, int dy_bf16, int64_t R, int C, int vec, int W,
                          int ctas, int tiles, int64_t rows_per_cta, const float* mean, const float* mul,
                          const float* bias, int relu_on, float* ws_s, float* ws_q, int* tickets, float* sum_g,
                          float* sum_gx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(x_bf16, dy_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    bn_bwd_reduce_kernel<Tin, Tout, decltype(v)::value><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
        static_cast<const Tin*>(x), static_cast<const Tout*>(dy), R, C, W, rows_per_cta, mean, mul, bias,
        relu_on != 0, ws_s, ws_q, tickets, sum_g, sum_gx);
    return cudaGetLastError();
  }));
}

int votenet_bn_bwd_apply(const void* x, int x_bf16, const void* dy, int dy_bf16, void* dx, int64_t R, int C, int vec,
                         int W, int ctas, int tiles, int64_t rows_per_cta, const float* mean, const float* mul,
                         const float* bias, const float* a, const float* b, int relu_on, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(x_bf16, dy_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    bn_bwd_apply_kernel<Tin, Tout, decltype(v)::value><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
        static_cast<const Tin*>(x), static_cast<const Tout*>(dy), static_cast<Tin*>(dx), R, C, W, rows_per_cta,
        mean, mul, bias, a, b, relu_on != 0);
    return cudaGetLastError();
  }));
}

}  // extern "C"
