// Batch norm + ReLU on Hopper (sm_90a), with the layer around it: four
// kernels over the channels-last (R, C) view of a batch-norm site, and a
// pooled variant of the second.
//
// The port's own kernels: the JAX package runs flax nn.Dense or
// CenteredDense, nn.BatchNorm, nn.relu and jnp.max over the ball's slots
// (votenet_tpu/models/pointnet2.py:95-103, 166-174, 540-541; votenet.py:
// 61-68) as XLA fusions and reaches no Pallas kernel. Here a site's forward
// is K1 + K2 and its backward K3 + K4:
//
//   K1 bn_stats_kernel       per channel sum(x) and sum(x * x)
//   K2 bn_apply_kernel       y = ((x - mean) * mul) + bias, rounded to the
//                            output type (nearest even), then, when asked,
//                            the ReLU in the output type
//   K2 bn_apply_pool_kernel  the same, then the max over each unit's S rows
//                            (the ball's slots) and the count of the slots
//                            equal to it; the full y is never written
//   K3 bn_bwd_reduce_kernel  per channel sum(g) and sum(g * (x - mean)), g
//                            = dy masked by the ReLU
//   K4 bn_bwd_apply_kernel   dx = ((g * mul) + a) + (b * x), or g * mul in
//                            eval, rounded to x's type
//
// The prologue. Every kernel reads the dense layer's output h, not x, and
// recomputes x in registers: x = (h - corr[unit]) + dbias, each operation
// in f32 and rounded once to h's type (the eager ops' roundings; the
// centred first layer's association, votenet_tpu/models/pointnet2.py:103).
// corr (R / S rows, the centre's product with the coordinate rows of the
// kernel) and dbias (the dense bias, C) are optional. So x is never
// written, and the backward needs h alone.
//
// The pool. With S > 1 the rows come in units of S (the S slots of one
// ball: (B, M, S, C) viewed as (R, C)). K2's pool variant writes the max of
// the unit's ReLU outputs (torch.amax's: a NaN wins) and the count of
// slots equal to it. K3 and K4 at a pooled site read the pooled cotangent
// gp, the max and the count (each R / S rows) in place of a full dy, and
// form each slot's cotangent as torch.amax's backward does,
// (gp / count) * (y == max), each rounded to the output type: the
// cotangent is split among the tied slots (the ball query pads a ball with
// its first hit, and the ReLU makes zeros, so ties are common).
//
// mean, mul (rsqrt(var + eps) * weight), bias, a and b are per-channel f32
// vectors that the caller (votenet_tpu_torch/ops/batchnorm.py) computes
// with torch ops from K1's and K3's sums, so no rsqrt runs here. The
// ReLU's mask is recomputed from x by K2's arithmetic: g = 0 where the
// pre-ReLU output y <= 0, dy elsewhere (a NaN y passes its gradient:
// torch's threshold_backward). The ReLU is torch's clamp_min on the card: a
// NaN stays as it is, any other value becomes fmaxf(y, 0).
//
// Exactness: every float operation is one IEEE rounding (__fsub_rn,
// __fmul_rn, __fadd_rn, __fdiv_rn, and -fmad=false besides), so K2 and K4
// compute the floats of the plain stages in ops/batchnorm.py on the same
// device (each torch elementwise op rounds once). K1 and K3 add in f64 (the
// terms x, x * x, g and g * f32(x - mean) are exact in f64) in an order of
// their own, fixed by the shape and the card's SM count (the launch plan,
// ops/cuda/batchnorm.py::bn_plan): each thread its rows in ascending order;
// the row groups of a CTA in order; then a tree of two levels over the
// CTAs' partial sums, blocks of `fan_in` consecutive CTAs added in CTA
// order, then the blocks' sums in block order (no float atomics); the sum
// is K1's output in f64 (the caller rounds it to f32, after the all-reduce
// of a data-parallel group, so that a split batch gives the whole batch's
// statistics) and K3's rounded once to f32. tests/test_torch_bn_layer.py
// transcribes this
// order into numpy; two runs give the same bits. In f64 the order barely
// shows: the f32 sums are the correctly rounded ones but where the exact
// sum lies within ~1e-10 of a rounding boundary, so the batch statistics,
// and with them which outputs lie on either side of the ReLU, follow an
// f64 reference and not the summation order (an f32 tree moved a mean by
// an ulp, and one ReLU decision of 33.5M with it).
//
// What bounds them (NVIDIA H100 80GB HBM3): bytes. At B = 8, sa1's last
// layer is 1,048,576 rows x 128 channels, 537 MB of f32: K1 reads it once
// (0.16 ms at 3.35 TB/s) with 3 operations an element, far below the f32
// peak. What held K1 and K3 back was the end: the last CTA walked up to 528
// partials a channel one after another (8-34 us a launch, paid 23 times a
// step), and at the small sites (<= 8192 rows) a thread's 32 rows were 32
// loads in sequence. Here a thread keeps U rows' loads in flight before it
// adds them, and the end is the two-level tree: ~sqrt(G) partials a channel
// at each level, loaded eight at a time.
//
// Design: a CTA of kThreads threads takes a range of consecutive units and
// a tile of channels. A lane holds V consecutive channels: V = 4 (one
// 16-byte f32 or 8-byte bf16 access) where C % 4 == 0 and the pointers are
// aligned, else V = 1. The tile is W lanes (W = min(C / V, kThreads)); the
// CTA's kThreads / W row groups take its units in turn (unit u0 + rg, then
// + groups, ...), each unit's S rows in order, so the per-channel vectors
// stay in registers. Offsets are 64-bit: a B = 64 eval holds ~1.07e9
// elements at sa1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// CTAs an SM of each launch plan's kind (ops/cuda/batchnorm.py
// BN_CTAS_PER_SM, held equal to these by tests/test_torch_bn_layer.py): the
// register cap each kernel is compiled to, so that the plan's CTAs are
// resident at once
constexpr int kCtasReduce = 4;        // "reduce": K1
constexpr int kCtasReduceDy = 2;      // "reduce_dy": K3 over a full dy
constexpr int kCtasReducePooled = 3;  // "reduce_pooled": K3 at a pooled site
constexpr int kCtasApply = 4;         // "apply": K2 and K4, each in both variants
// Rows a thread loads before it uses them: K1 and K2 read one
// (R, C) tensor, K3 and K4 two (x and dy; at a pooled site x and the
// unit's vectors, mostly L1 hits)
constexpr int kRows = 4;
constexpr int kPairRows = 2;

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

template <int V>
__device__ __forceinline__ void load_counts(const int* __restrict__ p, int (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
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

// The layer around the site: x = (h - corr[unit]) + dbias, each operation
// rounded to T; corr (units x C) and dbias (C) may be null.
template <typename T>
struct Prologue {
  const T* __restrict__ corr;
  const T* __restrict__ dbias;
};

// Where a thread works: its lane's first channel c (or -1 when idle), its
// row group, the number of row groups, its CTA's units [u0, u1) of S rows.
struct Slot {
  int c, rg, groups;
  int64_t u0, u1;
};

template <int V>
__device__ __forceinline__ Slot slot(int64_t units, int C, int W, int64_t units_per_cta) {
  Slot s;
  const int lane = threadIdx.x % W;
  s.rg = threadIdx.x / W;
  s.groups = kThreads / W;
  const int gl = blockIdx.y * W + lane;
  s.c = (s.rg < s.groups && gl < C / V) ? gl * V : -1;
  s.u0 = static_cast<int64_t>(blockIdx.x) * units_per_cta;
  s.u1 = s.u0 + units_per_cta < units ? s.u0 + units_per_cta : units;
  return s;
}

// A row group's rows in order: its units u0 + rg, + groups, ... below u1,
// each unit's S rows in turn (fewer than 2^31 rows: the wrapper checks).
struct Rows {
  int u, u1, s, S, step;
  __device__ __forceinline__ Rows(const Slot& sl, int S_)
      : u(static_cast<int>(sl.u0) + sl.rg), u1(static_cast<int>(sl.u1)), s(0), S(S_), step(sl.groups) {}
  __device__ __forceinline__ bool next(int& row, int& unit) {
    if (u >= u1) return false;
    row = u * S + s;
    unit = u;
    if (++s == S) {
      s = 0;
      u += step;
    }
    return true;
  }
};

// f(integral_constant<int, 0>), ..., f(integral_constant<int, N - 1>) (f
// reads the index as decltype(arg)::value): a loop over the rows a thread
// holds in flight, unrolled by construction, so every row array stays in
// registers (nvcc left K4's pooled bf16 loop rolled despite #pragma unroll
// and moved the arrays to local memory)
template <int N, typename F>
__device__ __forceinline__ void for_rows(F&& f) {
  if constexpr (N > 0) {
    for_rows<N - 1>(f);
    f(std::integral_constant<int, N - 1>{});
  }
}

template <int V>
__device__ __forceinline__ void load_channels(const float* __restrict__ v, int c, float (&out)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = v[c + j];
}

template <typename T, int V>
__device__ __forceinline__ void load_dbias(const Prologue<T>& p, int c, float (&db)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) db[j] = 0.0f;
  if (p.dbias != nullptr) load<T, V>(p.dbias + c, db);
}

// x = (h - corr[unit]) + dbias in place, each step rounded to T
template <typename T, int V>
__device__ __forceinline__ void prologue(const Prologue<T>& p, int64_t unit, int C, int c, const float (&db)[V],
                                         float (&v)[V]) {
  if (p.corr != nullptr) {
    float k[V];
    load<T, V>(p.corr + unit * C + c, k);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = round_to<T>(__fsub_rn(v[j], k[j]));
  }
  if (p.dbias != nullptr) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = round_to<T>(__fadd_rn(v[j], db[j]));
  }
}

// The per-unit factor of a pooled site's cotangent, as torch.amax's
// backward forms it: q = gp / count, rounded to T (count as T); a slot's
// cotangent is then q * (y == max), rounded to T.
template <typename T>
__device__ __forceinline__ float pooled_share(float gp, int count) {
  return round_to<T>(__fdiv_rn(gp, round_to<T>(static_cast<float>(count))));
}

// n channels from c_lo of rows [k0, k1) of src (C doubles a row), added in
// row order from 0, into dst[c_lo + ...]; eight rows' loads at a time (a
// missing row loads 0, which leaves a sum that is not -0 unchanged: the
// sums start at +0 and round to nearest, so none is -0)
template <typename Tdst>
__device__ void add_rows(const double* __restrict__ src_s, const double* __restrict__ src_q, int k0, int k1, int C,
                         int c_lo, int n, Tdst* __restrict__ dst_s, Tdst* __restrict__ dst_q) {
  for (int ci = threadIdx.x; ci < n; ci += kThreads) {
    double ps = 0.0, pq = 0.0;
    for (int k = k0; k < k1; k += 8) {
      double a[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t off = static_cast<int64_t>(k + j) * C + c_lo + ci;
        a[j] = k + j < k1 ? __ldcg(src_s + off) : 0.0;
        b[j] = k + j < k1 ? __ldcg(src_q + off) : 0.0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ps = __dadd_rn(ps, a[j]);
        pq = __dadd_rn(pq, b[j]);
      }
    }
    if constexpr (std::is_same<Tdst, float>::value) {  // the result: rounded once to f32
      dst_s[c_lo + ci] = __double2float_rn(ps);
      dst_q[c_lo + ci] = __double2float_rn(pq);
    } else {
      dst_s[c_lo + ci] = ps;
      dst_q[c_lo + ci] = pq;
    }
  }
}

// The end of K1 and K3. The CTA's row groups added in order give one
// partial pair a channel (workspace row blockIdx.x). The G CTAs form
// L = ceil(G / fan_in) blocks of fan_in consecutive CTAs; the last CTA of a
// block to finish (an integer ticket) adds the block's partials in CTA order
// into workspace row G + block (or into out when L == 1), and the last
// block to finish adds those L rows in block order into out. Every sum is
// f64 (each add one rounding); out is f64 (K1) or rounded once to f32 (K3). Tickets:
// L + 1 ints a channel tile, each set back to 0 by the CTA that took its
// last count.
template <int V, typename Tsum>
__device__ void finish_sums(const Slot& s, int C, int W, int fan_in, const double (&acc_s)[V],
                            const double (&acc_q)[V], double* __restrict__ ws_s, double* __restrict__ ws_q,
                            int* __restrict__ tickets, Tsum* __restrict__ out_s, Tsum* __restrict__ out_q) {
  __shared__ double sh_s[kThreads * 4], sh_q[kThreads * 4];
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
      double ps = 0.0, pq = 0.0;
      for (int g = 0; g < s.groups; ++g) {
        ps = __dadd_rn(ps, sh_s[(g * W + lane) * V + j]);
        pq = __dadd_rn(pq, sh_q[(g * W + lane) * V + j]);
      }
      ws_s[static_cast<int64_t>(blockIdx.x) * C + s.c + j] = ps;
      ws_q[static_cast<int64_t>(blockIdx.x) * C + s.c + j] = pq;
    }
  }
  const int G = gridDim.x;
  const int L = (G + fan_in - 1) / fan_in;
  const int blk = blockIdx.x / fan_in;
  const int k0 = blk * fan_in, k1 = min(G, k0 + fan_in);
  int* tk = tickets + static_cast<int64_t>(blockIdx.y) * (L + 1);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tk[blk], 1) == k1 - k0 - 1;
  __syncthreads();
  if (!last) return;

  const int c_lo = blockIdx.y * W * V;
  const int n = min(C, c_lo + W * V) - c_lo;
  if (L == 1) {
    add_rows(ws_s, ws_q, k0, k1, C, c_lo, n, out_s, out_q);
    if (threadIdx.x == 0) tk[blk] = 0;
    return;
  }
  add_rows(ws_s, ws_q, k0, k1, C, c_lo, n, ws_s + static_cast<int64_t>(G + blk) * C,
           ws_q + static_cast<int64_t>(G + blk) * C);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    tk[blk] = 0;  // every CTA of the block has taken its ticket
    last = atomicAdd(&tk[L], 1) == L - 1;
  }
  __syncthreads();
  if (!last) return;
  add_rows(ws_s + static_cast<int64_t>(G) * C, ws_q + static_cast<int64_t>(G) * C, 0, L, C, c_lo, n, out_s, out_q);
  if (threadIdx.x == 0) tk[L] = 0;
}

// The launch shape every kernel takes (ops/cuda/batchnorm.py::bn_plan).
struct Plan {
  int64_t units;  // R / S
  int S, C, W;
  int64_t units_per_cta;
};

// K1
template <typename Tin, int V>
__global__ void __launch_bounds__(kThreads, kCtasReduce)
    bn_stats_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Plan pl, int fan_in, double* __restrict__ ws_s,
                    double* __restrict__ ws_q, int* __restrict__ tickets, double* __restrict__ sum,
                    double* __restrict__ sumsq) {
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  double acc_s[V] = {}, acc_q[V] = {};
  if (s.c >= 0) {
    float db[V];
    load_dbias<Tin, V>(pro, s.c, db);
    Rows it(s, pl.S);
    while (true) {
      int row[kRows], unit[kRows];
      bool ok[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) ok[k] = it.next(row[k], unit[k]);
      if (!ok[0]) break;
      float v[kRows][V];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (ok[k]) load<Tin, V>(x + static_cast<int64_t>(row[k]) * pl.C + s.c, v[k]);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!ok[k]) continue;
        prologue<Tin, V>(pro, unit[k], pl.C, s.c, db, v[k]);
#pragma unroll
        for (int j = 0; j < V; ++j) {  // x and x * x exact in f64
          const double xv = v[k][j];
          acc_s[j] = __dadd_rn(acc_s[j], xv);
          acc_q[j] = __dadd_rn(acc_q[j], __dmul_rn(xv, xv));
        }
      }
    }
  }
  finish_sums<V, double>(s, pl.C, pl.W, fan_in, acc_s, acc_q, ws_s, ws_q, tickets, sum, sumsq);
}

// K2
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads, kCtasApply)
    bn_apply_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Plan pl, Tout* __restrict__ y,
                    const float* __restrict__ mean, const float* __restrict__ mul, const float* __restrict__ bias,
                    bool relu_on) {
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  if (s.c < 0) return;
  float m[V], k[V], b[V], db[V];
  load_channels<V>(mean, s.c, m);
  load_channels<V>(mul, s.c, k);
  load_channels<V>(bias, s.c, b);
  load_dbias<Tin, V>(pro, s.c, db);
  Rows it(s, pl.S);
  while (true) {
    int row[kRows], unit[kRows];
    bool ok[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ok[r] = it.next(row[r], unit[r]);
    if (!ok[0]) break;
    float v[kRows][V];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (ok[r]) load<Tin, V>(x + static_cast<int64_t>(row[r]) * pl.C + s.c, v[r]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!ok[r]) continue;
      prologue<Tin, V>(pro, unit[r], pl.C, s.c, db, v[r]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = normalized<Tout>(v[r][j], m[j], k[j], b[j]);
        v[r][j] = relu_on ? relu(t) : t;
      }
      store<Tout, V>(y + static_cast<int64_t>(row[r]) * pl.C + s.c, v[r]);
    }
  }
}

// K2's pool variant: per unit (S rows) the max of y over the rows, a NaN
// winning as in torch.amax, and the count of rows equal to it, each unit's
// rows taken in order by one row group.
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads, kCtasApply)
    bn_apply_pool_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Plan pl, Tout* __restrict__ ymax,
                         int* __restrict__ count, const float* __restrict__ mean, const float* __restrict__ mul,
                         const float* __restrict__ bias, bool relu_on) {
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  if (s.c < 0) return;
  float m[V], k[V], b[V], db[V];
  load_channels<V>(mean, s.c, m);
  load_channels<V>(mul, s.c, k);
  load_channels<V>(bias, s.c, b);
  load_dbias<Tin, V>(pro, s.c, db);
  for (int64_t u = s.u0 + s.rg; u < s.u1; u += s.groups) {
    float mx[V];
    int cnt[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mx[j] = __int_as_float(0xff800000);  // -inf
      cnt[j] = 0;
    }
    for (int r0 = 0; r0 < pl.S; r0 += kRows) {
      float v[kRows][V];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < pl.S) load<Tin, V>(x + (u * pl.S + r0 + r) * pl.C + s.c, v[r]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r >= pl.S) continue;
        prologue<Tin, V>(pro, u, pl.C, s.c, db, v[r]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = normalized<Tout>(v[r][j], m[j], k[j], b[j]);
          const float yv = relu_on ? relu(t) : t;
          if (isnan(mx[j])) {
          } else if (isnan(yv)) {
            mx[j] = yv;
            cnt[j] = 0;  // NaN == NaN is false: no slot equals a NaN max
          } else if (yv > mx[j]) {
            mx[j] = yv;
            cnt[j] = 1;
          } else if (yv == mx[j]) {
            ++cnt[j];
          }
        }
      }
    }
    store<Tout, V>(ymax + u * pl.C + s.c, mx);
    if constexpr (V == 1) {
      count[u * pl.C + s.c] = cnt[0];
    } else {
      *reinterpret_cast<int4*>(count + u * pl.C + s.c) = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
    }
  }
}

// The cotangent of y at the site, dy: a full (R, C) one, or at a pooled
// site (ymax non-null) gp, the max and the count of each unit.
template <typename Tout>
struct Cotangent {
  const Tout* __restrict__ dy;
  const Tout* __restrict__ ymax;
  const int* __restrict__ count;
};

// A pooled site's per-unit values for a lane's channels: the share q and
// the max of the unit a row group is in, reloaded only when the unit
// changes (a row group takes its units' rows in turn, so once a unit)
template <typename Tout, int V>
struct PooledUnit {
  int unit = -1;
  float q[V], mx[V];
  __device__ __forceinline__ void at(const Cotangent<Tout>& ct, int u, int C, int c) {
    if (u == unit) return;
    unit = u;
    float gp[V];
    int cnt[V];
    const int64_t off = static_cast<int64_t>(u) * C + c;
    load<Tout, V>(ct.dy + off, gp);
    load<Tout, V>(ct.ymax + off, mx);
    load_counts<V>(ct.count + off, cnt);
#pragma unroll
    for (int j = 0; j < V; ++j) q[j] = pooled_share<Tout>(gp[j], cnt[j]);
  }
};

// g, the cotangent through the ReLU, for one row of a lane's channels: x
// already through the prologue; d the row's dy, or at a pooled site each
// slot's share of its unit's (pu: the row's unit)
template <typename Tout, bool POOLED, int V>
__device__ __forceinline__ void cotangent(const PooledUnit<Tout, V>& pu, const float (&d)[V], const float (&x)[V],
                                          const float (&m)[V], const float (&k)[V], const float (&b)[V],
                                          bool relu_on, float (&g)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float t = normalized<Tout>(x[j], m[j], k[j], b[j]);
    float dj;
    if constexpr (POOLED) {
      dj = round_to<Tout>(__fmul_rn(pu.q[j], (relu_on ? relu(t) : t) == pu.mx[j] ? 1.0f : 0.0f));
    } else {
      dj = d[j];
    }
    g[j] = masked(dj, t, relu_on);
  }
}

// K3. Over a full dy the plan runs kCtasReduceDy CTAs an SM, so a thread
// has the registers for kDyRows rows of x and dy in flight; at a pooled
// site (x alone a row) kCtasReducePooled CTAs of kPairRows.
constexpr int kDyRows = 4;

template <typename Tin, typename Tout, int V, bool POOLED>
__global__ void __launch_bounds__(kThreads, POOLED ? kCtasReducePooled : kCtasReduceDy)
    bn_bwd_reduce_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Cotangent<Tout> ct, Plan pl, int fan_in,
                         const float* __restrict__ mean, const float* __restrict__ mul,
                         const float* __restrict__ bias, bool relu_on, double* __restrict__ ws_s,
                         double* __restrict__ ws_q, int* __restrict__ tickets, float* __restrict__ sum_g,
                         float* __restrict__ sum_gx) {
  constexpr int kU = POOLED ? kPairRows : kDyRows;
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  double acc_s[V] = {}, acc_q[V] = {};
  if (s.c >= 0) {
    float m[V], k[V], b[V], db[V];
    load_channels<V>(mean, s.c, m);
    load_channels<V>(mul, s.c, k);
    load_channels<V>(bias, s.c, b);
    load_dbias<Tin, V>(pro, s.c, db);
    PooledUnit<Tout, V> pu;
    Rows it(s, pl.S);
    while (true) {
      int row[kU], unit[kU];
      bool ok[kU];
      for_rows<kU>([&](auto r_) {
        constexpr int r = decltype(r_)::value;
        ok[r] = it.next(row[r], unit[r]);
      });
      if (!ok[0]) break;
      float v[kU][V], d[kU][V];
      for_rows<kU>([&](auto r_) {
        constexpr int r = decltype(r_)::value;
        if (!ok[r]) return;
        load<Tin, V>(x + static_cast<int64_t>(row[r]) * pl.C + s.c, v[r]);
        if constexpr (!POOLED) load<Tout, V>(ct.dy + static_cast<int64_t>(row[r]) * pl.C + s.c, d[r]);
      });
      for_rows<kU>([&](auto r_) {
        constexpr int r = decltype(r_)::value;
        if (!ok[r]) return;
        prologue<Tin, V>(pro, unit[r], pl.C, s.c, db, v[r]);
        if constexpr (POOLED) pu.at(ct, unit[r], pl.C, s.c);
        float g[V];
        cotangent<Tout, POOLED, V>(pu, d[r], v[r], m, k, b, relu_on, g);
#pragma unroll
        for (int j = 0; j < V; ++j) {  // g and g * f32(x - mean) exact in f64
          const double gv = g[j];
          acc_s[j] = __dadd_rn(acc_s[j], gv);
          acc_q[j] = __dadd_rn(acc_q[j], __dmul_rn(gv, static_cast<double>(__fsub_rn(v[r][j], m[j]))));
        }
      });
    }
  }
  finish_sums<V, float>(s, pl.C, pl.W, fan_in, acc_s, acc_q, ws_s, ws_q, tickets, sum_g, sum_gx);
}

// K4; a and b are null in eval (dx = g * mul)
template <typename Tin, typename Tout, int V, bool POOLED>
__global__ void __launch_bounds__(kThreads, kCtasApply)
    bn_bwd_apply_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Cotangent<Tout> ct, Plan pl,
                        Tin* __restrict__ dx, const float* __restrict__ mean, const float* __restrict__ mul,
                        const float* __restrict__ bias, const float* __restrict__ a, const float* __restrict__ b,
                        bool relu_on) {
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  if (s.c < 0) return;
  const bool stats = a != nullptr;
  float m[V], k[V], bi[V], db[V], ca[V] = {}, cb[V] = {};
  load_channels<V>(mean, s.c, m);
  load_channels<V>(mul, s.c, k);
  load_channels<V>(bias, s.c, bi);
  load_dbias<Tin, V>(pro, s.c, db);
  if (stats) {
    load_channels<V>(a, s.c, ca);
    load_channels<V>(b, s.c, cb);
  }
  PooledUnit<Tout, V> pu;
  Rows it(s, pl.S);
  while (true) {
    int row[kPairRows], unit[kPairRows];
    bool ok[kPairRows];
    for_rows<kPairRows>([&](auto r_) {
      constexpr int r = decltype(r_)::value;
      ok[r] = it.next(row[r], unit[r]);
    });
    if (!ok[0]) break;
    float v[kPairRows][V], d[kPairRows][V];
    for_rows<kPairRows>([&](auto r_) {
      constexpr int r = decltype(r_)::value;
      if (!ok[r]) return;
      load<Tin, V>(x + static_cast<int64_t>(row[r]) * pl.C + s.c, v[r]);
      if constexpr (!POOLED) load<Tout, V>(ct.dy + static_cast<int64_t>(row[r]) * pl.C + s.c, d[r]);
    });
    for_rows<kPairRows>([&](auto r_) {
      constexpr int r = decltype(r_)::value;
      if (!ok[r]) return;
      prologue<Tin, V>(pro, unit[r], pl.C, s.c, db, v[r]);
      if constexpr (POOLED) pu.at(ct, unit[r], pl.C, s.c);
      float g[V];
      cotangent<Tout, POOLED, V>(pu, d[r], v[r], m, k, bi, relu_on, g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = __fmul_rn(g[j], k[j]);
        v[r][j] = round_to<Tin>(stats ? __fadd_rn(__fadd_rn(t, ca[j]), __fmul_rn(cb[j], v[r][j])) : t);
      }
      store<Tin, V>(dx + static_cast<int64_t>(row[r]) * pl.C + s.c, v[r]);
    });
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

template <typename T>
Prologue<T> prologue_of(const void* corr, const void* dbias) {
  return Prologue<T>{static_cast<const T*>(corr), static_cast<const T*>(dbias)};
}

}  // namespace

extern "C" {

// Each takes the plan of ops/cuda/batchnorm.py::bn_plan: W lanes a CTA,
// `ctas` CTAs along the units (units_per_cta each, a unit S rows) and
// `tiles` along the channels; vec selects V = 4. The prologue's corr
// (R / S x C) and dbias (C) are in x's type, either may be null; fewer
// than 2^31 rows. The reductions' ws_* hold (ctas + ceil(ctas / fan_in)) x
// C doubles each, and
// tickets (ceil(ctas / fan_in) + 1) x tiles ints that are 0 on entry and on
// exit (each is set back by the CTA that took its last count), so a stream
// can reuse them without a memset. Returns the launch's CUDA error (0).

int votenet_bn_stats(const void* x, int x_bf16, const void* corr, const void* dbias, int S, int64_t R, int C, int vec,
                     int W, int ctas, int tiles, int64_t units_per_cta, int fan_in, double* ws_s, double* ws_q,
                     int* tickets, double* sum, double* sumsq, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{R / S, S, C, W, units_per_cta};
  return static_cast<int>(dispatch(x_bf16, 0, vec, [&](auto ta, auto, auto v) {
    using Tin = typename decltype(ta)::type;
    bn_stats_kernel<Tin, decltype(v)::value><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
        static_cast<const Tin*>(x), prologue_of<Tin>(corr, dbias), pl, fan_in, ws_s, ws_q, tickets, sum, sumsq);
    return cudaGetLastError();
  }));
}

// y is (R, C), or with count non-null the pool variant's (R / S, C) maxima
// beside their int32 counts
int votenet_bn_apply(const void* x, int x_bf16, const void* corr, const void* dbias, int S, void* y, int y_bf16,
                     int* count, int64_t R, int C, int vec, int W, int ctas, int tiles, int64_t units_per_cta,
                     const float* mean, const float* mul, const float* bias, int relu_on, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{R / S, S, C, W, units_per_cta};
  return static_cast<int>(dispatch(x_bf16, y_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    constexpr int V = decltype(v)::value;
    const Prologue<Tin> pro = prologue_of<Tin>(corr, dbias);
    if (count != nullptr) {
      bn_apply_pool_kernel<Tin, Tout, V><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
          static_cast<const Tin*>(x), pro, pl, static_cast<Tout*>(y), count, mean, mul, bias, relu_on != 0);
    } else {
      bn_apply_kernel<Tin, Tout, V><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
          static_cast<const Tin*>(x), pro, pl, static_cast<Tout*>(y), mean, mul, bias, relu_on != 0);
    }
    return cudaGetLastError();
  }));
}

// dy is (R, C), or with ymax non-null the pooled cotangent (R / S, C) beside
// the pool's maxima and counts
int votenet_bn_bwd_reduce(const void* x, int x_bf16, const void* corr, const void* dbias, int S, const void* dy,
                          int dy_bf16, const void* ymax, const int* count, int64_t R, int C, int vec, int W, int ctas,
                          int tiles, int64_t units_per_cta, int fan_in, const float* mean, const float* mul,
                          const float* bias, int relu_on, double* ws_s, double* ws_q, int* tickets, float* sum_g,
                          float* sum_gx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{R / S, S, C, W, units_per_cta};
  return static_cast<int>(dispatch(x_bf16, dy_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    constexpr int V = decltype(v)::value;
    const Prologue<Tin> pro = prologue_of<Tin>(corr, dbias);
    const Cotangent<Tout> ct{static_cast<const Tout*>(dy), static_cast<const Tout*>(ymax), count};
    if (ymax != nullptr) {
      bn_bwd_reduce_kernel<Tin, Tout, V, true><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
          static_cast<const Tin*>(x), pro, ct, pl, fan_in, mean, mul, bias, relu_on != 0, ws_s, ws_q, tickets, sum_g,
          sum_gx);
    } else {
      bn_bwd_reduce_kernel<Tin, Tout, V, false><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
          static_cast<const Tin*>(x), pro, ct, pl, fan_in, mean, mul, bias, relu_on != 0, ws_s, ws_q, tickets, sum_g,
          sum_gx);
    }
    return cudaGetLastError();
  }));
}

int votenet_bn_bwd_apply(const void* x, int x_bf16, const void* corr, const void* dbias, int S, const void* dy,
                         int dy_bf16, const void* ymax, const int* count, void* dx, int64_t R, int C, int vec, int W,
                         int ctas, int tiles, int64_t units_per_cta, const float* mean, const float* mul,
                         const float* bias, const float* a, const float* b, int relu_on, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{R / S, S, C, W, units_per_cta};
  return static_cast<int>(dispatch(x_bf16, dy_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    constexpr int V = decltype(v)::value;
    const Prologue<Tin> pro = prologue_of<Tin>(corr, dbias);
    const Cotangent<Tout> ct{static_cast<const Tout*>(dy), static_cast<const Tout*>(ymax), count};
    if (ymax != nullptr) {
      bn_bwd_apply_kernel<Tin, Tout, V, true><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
          static_cast<const Tin*>(x), pro, ct, pl, static_cast<Tin*>(dx), mean, mul, bias, a, b, relu_on != 0);
    } else {
      bn_bwd_apply_kernel<Tin, Tout, V, false><<<grid_of(ctas, tiles), kThreads, 0, st>>>(
          static_cast<const Tin*>(x), pro, ct, pl, static_cast<Tin*>(dx), mean, mul, bias, a, b, relu_on != 0);
    }
    return cudaGetLastError();
  }));
}

}  // extern "C"
