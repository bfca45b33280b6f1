// Batch norm + ReLU on Hopper (sm_90a), with the layer around it: four
// kernels over the channels-last (R, C) view of a batch-norm site and a
// pooled variant of the second.
//
// The port's own kernels: the JAX package runs flax nn.Dense or
// CenteredDense, nn.BatchNorm, nn.relu and jnp.max over the ball's slots
// (votenet_tpu/models/pointnet2.py:95-103, 166-174, 540-541; votenet.py:
// 61-68) as XLA fusions and reaches no Pallas kernel. Here a site's training
// forward is K1 + K2, its backward K3 + K4, and an eval forward K2 alone:
//
//   K1 bn_stats_kernel       per channel sum(x) and sum(x * x); its last CTA
//                            turns them into the statistics (the end below)
//                            and moves the running statistics
//   K2 bn_apply_kernel       y = ((x - mean) * mul) + bias, rounded to the
//                            output type (nearest even), then, when asked,
//                            the ReLU in the output type; in eval it forms
//                            mul = rsqrt(running_var + eps) * weight itself,
//                            under a data-parallel group the statistics
//                            from the group's sums (the end below)
//   K2 bn_apply_pool_kernel  the same, then the max over each unit's S rows
//                            (the ball's slots) and the count of the slots
//                            equal to it; the full y is never written
//   K3 bn_bwd_reduce_kernel  per channel sum(g) and sum(g * (x - mean)), g
//                            = dy masked by the ReLU; its last CTA turns
//                            them into the coefficients (the end below)
//   K4 bn_bwd_apply_kernel   dx = ((g * mul) + a) + (b * x), or g * mul in
//                            eval, rounded to x's type; with the epilogue
//                            also the prologue's cotangents
//
// The prologue. Every kernel reads the dense layer's output h, not x, and
// recomputes x in registers: x = (h - corr[unit]) + dbias, each operation
// in f32 and rounded once to h's type (the eager ops' roundings; the
// centred first layer's association, votenet_tpu/models/pointnet2.py:103).
// corr (R / S rows, the centre's product with the coordinate rows of the
// kernel, in h's type) and dbias (the dense bias, C floats, rounded to h's
// type as it is read: the bits of the bias cast to h's type) are optional.
// So x is never written, and the backward needs h alone.
//
// The epilogue (K4). The prologue's cotangents leave K4 with dx: corr's,
// -sum(dx) over each unit of S rows (a row group takes whole units, so the
// sum is the thread's own), and the dense bias's, sum(dx) over all rows.
// Each adds the rounded dx values exactly in f64 (corr's: a unit's rows in
// order from +0, the negated dx; the dense bias's: the thread's rows in
// order, or at a centred site its units' sums; then the row groups and the
// CTAs' two-level tree of K1 and K3) and rounds once to h's type; the
// dense bias's leaves as that value in f32 (what autograd's cast of the
// bias gave). In training the dense bias's sum is 0 in exact
// arithmetic (batch norm takes out a shift), so what it holds is the
// rounding of dx: held to the f64 sum of the same terms, never to a
// relative tolerance.
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
// The per-channel end. The statistics (mean = s / count, var_raw = sq /
// count - mean^2, var = clamp(var_raw, 0), inv = rsqrt(var + eps), mul = inv
// * weight, the running statistics' momentum update) and the backward's
// coefficients (a and b of dx = g * mul + a + b * x, the weight's cotangent
// sum_gx * inv and the bias's sum_g) are the torch ops of
// ops/batchnorm.py::bn_channel_stats_plain and bn_channel_coefficients_plain
// written as the card runs them: a division by the count is a product with
// the host's f32 reciprocal (torch's division by a CPU scalar), rsqrt is
// rsqrtf, inv.pow(3) is (inv * inv) * inv; each value equals the torch op's
// on the card bit for bit (tests/test_torch_cuda.py). The last CTA of K1's
// and K3's reduction runs it for its channel tile, so a site's per-channel
// arithmetic launches nothing of its own. Under a data-parallel group K1
// writes its f64 sums, the caller all-reduces them, and K2 runs the
// statistics' end from them before its row loop: every CTA on the same sums
// (so with the same bits), the first CTA along the units writing the
// statistics (saved for the backward) and moving the running statistics. An
// eval backward's K3 and K4 form mul from the running statistics as K2
// does, and K3's end forms inv so. The ReLU's mask is recomputed
// from x by K2's arithmetic: g = 0 where the pre-ReLU output y <= 0, dy
// elsewhere (a NaN y passes its gradient: torch's threshold_backward). The
// ReLU is torch's clamp_min on the card: a NaN stays as it is, any other
// value becomes fmaxf(y, 0).
//
// Exactness: every float operation is one IEEE rounding (__fsub_rn,
// __fmul_rn, __fadd_rn, __fdiv_rn, and -fmad=false besides; in bf16 the
// packed bf16x2 subtract and add, which round the exact result once as the
// f32 op and the cast do, and cvt.rn.bf16x2.f32), so K2 and K4 compute the
// floats of the plain stages in ops/batchnorm.py on the same device (each
// torch elementwise op rounds once). K1 and K3 add in f64 (the terms x, x *
// x, g and g * f32(x - mean) are exact in f64) in an order of their own,
// fixed by the shape and the card's SM count (the launch plan,
// ops/cuda/batchnorm.py::bn_plan): each thread its rows in ascending order;
// the row groups of a CTA in order; then a tree of two levels over the
// CTAs' partial sums, blocks of `fan_in` consecutive CTAs added in CTA
// order, then the blocks' sums in block order (no float atomics); the sum
// is K1's output in f64 (under a data-parallel group, where the caller
// all-reduces it before the end) or rounded once to f32 before the end.
// tests/test_torch_bn_layer.py transcribes this order into numpy; two runs
// give the same bits. In f64 the order barely shows: the f32 sums are the
// correctly rounded ones but where the exact sum lies within ~1e-10 of a
// rounding boundary, so the batch statistics, and with them which outputs
// lie on either side of the ReLU, follow an f64 reference and not the
// summation order.
//
// What bounds them (NVIDIA H100 80GB HBM3): bytes in f32. At B = 8, sa1's
// last layer is 1,048,576 rows x 128 channels, 537 MB of f32: K1 reads it
// once (0.16 ms at 3.35 TB/s) with 3 operations an element, far below the
// f32 peak. A thread keeps U rows' loads in flight before it adds them, and
// the reductions' end is the two-level tree: ~sqrt(G) partials a channel at
// each level, loaded eight at a time. In bf16 the bytes halve and the work
// an element does not: K2's pool variant and the pooled K3 give a lane 8
// channels in one 16-byte load and work on them in bf16x2 pairs (the
// prologue, the rounding, the ReLU, the max and its ties, the slot's share)
// without branches.
//
// Design: a CTA of kThreads threads takes a range of consecutive units and
// a tile of channels. A lane holds V consecutive channels: V = 4 (one
// 16-byte f32 or 8-byte bf16 access) where C % 4 == 0 and the pointers are
// aligned, V = 8 (one 16-byte bf16 access) in the bf16 pool kernels where C
// % 8 == 0, else V = 1. The tile is W lanes (W = min(C / V, kThreads)); the
// CTA's kThreads / W row groups take its units in turn (unit u0 + rg, then
// + groups, ...), each unit's S rows in order, so the per-channel vectors
// stay in registers. Offsets are 64-bit: a B = 64 eval holds ~1.07e9
// elements at sa1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// CTAs an SM of each launch plan's kind (ops/cuda/batchnorm.py
// BN_CTAS_PER_SM, held equal to these by tests/test_torch_bn_layer.py): the
// register cap each kernel is compiled to, so that the plan's CTAs are
// resident at once
constexpr int kCtasReduce = 4;            // "reduce": K1
constexpr int kCtasReduceDy = 2;          // "reduce_dy": K3 over a full dy
constexpr int kCtasReducePooled = 3;      // "reduce_pooled": K3 at a pooled site
constexpr int kCtasReducePooledWide = 2;  // "reduce_pooled_wide": the pooled K3 in bf16, 8 channels a lane
constexpr int kCtasReduceDx = 3;          // "reduce_dx": K4 with the epilogue (the dense bias's tree)
constexpr int kCtasApply = 4;             // "apply": K2 and its f32 pool variant, K4 without the epilogue
constexpr int kCtasApplyWide = 3;         // "apply_wide": K2's pool variant in bf16, 8 channels a lane
// Rows a thread loads before it uses them: K1 and K2 read one
// (R, C) tensor, K3 and K4 two (x and dy; at a pooled site x and the
// unit's vectors, mostly L1 hits)
constexpr int kRows = 4;
constexpr int kPairRows = 2;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

// v rounded to T (nearest, ties to even), as a float. In bf16 through the
// packed conversion (cvt.rn.bf16x2.f32, F2FP), which rounds as the single
// one (F2F, a conversion unit that takes 1/8 of the FP32 units' rate) does
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    const __nv_bfloat162 h = __float2bfloat162_rn(v);
    uint32_t u;
    memcpy(&u, &h, 4);
    return __uint_as_float(u << 16);
  }
}

// v rounded once to T (nearest, ties to even), as a float
template <typename T>
__device__ __forceinline__ float round_from_double(double v) {
  if constexpr (std::is_same<T, float>::value) {
    return __double2float_rn(v);
  } else {
    return __bfloat162float(__double2bfloat16(v));
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

// The normalised value before the ReLU, unrounded.
__device__ __forceinline__ float affine(float x, float mean, float mul, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}

// The normalised value before the ReLU, rounded to Tout, as a float.
template <typename Tout>
__device__ __forceinline__ float normalized(float x, float mean, float mul, float bias) {
  return round_to<Tout>(affine(x, mean, mul, bias));
}

__device__ __forceinline__ float relu(float y) { return isnan(y) ? y : fmaxf(y, 0.0f); }

// The ReLU's backward: dy where y > 0 or y is NaN, else 0.
__device__ __forceinline__ float masked(float dy, float y, bool relu_on) { return relu_on && y <= 0.0f ? 0.0f : dy; }

// ------------------------------------------------------------ bf16x2 pairs
// A 32-bit word holds two bf16 channels, the lower one in the low half.

__device__ __forceinline__ bf162 as_bf2(uint32_t u) {
  bf162 h;
  memcpy(&h, &u, 4);
  return h;
}

__device__ __forceinline__ uint32_t as_u32(bf162 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__device__ __forceinline__ float lo_of(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_of(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// (lo, hi) rounded to bf16 and packed (cvt.rn.bf16x2.f32)
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) { return as_u32(__floats2bfloat162_rn(lo, hi)); }

// torch's ReLU of two bf16 values: a NaN stays, any other value becomes
// max(y, 0) (max.NaN.bf16x2)
__device__ __forceinline__ uint32_t relu2(uint32_t y) { return as_u32(__hmax2_nan(as_bf2(y), as_bf2(0u))); }

// 0xffff in each half where the half is a NaN
__device__ __forceinline__ uint32_t nan_mask2(uint32_t y) { return __hneu2_mask(as_bf2(y), as_bf2(y)); }

// The layer around the site: x = (h - corr[unit]) + dbias, each operation
// rounded to T; corr (units x C, T) and dbias (C, f32, rounded to T as it
// is read) may be null.
template <typename T>
struct Prologue {
  const T* __restrict__ corr;
  const float* __restrict__ dbias;
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
  for (int j = 0; j < V; ++j) db[j] = p.dbias != nullptr ? round_to<T>(p.dbias[c + j]) : 0.0f;
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

// The prologue on four bf16x2 words (8 channels): the packed subtract and
// add round the exact result once, as the f32 op and the cast to bf16 do
__device__ __forceinline__ void prologue8(const uint32_t (&corr)[4], const uint32_t (&db)[4], bool has_corr,
                                          bool has_db, uint32_t (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (has_corr) w[i] = as_u32(__hsub2(as_bf2(w[i]), as_bf2(corr[i])));
    if (has_db) w[i] = as_u32(__hadd2(as_bf2(w[i]), as_bf2(db[i])));
  }
}

__device__ __forceinline__ void load8(const bf16* __restrict__ p, uint32_t (&w)[4]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  w[0] = q.x;
  w[1] = q.y;
  w[2] = q.z;
  w[3] = q.w;
}

// The per-unit factor of a pooled site's cotangent, as torch.amax's
// backward forms it: q = gp / count, rounded to T (count as T); a slot's
// cotangent is then q * (y == max), rounded to T.
template <typename T>
__device__ __forceinline__ float pooled_share(float gp, int count) {
  return round_to<T>(__fdiv_rn(gp, round_to<T>(static_cast<float>(count))));
}

// ------------------------------------------------------- the per-channel end

// torch.rsqrt on the card (::rsqrt, rsqrtf)
__device__ __forceinline__ float torch_rsqrt(float v) { return rsqrtf(v); }

// torch.clamp(v, min=0) on the card: a NaN stays
__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// The statistics' end: its inputs, and where it writes. `inv_count` is the
// host's f32 1 / count (torch divides by a CPU scalar so), `f_old` and
// `f_new` f32 momentum and f32 (1 - momentum).
struct StatsEnd {
  float* out;                // (4, C): mean, mul, inv, var_raw; null: K1 writes its f64 sums
  const float* weight;
  float* running_mean;
  float* running_var;
  int update;                // move the running statistics
  float inv_count, eps, f_old, f_new;
};

// One channel's statistics
struct ChannelStats {
  float mean, mul, inv, var_raw, var;
};

// Channel c's statistics from its f64 sums (rounded to f32 first, as the
// op rounds K1's sums); reads the sums and the weight alone
__device__ __forceinline__ ChannelStats stats_of(const StatsEnd& e, int c, double s, double sq) {
  ChannelStats v;
  const float sf = __double2float_rn(s), sqf = __double2float_rn(sq);
  v.mean = __fmul_rn(sf, e.inv_count);
  v.var_raw = __fsub_rn(__fmul_rn(sqf, e.inv_count), __fmul_rn(v.mean, v.mean));
  v.var = clamp_min0(v.var_raw);
  v.inv = torch_rsqrt(__fadd_rn(v.var, e.eps));
  v.mul = __fmul_rn(v.inv, e.weight[c]);
  return v;
}

// Channel c's statistics into e.out, and the running statistics moved to
// f_old * running + f_new * batch
__device__ __forceinline__ void write_stats(const StatsEnd& e, int C, int c, const ChannelStats& v) {
  if (e.update) {
    e.running_mean[c] = __fadd_rn(__fmul_rn(e.running_mean[c], e.f_old), __fmul_rn(v.mean, e.f_new));
    e.running_var[c] = __fadd_rn(__fmul_rn(e.running_var[c], e.f_old), __fmul_rn(v.var, e.f_new));
  }
  e.out[c] = v.mean;
  e.out[C + c] = v.mul;
  e.out[2 * C + c] = v.inv;
  e.out[3 * C + c] = v.var_raw;
}

__device__ void stats_end(const StatsEnd& e, int C, int c, double s, double sq) {
  write_stats(e, C, c, stats_of(e, c, s, sq));
}

// The coefficients' end: its inputs, and where it writes.
struct CoefEnd {
  float* out;                // (4, C): a, b, the weight's and the bias's cotangents; null: K3 writes its f32 sums
  const float* st;           // (4, C): mean, mul, inv, var_raw (the statistics' end's); null in eval:
  const float* eval_var;     //   inv = rsqrt(eval_var + eps), the statistics' end's arithmetic
  float eps;
  const float* weight;
  float inv_count;
  int training;              // a and b only in training
};

// Channel c's coefficients from the f64 sums of g and g * (x - mean)
// (rounded to f32 first): autograd of the statistics' formula, written out
// (torch.clamp's rule: no gradient through the clamp where var_raw < 0)
__device__ void coef_end(const CoefEnd& e, int C, int c, double sg, double sgx) {
  const float sum_g = __double2float_rn(sg), sum_gx = __double2float_rn(sgx);
  const float inv = e.st != nullptr ? e.st[2 * C + c] : torch_rsqrt(__fadd_rn(e.eval_var[c], e.eps));
  e.out[2 * C + c] = __fmul_rn(sum_gx, inv);
  e.out[3 * C + c] = sum_g;
  if (!e.training) return;
  const float mean = e.st[c], mul = e.st[C + c], var_raw = e.st[3 * C + c];
  const float inv3 = __fmul_rn(__fmul_rn(inv, inv), inv);
  float d_var = __fmul_rn(__fmul_rn(sum_gx, e.weight[c]), __fmul_rn(inv3, -0.5f));
  if (var_raw < 0.0f) d_var = 0.0f;
  const float d_mean = __fsub_rn(-__fmul_rn(mul, sum_g), __fmul_rn(__fmul_rn(mean, 2.0f), d_var));
  e.out[c] = __fmul_rn(d_mean, e.inv_count);
  e.out[C + c] = __fmul_rn(__fmul_rn(d_var, e.inv_count), 2.0f);
}

// ------------------------------------------------------ the reductions' end

// n channels from c_lo of rows [k0, k1) of each of the NS sums' src (C
// doubles a row, the sums `stride` apart), added in row order from 0, handed
// to f(channel, sums); eight rows' loads at a time (a missing row loads 0,
// which leaves a sum that is not -0 unchanged: the sums start at +0 and
// round to nearest, so none is -0)
template <int NS, typename F>
__device__ void add_rows(const double* __restrict__ src, int64_t stride, int k0, int k1, int C, int c_lo, int n,
                         F&& f) {
  for (int ci = threadIdx.x; ci < n; ci += kThreads) {
    double p[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) p[q] = 0.0;
    for (int k = k0; k < k1; k += 8) {
      double a[NS][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t off = static_cast<int64_t>(k + j) * C + c_lo + ci;
#pragma unroll
        for (int q = 0; q < NS; ++q) a[q][j] = k + j < k1 ? __ldcg(src + q * stride + off) : 0.0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int q = 0; q < NS; ++q) p[q] = __dadd_rn(p[q], a[q][j]);
      }
    }
    f(c_lo + ci, p);
  }
}

// The end of K1, K3 and K4's epilogue over NS per-channel sums. The CTA's
// row groups added in order give one partial a sum and channel (workspace
// row blockIdx.x). The G CTAs form L = ceil(G / fan_in) blocks of fan_in
// consecutive CTAs; the last CTA of a block to finish (an integer ticket)
// adds the block's partials in CTA order into workspace row G + block (or
// hands them to `end` when L == 1), and the last block to finish adds those
// L rows in block order and hands them to `end`. Every sum is f64 (each add
// one rounding). The workspace holds NS arrays of (G + L) x C doubles;
// tickets: L + 1 ints a channel tile, each set back to 0 by the CTA that
// took its last count.
template <int NS, int V, typename End>
__device__ void finish_sums(const Slot& s, int C, int W, int fan_in, const double (&acc)[NS][V],
                            double* __restrict__ ws, int* __restrict__ tickets, End&& end) {
  __shared__ double sh[NS][kThreads * V];
  __shared__ bool last;
  const int G = gridDim.x;
  const int L = (G + fan_in - 1) / fan_in;
  const int64_t stride = static_cast<int64_t>(G + L) * C;
#pragma unroll
  for (int q = 0; q < NS; ++q) {
#pragma unroll
    for (int j = 0; j < V; ++j) sh[q][threadIdx.x * V + j] = acc[q][j];
  }
  __syncthreads();
  if (s.rg == 0 && s.c >= 0) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        double p = 0.0;
        for (int g = 0; g < s.groups; ++g) p = __dadd_rn(p, sh[q][(g * W + lane) * V + j]);
        ws[q * stride + static_cast<int64_t>(blockIdx.x) * C + s.c + j] = p;
      }
    }
  }
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
    add_rows<NS>(ws, stride, k0, k1, C, c_lo, n, end);
    if (threadIdx.x == 0) tk[blk] = 0;
    return;
  }
  double* level = ws + static_cast<int64_t>(G + blk) * C;
  add_rows<NS>(ws, stride, k0, k1, C, c_lo, n, [&](int c, const double (&p)[NS]) {
#pragma unroll
    for (int q = 0; q < NS; ++q) level[q * stride + c] = p[q];
  });
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    tk[blk] = 0;  // every CTA of the block has taken its ticket
    last = atomicAdd(&tk[L], 1) == L - 1;
  }
  __syncthreads();
  if (!last) return;
  add_rows<NS>(ws + static_cast<int64_t>(G) * C, stride, 0, L, C, c_lo, n, end);
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
    bn_stats_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Plan pl, int fan_in, double* __restrict__ ws,
                    int* __restrict__ tickets, double* __restrict__ sum, double* __restrict__ sumsq, StatsEnd e) {
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  double acc[2][V] = {};
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
          acc[0][j] = __dadd_rn(acc[0][j], xv);
          acc[1][j] = __dadd_rn(acc[1][j], __dmul_rn(xv, xv));
        }
      }
    }
  }
  const int C = pl.C;
  finish_sums<2, V>(s, C, pl.W, fan_in, acc, ws, tickets, [&](int c, const double (&p)[2]) {
    if (e.out != nullptr) {
      stats_end(e, C, c, p[0], p[1]);
    } else {
      sum[c] = p[0];
      sumsq[c] = p[1];
    }
  });
}

// Where K2, K3 and K4 read their per-channel vectors: the batch's mean and
// mul (training); the running statistics and the weight (eval: eval_var
// non-null, mul = rsqrt(eval_var + eps) * weight, the statistics' end's
// arithmetic); or, in K2 under a data-parallel group, the group's
// all-reduced f64 sums (2, C), from which every CTA runs the statistics' end
// (stats_of: the same sums, the same bits in every CTA) and the first CTA
// along the units writes it (end.out) and moves the running statistics
struct ApplyChannels {
  const float* mean;
  const float* mul;  // the weight in eval
  const float* bias;
  const float* eval_var;
  float eps;
  const double* sums;
  StatsEnd end;
};

template <int V>
__device__ __forceinline__ void load_apply(const ApplyChannels& ch, const Slot& s, int C, float (&m)[V], float (&k)[V],
                                           float (&b)[V]) {
  const int c = s.c;
  load_channels<V>(ch.bias, c, b);
  if (ch.sums != nullptr) {  // the statistics' end, outside the row loop
    const bool writer = blockIdx.x == 0 && s.rg == 0;  // one lane a channel of the tile
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const ChannelStats v = stats_of(ch.end, c + j, ch.sums[c + j], ch.sums[C + c + j]);
      m[j] = v.mean;
      k[j] = v.mul;
      if (writer) write_stats(ch.end, C, c + j, v);
    }
    return;
  }
  load_channels<V>(ch.mean, c, m);
  load_channels<V>(ch.mul, c, k);
  if (ch.eval_var != nullptr) {
#pragma unroll
    for (int j = 0; j < V; ++j) k[j] = __fmul_rn(torch_rsqrt(__fadd_rn(ch.eval_var[c + j], ch.eps)), k[j]);
  }
}

// K2
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads, kCtasApply)
    bn_apply_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Plan pl, Tout* __restrict__ y, ApplyChannels ch,
                    bool relu_on) {
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  if (s.c < 0) return;
  float m[V], k[V], b[V], db[V];
  load_apply<V>(ch, s, pl.C, m, k, b);
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
// rows taken in order by one row group. With V = 8 (bf16 in and out) a
// lane's 8 channels are four bf16x2 words: the prologue, the rounding and
// the ReLU pairwise, and the max and its ties without branches (a row
// greater than the max, or a NaN, takes it and restarts the count; one
// equal adds to it; a NaN max stays, and its count is 0).
template <typename Tin, typename Tout, int V, bool WIDE = V == 8>
__global__ void __launch_bounds__(kThreads, WIDE ? kCtasApplyWide : kCtasApply)
    bn_apply_pool_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Plan pl, Tout* __restrict__ ymax,
                         int* __restrict__ count, ApplyChannels ch, bool relu_on) {
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  if (s.c < 0) return;
  float m[V], k[V], b[V], db[V];
  load_apply<V>(ch, s, pl.C, m, k, b);
  load_dbias<Tin, V>(pro, s.c, db);
  if constexpr (WIDE) {
    static_assert(std::is_same<Tin, bf16>::value && std::is_same<Tout, bf16>::value, "8 channels a lane: bf16");
    uint32_t dbw[4], cw[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) dbw[i] = pack_rn(db[2 * i], db[2 * i + 1]);  // already bf16 values: exact
    const bool has_corr = pro.corr != nullptr, has_db = pro.dbias != nullptr;
    for (int64_t u = s.u0 + s.rg; u < s.u1; u += s.groups) {
      if (has_corr) load8(pro.corr + u * pl.C + s.c, cw);
      uint32_t mx[4], cnt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mx[i] = 0xff80ff80u;  // -inf, -inf
        cnt[i] = 0;
      }
      for (int r0 = 0; r0 < pl.S; r0 += kRows) {
        uint32_t w[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < pl.S) load8(x + (u * pl.S + r0 + r) * pl.C + s.c, w[r]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r0 + r >= pl.S) continue;
          prologue8(cw, dbw, has_corr, has_db, w[r]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t yv = pack_rn(affine(lo_of(w[r][i]), m[2 * i], k[2 * i], b[2 * i]),
                                  affine(hi_of(w[r][i]), m[2 * i + 1], k[2 * i + 1], b[2 * i + 1]));
            if (relu_on) yv = relu2(yv);
            const uint32_t gt = __hgt2_mask(as_bf2(yv), as_bf2(mx[i]));
            const uint32_t eq = __heq2_mask(as_bf2(yv), as_bf2(mx[i]));
            const uint32_t take = gt | nan_mask2(yv);
            mx[i] = (mx[i] & ~take) | (yv & take);
            cnt[i] = (cnt[i] & ~gt) + ((gt | eq) & 0x00010001u);  // counts below 2^16: no carry across
          }
        }
      }
      *reinterpret_cast<uint4*>(ymax + u * pl.C + s.c) = make_uint4(mx[0], mx[1], mx[2], mx[3]);
      int c8[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t n = cnt[i] & ~nan_mask2(mx[i]);  // no slot equals a NaN max
        c8[2 * i] = static_cast<int>(n & 0xffffu);
        c8[2 * i + 1] = static_cast<int>(n >> 16);
      }
      int4* out = reinterpret_cast<int4*>(count + u * pl.C + s.c);
      out[0] = make_int4(c8[0], c8[1], c8[2], c8[3]);
      out[1] = make_int4(c8[4], c8[5], c8[6], c8[7]);
    }
  } else {
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
// site (x alone a row) kCtasReducePooled CTAs of kPairRows, and in bf16
// with 8 channels a lane (WIDE) kCtasReducePooledWide CTAs, whose 16 f64
// accumulators a thread need the registers, of kRows rows of 16 bytes:
// each unit's share and max as bf16x2 words, and the slot's cotangent
// (q * (y == max), masked where the pre-ReLU y <= 0) pairwise.
constexpr int kDyRows = 4;

template <typename Tin, typename Tout, int V, bool POOLED, bool WIDE = V == 8>
__global__ void __launch_bounds__(kThreads, POOLED ? WIDE ? kCtasReducePooledWide : kCtasReducePooled : kCtasReduceDy)
    bn_bwd_reduce_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Cotangent<Tout> ct, Plan pl, int fan_in,
                         ApplyChannels ch, bool relu_on, double* __restrict__ ws,
                         int* __restrict__ tickets, float* __restrict__ sum_g, float* __restrict__ sum_gx,
                         CoefEnd e) {
  constexpr int kU = POOLED ? kPairRows : kDyRows;
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  double acc[2][V] = {};
  if (s.c >= 0) {
    float m[V], k[V], b[V], db[V];
    load_apply<V>(ch, s, pl.C, m, k, b);
    load_dbias<Tin, V>(pro, s.c, db);
    if constexpr (WIDE) {
      static_assert(POOLED && std::is_same<Tin, bf16>::value && std::is_same<Tout, bf16>::value,
                    "8 channels a lane: the pooled K3 in bf16");
      uint32_t dbw[4], cw[4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i) dbw[i] = pack_rn(db[2 * i], db[2 * i + 1]);
      const bool has_corr = pro.corr != nullptr, has_db = pro.dbias != nullptr;
      for (int64_t u = s.u0 + s.rg; u < s.u1; u += s.groups) {
        const int64_t uoff = u * pl.C + s.c;
        if (has_corr) load8(pro.corr + uoff, cw);
        uint32_t gpw[4], mx[4], q[4];
        load8(ct.dy + uoff, gpw);
        load8(ct.ymax + uoff, mx);
        const int4 c0 = *reinterpret_cast<const int4*>(ct.count + uoff);
        const int4 c1 = *reinterpret_cast<const int4*>(ct.count + uoff + 4);
        const int cn[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          q[i] = pack_rn(pooled_share<bf16>(lo_of(gpw[i]), cn[2 * i]),
                         pooled_share<bf16>(hi_of(gpw[i]), cn[2 * i + 1]));  // bf16 values: exact
        for (int r0 = 0; r0 < pl.S; r0 += kRows) {
          uint32_t w[kRows][4];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r0 + r < pl.S) load8(x + (u * pl.S + r0 + r) * pl.C + s.c, w[r]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r0 + r >= pl.S) continue;
            prologue8(cw, dbw, has_corr, has_db, w[r]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float d0 = __fsub_rn(lo_of(w[r][i]), m[2 * i]);
              const float d1 = __fsub_rn(hi_of(w[r][i]), m[2 * i + 1]);
              const uint32_t t = pack_rn(__fadd_rn(__fmul_rn(d0, k[2 * i]), b[2 * i]),
                                         __fadd_rn(__fmul_rn(d1, k[2 * i + 1]), b[2 * i + 1]));
              const uint32_t one = __heq2_mask(as_bf2(relu_on ? relu2(t) : t), as_bf2(mx[i])) & 0x3f803f80u;
              uint32_t g = as_u32(__hmul2(as_bf2(q[i]), as_bf2(one)));  // q * (y == max), rounded
              if (relu_on) g &= ~__hle2_mask(as_bf2(t), as_bf2(0u));    // +0 where the pre-ReLU y <= 0
              const double g0 = lo_of(g), g1 = hi_of(g);
              acc[0][2 * i] = __dadd_rn(acc[0][2 * i], g0);
              acc[1][2 * i] = __dadd_rn(acc[1][2 * i], __dmul_rn(g0, static_cast<double>(d0)));
              acc[0][2 * i + 1] = __dadd_rn(acc[0][2 * i + 1], g1);
              acc[1][2 * i + 1] = __dadd_rn(acc[1][2 * i + 1], __dmul_rn(g1, static_cast<double>(d1)));
            }
          }
        }
      }
    } else {
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
            acc[0][j] = __dadd_rn(acc[0][j], gv);
            acc[1][j] = __dadd_rn(acc[1][j], __dmul_rn(gv, static_cast<double>(__fsub_rn(v[r][j], m[j]))));
          }
        });
      }
    }
  }
  const int C = pl.C;
  finish_sums<2, V>(s, C, pl.W, fan_in, acc, ws, tickets, [&](int c, const double (&p)[2]) {
    if (e.out != nullptr) {
      coef_end(e, C, c, p[0], p[1]);
    } else {  // the result: rounded once to f32
      sum_g[c] = __double2float_rn(p[0]);
      sum_gx[c] = __double2float_rn(p[1]);
    }
  });
}

// K4's epilogue: where the prologue's cotangents go. dcorr (units x C, in
// x's type; with EPI 2) and dbias (C floats, through the tree's workspace
// and tickets) may each be null.
template <typename Tin>
struct Epilogue {
  Tin* __restrict__ dcorr;
  float* __restrict__ dbias;
  double* __restrict__ ws;
  int* __restrict__ tickets;
  int fan_in;
};

// K4; a and b are null in eval (dx = g * mul). The epilogue: EPI 0 none; 1
// the dense bias's sum(dx), a thread's rows added in order; 2 also each
// unit's -sum(dx) (corr's cotangent), the unit's rows from +0, and the
// thread's sum adds its units' sums.
template <typename Tin, typename Tout, int V, bool POOLED, int EPI>
__global__ void __launch_bounds__(kThreads, EPI ? kCtasReduceDx : kCtasApply)
    bn_bwd_apply_kernel(const Tin* __restrict__ x, Prologue<Tin> pro, Cotangent<Tout> ct, Plan pl,
                        Tin* __restrict__ dx, ApplyChannels ch, const float* __restrict__ a,
                        const float* __restrict__ b, bool relu_on, Epilogue<Tin> ep) {
  constexpr bool SUMS = EPI != 0;
  const Slot s = slot<V>(pl.units, pl.C, pl.W, pl.units_per_cta);
  if constexpr (!SUMS) {
    if (s.c < 0) return;
  }
  double tot[1][V] = {}, un[V] = {};  // the thread's sum, and (EPI 2) the current unit's
  if (s.c >= 0) {
    const bool stats = a != nullptr;
    float m[V], k[V], bi[V], db[V], ca[V] = {}, cb[V] = {};
    load_apply<V>(ch, s, pl.C, m, k, bi);
    load_dbias<Tin, V>(pro, s.c, db);
    if (stats) {
      load_channels<V>(a, s.c, ca);
      load_channels<V>(b, s.c, cb);
    }
    int cur = -1;
    // (EPI 2) the unit `cur` ends: its cotangent out, its sum into the thread's
    auto flush = [&]() {
      if (cur < 0) return;
      float r[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        r[j] = round_from_double<Tin>(un[j]);
        tot[0][j] = __dadd_rn(tot[0][j], -un[j]);
        un[j] = 0.0;
      }
      store<Tin, V>(ep.dcorr + static_cast<int64_t>(cur) * pl.C + s.c, r);
    };
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
        if constexpr (EPI == 2) {
          if (unit[r] != cur) {
            flush();
            cur = unit[r];
          }
#pragma unroll
          for (int j = 0; j < V; ++j) un[j] = __dadd_rn(un[j], -static_cast<double>(v[r][j]));  // exact terms
        } else if constexpr (EPI == 1) {
#pragma unroll
          for (int j = 0; j < V; ++j) tot[0][j] = __dadd_rn(tot[0][j], static_cast<double>(v[r][j]));
        }
      });
    }
    if constexpr (EPI == 2) flush();
  }
  if constexpr (SUMS) {
    if (ep.dbias != nullptr) {  // the same for every CTA: the tree's barriers are safe
      finish_sums<1, V>(s, pl.C, pl.W, ep.fan_in, tot, ep.ws, ep.tickets, [&](int c, const double (&p)[1]) {
        ep.dbias[c] = round_from_double<Tin>(p[0]);
      });
    }
  }
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<Ta>, Tag<Tb>, V) for the runtime types (bf16 flags) and vector
// width (1 or 4)
template <typename F>
cudaError_t dispatch(int a_bf16, int b_bf16, int vec, F&& f) {
  auto with_b = [&](auto ta) -> cudaError_t {
    auto with_v = [&](auto tb) -> cudaError_t {
      return vec == 4 ? f(ta, tb, std::integral_constant<int, 4>{}) : f(ta, tb, std::integral_constant<int, 1>{});
    };
    return b_bf16 ? with_v(Tag<bf16>{}) : with_v(Tag<float>{});
  };
  return a_bf16 ? with_b(Tag<bf16>{}) : with_b(Tag<float>{});
}

dim3 grid_of(int ctas, int tiles) { return dim3(static_cast<unsigned>(ctas), static_cast<unsigned>(tiles)); }

template <typename T>
Prologue<T> prologue_of(const void* corr, const float* dbias) {
  return Prologue<T>{static_cast<const T*>(corr), dbias};
}

}  // namespace

extern "C" {

// Each takes the plan of ops/cuda/batchnorm.py::bn_plan: W lanes a CTA,
// `ctas` CTAs along the units (units_per_cta each, a unit S rows) and
// `tiles` along the channels; vec is V, the channels a lane (1, 4, or 8 in
// the bf16 pool kernels). The prologue's corr (R / S x C) is in x's type,
// dbias (C) f32, either may be null; fewer than 2^31 rows. The reductions'
// ws holds NS x (ctas + ceil(ctas / fan_in)) x C doubles (NS = 2 for K1 and
// K3, 1 for K4's epilogue), and tickets (ceil(ctas / fan_in) + 1) x tiles
// ints that are 0 on entry and on exit (each is set back by the CTA that
// took its last count), so a stream can reuse them without a memset.
// Returns the launch's CUDA error (0).

// With st non-null the statistics' end (mean, mul, inv, var_raw into st,
// the running statistics moved when `update`); else the f64 sums
int votenet_bn_stats(const void* x, int x_bf16, const void* corr, const float* dbias, int S, int64_t R, int C,
                     int vec, int W, int ctas, int tiles, int64_t units_per_cta, int fan_in, double* ws,
                     int* tickets, double* sum, double* sumsq, float* st, const float* weight, float* running_mean,
                     float* running_var, int update, float inv_count, float eps, float f_old, float f_new,
                     void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Plan pl{R / S, S, C, W, units_per_cta};
  const StatsEnd e{st, weight, running_mean, running_var, update, inv_count, eps, f_old, f_new};
  return static_cast<int>(dispatch(x_bf16, 0, vec, [&](auto ta, auto, auto v) {
    using Tin = typename decltype(ta)::type;
    bn_stats_kernel<Tin, decltype(v)::value><<<grid_of(ctas, tiles), kThreads, 0, cs>>>(
        static_cast<const Tin*>(x), prologue_of<Tin>(corr, dbias), pl, fan_in, ws, tickets, sum, sumsq, e);
    return cudaGetLastError();
  }));
}

// y is (R, C), or with count non-null the pool variant's (R / S, C) maxima
// beside their int32 counts; with eval_var non-null `mul` is the weight and
// `mean` the running mean (eval); with sums non-null (a data-parallel
// group's (2, C) f64 sums; mean and mul null) the statistics' end (mean,
// mul, inv, var_raw into st, the running statistics moved when `update`)
int votenet_bn_apply(const void* x, int x_bf16, const void* corr, const float* dbias, int S, void* y, int y_bf16,
                     int* count, int64_t R, int C, int vec, int W, int ctas, int tiles, int64_t units_per_cta,
                     const float* mean, const float* mul, const float* bias, const float* eval_var, float eps,
                     int relu_on, const double* sums, float* st, const float* weight, float* running_mean,
                     float* running_var, int update, float inv_count, float end_eps, float f_old, float f_new,
                     void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Plan pl{R / S, S, C, W, units_per_cta};
  const ApplyChannels ch{mean, mul, bias, eval_var, eps, sums,
                         StatsEnd{st, weight, running_mean, running_var, update, inv_count, end_eps, f_old, f_new}};
  if (vec == 8) {  // the bf16 pool variant, 8 channels a lane
    if (count == nullptr || !x_bf16 || !y_bf16) return static_cast<int>(cudaErrorInvalidValue);
    bn_apply_pool_kernel<bf16, bf16, 8><<<grid_of(ctas, tiles), kThreads, 0, cs>>>(
        static_cast<const bf16*>(x), prologue_of<bf16>(corr, dbias), pl, static_cast<bf16*>(y), count, ch,
        relu_on != 0);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(dispatch(x_bf16, y_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    constexpr int V = decltype(v)::value;
    const Prologue<Tin> pro = prologue_of<Tin>(corr, dbias);
    if (count != nullptr) {
      bn_apply_pool_kernel<Tin, Tout, V><<<grid_of(ctas, tiles), kThreads, 0, cs>>>(
          static_cast<const Tin*>(x), pro, pl, static_cast<Tout*>(y), count, ch, relu_on != 0);
    } else {
      bn_apply_kernel<Tin, Tout, V><<<grid_of(ctas, tiles), kThreads, 0, cs>>>(
          static_cast<const Tin*>(x), pro, pl, static_cast<Tout*>(y), ch, relu_on != 0);
    }
    return cudaGetLastError();
  }));
}

// dy is (R, C), or with ymax non-null the pooled cotangent (R / S, C) beside
// the pool's maxima and counts; mean, mul and eval_var as in
// votenet_bn_apply. With co non-null the coefficients' end (a, b (training
// only), the weight's and the bias's cotangents into co, from st, or in
// eval with st null from eval_var); else the f32 sums
int votenet_bn_bwd_reduce(const void* x, int x_bf16, const void* corr, const float* dbias, int S, const void* dy,
                          int dy_bf16, const void* ymax, const int* count, int64_t R, int C, int vec, int W, int ctas,
                          int tiles, int64_t units_per_cta, int fan_in, const float* mean, const float* mul,
                          const float* bias, const float* eval_var, float eps, int relu_on, double* ws, int* tickets,
                          float* sum_g, float* sum_gx, float* co, const float* st, const float* weight,
                          float inv_count, int training, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Plan pl{R / S, S, C, W, units_per_cta};
  const ApplyChannels ch{mean, mul, bias, eval_var, eps, nullptr, StatsEnd{}};
  const CoefEnd e{co, st, eval_var, eps, weight, inv_count, training};
  if (vec == 8) {  // the pooled K3 in bf16, 8 channels a lane
    if (ymax == nullptr || !x_bf16 || !dy_bf16) return static_cast<int>(cudaErrorInvalidValue);
    const Cotangent<bf16> ct{static_cast<const bf16*>(dy), static_cast<const bf16*>(ymax), count};
    bn_bwd_reduce_kernel<bf16, bf16, 8, true><<<grid_of(ctas, tiles), kThreads, 0, cs>>>(
        static_cast<const bf16*>(x), prologue_of<bf16>(corr, dbias), ct, pl, fan_in, ch, relu_on != 0, ws, tickets,
        sum_g, sum_gx, e);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(dispatch(x_bf16, dy_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    constexpr int V = decltype(v)::value;
    const Prologue<Tin> pro = prologue_of<Tin>(corr, dbias);
    const Cotangent<Tout> ct{static_cast<const Tout*>(dy), static_cast<const Tout*>(ymax), count};
    if (ymax != nullptr) {
      bn_bwd_reduce_kernel<Tin, Tout, V, true><<<grid_of(ctas, tiles), kThreads, 0, cs>>>(
          static_cast<const Tin*>(x), pro, ct, pl, fan_in, ch, relu_on != 0, ws, tickets, sum_g, sum_gx, e);
    } else {
      bn_bwd_reduce_kernel<Tin, Tout, V, false><<<grid_of(ctas, tiles), kThreads, 0, cs>>>(
          static_cast<const Tin*>(x), pro, ct, pl, fan_in, ch, relu_on != 0, ws, tickets, sum_g, sum_gx, e);
    }
    return cudaGetLastError();
  }));
}

// mean, mul and eval_var as in votenet_bn_apply; epi (K4's EPI): 0 none; 1
// the dense bias's cotangent (C floats) into dbias_out through the tree
// (ws, tickets, fan_in); 2 also corr's into dcorr (R / S x C, x's type),
// dbias_out then optional
int votenet_bn_bwd_apply(const void* x, int x_bf16, const void* corr, const float* dbias, int S, const void* dy,
                         int dy_bf16, const void* ymax, const int* count, void* dx, int64_t R, int C, int vec, int W,
                         int ctas, int tiles, int64_t units_per_cta, const float* mean, const float* mul,
                         const float* bias, const float* eval_var, float eps, const float* a, const float* b,
                         int relu_on, int epi, void* dcorr, float* dbias_out, double* ws, int* tickets, int fan_in,
                         void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Plan pl{R / S, S, C, W, units_per_cta};
  const ApplyChannels ch{mean, mul, bias, eval_var, eps, nullptr, StatsEnd{}};
  return static_cast<int>(dispatch(x_bf16, dy_bf16, vec, [&](auto ta, auto tb, auto v) {
    using Tin = typename decltype(ta)::type;
    using Tout = typename decltype(tb)::type;
    constexpr int V = decltype(v)::value;
    const Prologue<Tin> pro = prologue_of<Tin>(corr, dbias);
    const Cotangent<Tout> ct{static_cast<const Tout*>(dy), static_cast<const Tout*>(ymax), count};
    const Epilogue<Tin> ep{static_cast<Tin*>(dcorr), dbias_out, ws, tickets, fan_in};
    auto launch = [&](auto pooled) {
      auto with = [&](auto e) {
        bn_bwd_apply_kernel<Tin, Tout, V, decltype(pooled)::value, decltype(e)::value>
            <<<grid_of(ctas, tiles), kThreads, 0, cs>>>(static_cast<const Tin*>(x), pro, ct, pl,
                                                        static_cast<Tin*>(dx), ch, a, b, relu_on != 0, ep);
      };
      if (epi == 2) {
        with(std::integral_constant<int, 2>{});
      } else if (epi == 1) {
        with(std::integral_constant<int, 1>{});
      } else {
        with(std::integral_constant<int, 0>{});
      }
    };
    if (ymax != nullptr) {
      launch(std::true_type{});
    } else {
      launch(std::false_type{});
    }
    return cudaGetLastError();
  }));
}

}  // extern "C"
