// The detection head's decode on Hopper (sm_90a): proposal channels -> box
// corners, sizes, headings and the NMS scores, one thread a proposal.
//
// The port's own kernel: the JAX package decodes in XLA
// (votenet_tpu/models/decode.py:44-88, decode_proposals and get_3d_bbox; no
// Pallas kernel). In eager PyTorch that decode is some 70 launches, and its
// torch.cos/torch.sin, torch.remainder and einsum round differently on the
// card and on the CPU, so the corners (and the NMS keep mask computed from
// them) depended on the device. This kernel and its plain version
// (votenet_tpu_torch/models/decode.py::decode_proposals_plain) compute the
// same floats.
//
// What it computes, for proposal p of the head's output `out` (BP rows of C
// channels: objectness 0-1, centre offset 2-4, NH heading scores, NH heading
// residuals, NS size scores, NS x 3 size residuals, NC class scores):
//   heading_cls, size_cls: argmax of their scores, the first index on ties,
//     a NaN above every number (torch.argmax, jnp.argmax);
//   size = mean_size[size_cls] * max(1 + res[size_cls], 1e-6);
//   center = xyz + out[2:5];
//   heading = (heading_cls * 2 + res[heading_cls]) * f32(pi / NH), reduced
//     as jnp.mod does: r = fmod(x, f32(2 pi)), plus f32(2 pi) where r < 0;
//   the 24 corner coordinates: half extents hl, hw, hh = 0.5 * (l, w, h),
//     corner k at (sx hl, sy hh, sz hw) with the decode's sign patterns,
//     x' = c x + s z, z' = c z - s x, plus the centre;
//   nms_score: the class score at the class argmax (the maximum logit).
//
// Exactness: every float operation is one IEEE rounding (__fmul_rn,
// __fadd_rn, __fsub_rn, and -fmad=false besides); fmodf is exact; the plain
// version writes the same operations as separate elementwise PyTorch ops in
// the same order, each of which rounds once on the CPU and on the card.
// sin and cos are written out (sincos_stated below, mirrored by
// models/decode.py::sincos_plain and a numpy transcription in
// tests/test_torch_decode.py): k = rint(x * f32(2/pi)), r = x - k pi/2 by a
// four-part Cody-Waite split whose first three parts have at most 11
// significant bits (k * part is exact for |k| < 2^12), Cephes' sinf/cosf
// minimax polynomials on [-pi/4, pi/4] in Horner form, and the pair swapped
// and negated by quadrant. Within 1.49 ulps of float64 on [0, 2 pi] (the
// test's dense grid and every float near the multiples of pi/2).
//
// What bounds it (NVIDIA H100 80GB HBM3): bytes. At B = 8, P = 256 it reads
// (B, P, 79) and (B, P, 3) floats and writes 24 + 8 floats and 2 ints a
// proposal: ~0.95 MB, ~0.28 us at 3.35 TB/s; its ~190 operations a
// proposal (chip_smoke.py DECODE_OPS) are ~0.4 M, far below. At 2048
// proposals it is a single wave of 16 blocks: launch-bound, a few us.
//
// Design: a block takes kThreads consecutive proposals, copies their rows
// into shared memory with coalesced loads (a row is C = 79 words: odd, so
// the threads' strided reads of their own rows hit distinct banks), and
// each thread decodes its proposal in registers and writes its corners as
// six 16-byte stores.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // proposals a block

// f32(pi / 2) in four parts: pi/2 - (p1 + p2 + p3 + p4) ~ 8e-20
constexpr float kPio2_1 = 0x1.92p+0f;        // 1.5703125
constexpr float kPio2_2 = 0x1.fb4p-12f;      // 4.837513e-4
constexpr float kPio2_3 = 0x1.444p-24f;      // 7.5495336e-8
constexpr float kPio2_4 = 0x1.68c234p-39f;   // 2.563344e-12
constexpr float kTwoOverPi = 0x1.45f306p-1f; // f32(2 / pi)
// Cephes sinf: -1.9515295891e-4, 8.3321608736e-3, -1.6666654611e-1
constexpr float kSin0 = -0x1.9943f2p-13f, kSin1 = 0x1.11073cp-7f, kSin2 = -0x1.555546p-3f;
// Cephes cosf: 2.443315711809948e-5, -1.388731625493765e-3, 4.166664568298827e-2
constexpr float kCos0 = 0x1.99eb9cp-16f, kCos1 = -0x1.6c0c34p-10f, kCos2 = 0x1.55554ap-5f;
constexpr float kTwoPi = 0x1.921fb6p+2f;     // f32(2 pi)
constexpr float kMinScale = 0x1.0c6f7ap-20f; // f32(1e-6)

__device__ __forceinline__ void sincos_stated(float x, float& sn, float& cs) {
  const float k = rintf(__fmul_rn(x, kTwoOverPi));
  float r = __fsub_rn(x, __fmul_rn(k, kPio2_1));
  r = __fsub_rn(r, __fmul_rn(k, kPio2_2));
  r = __fsub_rn(r, __fmul_rn(k, kPio2_3));
  r = __fsub_rn(r, __fmul_rn(k, kPio2_4));
  const float z = __fmul_rn(r, r);
  float p = __fadd_rn(__fmul_rn(z, kSin0), kSin1);
  p = __fadd_rn(__fmul_rn(p, z), kSin2);
  p = __fmul_rn(__fmul_rn(p, z), r);
  const float s = __fadd_rn(r, p);
  float q = __fadd_rn(__fmul_rn(z, kCos0), kCos1);
  q = __fadd_rn(__fmul_rn(q, z), kCos2);
  q = __fmul_rn(__fmul_rn(q, z), z);
  q = __fsub_rn(q, __fmul_rn(z, 0.5f));
  const float c = __fadd_rn(q, 1.0f);
  const int quad = __float2int_rz(k) & 3;
  const float a = (quad & 1) ? c : s;
  const float b = (quad & 1) ? s : c;
  sn = (quad & 2) ? -a : a;
  cs = ((quad + 1) & 2) ? -b : b;
}

// the first index of the maximum; a NaN is above every number
__device__ __forceinline__ int argmax_first(const float* v, int n) {
  int best = 0;
  float m = v[0];
  for (int k = 1; k < n; ++k) {
    const float x = v[k];
    if (x > m || (x != x && m == m)) {
      m = x;
      best = k;
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const float* __restrict__ out, const float* __restrict__ xyz,
                  const float* __restrict__ mean_size, int BP, int C, int NH, int NS, int NC,
                  float heading_scale, float* __restrict__ corners, float* __restrict__ center,
                  float* __restrict__ size, float* __restrict__ heading, float* __restrict__ nms_score,
                  int* __restrict__ size_cls, int* __restrict__ heading_cls) {
  extern __shared__ float rows[];  // kThreads rows of C channels
  const int p0 = blockIdx.x * kThreads;
  const int n = min(kThreads, BP - p0);
  const float* src = out + static_cast<size_t>(p0) * C;
  for (int k = threadIdx.x; k < n * C; k += kThreads) rows[k] = src[k];
  __syncthreads();
  if (threadIdx.x >= n) return;
  const int p = p0 + threadIdx.x;
  const float* o = rows + threadIdx.x * C;

  const int hc = argmax_first(o + 5, NH);
  const int sc = argmax_first(o + 5 + 2 * NH, NS);
  const int cc = argmax_first(o + C - NC, NC);
  float ctr[3], sz[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float v = __fadd_rn(1.0f, o[5 + 2 * NH + NS + 3 * sc + d]);
    v = v < kMinScale ? kMinScale : v;  // NaN stays NaN, as torch.clamp and jnp.maximum keep it
    sz[d] = __fmul_rn(mean_size[3 * sc + d], v);
    ctr[d] = __fadd_rn(xyz[3 * static_cast<size_t>(p) + d], o[2 + d]);
  }
  float h = __fadd_rn(__fmul_rn(static_cast<float>(hc), 2.0f), o[5 + NH + hc]);
  h = fmodf(__fmul_rn(h, heading_scale), kTwoPi);
  if (h < 0.0f) h = __fadd_rn(h, kTwoPi);

  float s, c;
  sincos_stated(h, s, c);
  const float hl = __fmul_rn(0.5f, sz[0]), hw = __fmul_rn(0.5f, sz[1]), hh = __fmul_rn(0.5f, sz[2]);
  float v[24];
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // the signs of models/decode.py::CORNER_SIGNS; corners 0-3 the top face
    const float x = (k & 2) ? -hl : hl;
    const float y = k < 4 ? hh : -hh;
    const float z = ((k + 1) & 2) ? -hw : hw;
    v[3 * k] = __fadd_rn(__fadd_rn(__fmul_rn(c, x), __fmul_rn(s, z)), ctr[0]);
    v[3 * k + 1] = __fadd_rn(y, ctr[1]);
    v[3 * k + 2] = __fadd_rn(__fsub_rn(__fmul_rn(c, z), __fmul_rn(s, x)), ctr[2]);
  }
  float4* dst = reinterpret_cast<float4*>(corners + 24 * static_cast<size_t>(p));
#pragma unroll
  for (int k = 0; k < 6; ++k) dst[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    center[3 * static_cast<size_t>(p) + d] = ctr[d];
    size[3 * static_cast<size_t>(p) + d] = sz[d];
  }
  heading[p] = h;
  nms_score[p] = o[C - NC + cc];
  size_cls[p] = sc;
  heading_cls[p] = hc;
}

}  // namespace

extern "C" {

// Launches the decode on `stream`: out (BP, C) and xyz (BP, 3) f32,
// contiguous; mean_size (NS, 3) f32; corners (BP, 24), center and size (BP,
// 3), heading and nms_score (BP) f32, size_cls and heading_cls (BP) int32.
// heading_scale is f32(pi / NH). Returns the cudaError_t of the launch.
int votenet_decode(const float* out, const float* xyz, const float* mean_size, int BP, int C, int NH, int NS,
                   int NC, float heading_scale, float* corners, float* center, float* size, float* heading,
                   float* nms_score, int* size_cls, int* heading_cls, void* stream) {
  if (BP < 1 || NH < 1 || NS < 1 || NC < 1 || C < 5 + 2 * NH + 4 * NS + NC) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kThreads) * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_kernel<<<(BP + kThreads - 1) / kThreads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      out, xyz, mean_size, BP, C, NH, NS, NC, heading_scale, corners, center, size, heading, nms_score, size_cls,
      heading_cls);
  return cudaGetLastError();
}

}  // extern "C"
