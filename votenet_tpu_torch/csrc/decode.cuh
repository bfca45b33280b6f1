// The detection head's decode, one proposal at a time: the stated order of
// every float operation, included by the decode kernel (csrc/decode.cu) and
// by the fused decode + IoU self-matrix kernel (csrc/iou3d.cu), so that both
// compute the floats of models/decode.py::decode_proposals_plain.
//
// What it computes, for proposal p of the head's output (C channels:
// objectness 0-1, centre offset 2-4, NH heading scores, NH heading
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

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

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


// A proposal's box before its corners: the centre, the size, the heading,
// its sin and cos and the half extents
struct Pose {
  float center[3], size[3];
  float heading, s, c, hl, hw, hh;
};

// The pose of the proposal with head channels o (C floats), centre xyz (3)
// and classes hc, sc; mean_size (NS, 3); heading_scale is f32(pi / NH)
__device__ __forceinline__ void decode_pose(const float* o, const float* __restrict__ xyz,
                                            const float* __restrict__ mean_size, int NH, int NS, int hc, int sc,
                                            float heading_scale, Pose& p) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = __fadd_rn(1.0f, o[5 + 2 * NH + NS + 3 * sc + k]);
    v = v < kMinScale ? kMinScale : v;  // NaN stays NaN, as torch.clamp and jnp.maximum keep it
    p.size[k] = __fmul_rn(mean_size[3 * sc + k], v);
    p.center[k] = __fadd_rn(xyz[k], o[2 + k]);
  }
  float h = __fadd_rn(__fmul_rn(static_cast<float>(hc), 2.0f), o[5 + NH + hc]);
  h = fmodf(__fmul_rn(h, heading_scale), kTwoPi);
  if (h < 0.0f) h = __fadd_rn(h, kTwoPi);
  p.heading = h;
  sincos_stated(h, p.s, p.c);
  p.hl = __fmul_rn(0.5f, p.size[0]);
  p.hw = __fmul_rn(0.5f, p.size[1]);
  p.hh = __fmul_rn(0.5f, p.size[2]);
}

// Corner k of the pose (x, y, z): the signs of models/decode.py::
// CORNER_SIGNS, corners 0-3 the top face
__device__ __forceinline__ void decode_corner(const Pose& p, int k, float* v) {
  const float x = (k & 2) ? -p.hl : p.hl;
  const float y = k < 4 ? p.hh : -p.hh;
  const float z = ((k + 1) & 2) ? -p.hw : p.hw;
  v[0] = __fadd_rn(__fadd_rn(__fmul_rn(p.c, x), __fmul_rn(p.s, z)), p.center[0]);
  v[1] = __fadd_rn(y, p.center[1]);
  v[2] = __fadd_rn(__fsub_rn(__fmul_rn(p.c, z), __fmul_rn(p.s, x)), p.center[2]);
}

// One proposal's decoded fields
struct Decoded {
  float corners[24];  // 8 corners x (x, y, z); corners 0-3 the top face
  float center[3], size[3];
  float heading, nms_score;
  int size_cls, heading_cls;
};

// The decode of one proposal by one thread: o its C head channels, xyz its
// centre (3), mean_size (NS, 3); heading_scale is f32(pi / NH)
__device__ __forceinline__ void decode_proposal(const float* o, const float* __restrict__ xyz,
                                                const float* __restrict__ mean_size, int C, int NH, int NS, int NC,
                                                float heading_scale, Decoded& d) {
  const int hc = argmax_first(o + 5, NH);
  const int sc = argmax_first(o + 5 + 2 * NH, NS);
  const int cc = argmax_first(o + C - NC, NC);
  Pose p;
  decode_pose(o, xyz, mean_size, NH, NS, hc, sc, heading_scale, p);
#pragma unroll
  for (int k = 0; k < 8; ++k) decode_corner(p, k, d.corners + 3 * k);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d.center[k] = p.center[k];
    d.size[k] = p.size[k];
  }
  d.heading = p.heading;
  d.nms_score = o[C - NC + cc];
  d.size_cls = sc;
  d.heading_cls = hc;
}

// Where the decode's seven outputs go, each indexed by the proposal's flat
// index p: corners (BP, 24), center and size (BP, 3), heading and
// nms_score (BP) f32, size_cls and heading_cls (BP) int32
struct DecodeOut {
  float* __restrict__ corners;
  float* __restrict__ center;
  float* __restrict__ size;
  float* __restrict__ heading;
  float* __restrict__ nms_score;
  int* __restrict__ size_cls;
  int* __restrict__ heading_cls;
};

__device__ __forceinline__ void write_decoded(const DecodeOut& out, size_t p, const Decoded& d) {
  float4* dst = reinterpret_cast<float4*>(out.corners + 24 * p);
#pragma unroll
  for (int k = 0; k < 6; ++k)
    dst[k] = make_float4(d.corners[4 * k], d.corners[4 * k + 1], d.corners[4 * k + 2], d.corners[4 * k + 3]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out.center[3 * p + k] = d.center[k];
    out.size[3 * p + k] = d.size[k];
  }
  out.heading[p] = d.heading;
  out.nms_score[p] = d.nms_score;
  out.size_cls[p] = d.size_cls;
  out.heading_cls[p] = d.heading_cls;
}

// The decode's launch checks: the channel layout fits NH, NS, NC
__host__ __forceinline__ bool decode_shape_ok(int C, int NH, int NS, int NC) {
  return NH >= 1 && NS >= 1 && NC >= 1 && C >= 5 + 2 * NH + 4 * NS + NC;
}

}  // namespace
