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
// What it computes and in which order: csrc/decode.cuh (decode_proposal),
// shared with the fused decode + IoU kernel of csrc/iou3d.cu, which the
// detection head runs (models/decode.py::predict_boxes); this kernel is
// the decode alone (models/decode.py::decode_proposals).
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

#include "decode.cuh"

namespace {

constexpr int kThreads = 128;  // proposals a block

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const float* __restrict__ out, const float* __restrict__ xyz,
                  const float* __restrict__ mean_size, int BP, int C, int NH, int NS, int NC,
                  float heading_scale, DecodeOut dout) {
  extern __shared__ float rows[];  // kThreads rows of C channels
  const int p0 = blockIdx.x * kThreads;
  const int n = min(kThreads, BP - p0);
  const float* src = out + static_cast<size_t>(p0) * C;
  for (int k = threadIdx.x; k < n * C; k += kThreads) rows[k] = src[k];
  __syncthreads();
  if (threadIdx.x >= n) return;
  const int p = p0 + threadIdx.x;
  Decoded d;
  decode_proposal(rows + threadIdx.x * C, xyz + 3 * static_cast<size_t>(p), mean_size, C, NH, NS, NC,
                  heading_scale, d);
  write_decoded(dout, p, d);
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
  if (BP < 1 || !decode_shape_ok(C, NH, NS, NC)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kThreads) * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_kernel<<<(BP + kThreads - 1) / kThreads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      out, xyz, mean_size, BP, C, NH, NS, NC, heading_scale,
      DecodeOut{corners, center, size, heading, nms_score, size_cls, heading_cls});
  return cudaGetLastError();
}

}  // extern "C"
