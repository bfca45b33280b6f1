// cast_bf16_multi on Hopper (sm_90a): one launch casts a table of f32
// tensors to bf16 (round to nearest even), or of bf16 tensors to f32
// (exact), each entry a 2-d strided view.
//
// The port's own kernel: the JAX package declares the same roundings
// (flax's promote_dtype casts a Dense layer's f32 kernel and bias to the
// layer's dtype at every call, votenet_tpu/models/pointnet2.py:95-99), and
// on the TPU XLA fuses the convert into the dot; it reaches no Pallas
// kernel. Here the bf16 copies of the dense layers' weights are refreshed
// once a parameter version (models/bf16_copies.py): all the stale copies in
// one launch, and in training the copies' bf16 gradients cast into the f32
// parameters' gradients in one launch of the other direction.
//
// The table travels by value as the kernel's parameter (kMaxEntries entries
// of 40 bytes, under the 4 KB a kernel parameter may take), as a
// multi-tensor apply passes its pointers: nothing is copied to the device
// before the launch. Block (x, y) takes entry y's elements x * kThreads +
// threadIdx.x, + gridDim.x * kThreads, ...: each element its (row, column),
// read through the source's strides and written through the destination's.
// An entry with a null source writes zeros.
//
// Rounding: __float2bfloat16_rn (cvt.rn.bf16.f32), the conversion torch's
// CUDA .to(torch.bfloat16) runs on sm_80 and later (c10::BFloat16), NaN
// bits included (cvt gives the canonical NaN 0x7fff; torch's CPU cast gives
// 0x7fc0, so a NaN's bits differ between the devices, never its being a
// NaN). bf16 -> f32 is the 16-bit shift: exact, a NaN's payload kept.
//
// What bounds it (NVIDIA H100 80GB HBM3): bytes, 6 an element (4 read and
// 2 written, or the reverse): 5.7 MB for the 0.94M weights of a full-width
// bf16 VoteNet's 27 copies, 1.7 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEntries = 64;  // ops/cuda/cast.py CAST_MAX_ENTRIES

// One view: rows x cols elements, strides in elements
struct CastEntry {
  const void* src;  // null: zeros
  void* dst;
  int rows, cols;
  int src_row, src_col, dst_row, dst_col;
};

struct CastTable {
  CastEntry e[kMaxEntries];
};

template <bool TO_BF16>
__global__ void __launch_bounds__(kThreads) cast_multi_kernel(const __grid_constant__ CastTable t) {
  const CastEntry& e = t.e[blockIdx.y];
  const int64_t n = static_cast<int64_t>(e.rows) * e.cols;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = i / e.cols, c = i - r * e.cols;
    const int64_t d = r * e.dst_row + c * e.dst_col;
    const int64_t s = r * e.src_row + c * e.src_col;
    if constexpr (TO_BF16) {
      const float v = e.src != nullptr ? static_cast<const float*>(e.src)[s] : 0.0f;
      static_cast<__nv_bfloat16*>(e.dst)[d] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(e.dst)[d] =
          e.src != nullptr ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.src)[s]) : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// entries: n (<= kMaxEntries) CastEntry records in host memory; to_bf16: 1
// f32 -> bf16, 0 bf16 -> f32; blocks: the grid's x (each entry's CTAs).
// Returns the launch's CUDA error (0).
int votenet_cast_bf16_multi(const void* entries, int n, int to_bf16, int blocks, void* stream) {
  if (n <= 0 || n > kMaxEntries || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CastTable t;
  std::memset(&t, 0, sizeof(t));
  std::memcpy(t.e, entries, sizeof(CastEntry) * n);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (to_bf16) {
    cast_multi_kernel<true><<<grid, kThreads, 0, cs>>>(t);
  } else {
    cast_multi_kernel<false><<<grid, kThreads, 0, cs>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

// sizeof(CastEntry), for the caller's check of its record layout
int votenet_cast_entry_bytes() { return static_cast<int>(sizeof(CastEntry)); }

}  // extern "C"
