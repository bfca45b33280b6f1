// Multi-head softmax attention on Hopper (sm_90a), f32 on the CUDA cores:
// O_h = softmax(scale * Q_h K_h^T) V_h for every head h of every batch row,
// in one launch, with no score matrix in device memory.
//
// The port's own kernel: the JAX package has no attention (VoteNet has
// none). Group-Free 3D's transformer decoder (models/groupfree.py) calls it
// twice a layer: self-attention over its 256 queries and cross-attention
// from them to the 1024 seeds, 8 heads of 36 channels, at B = 64 in eval.
// The eager chain it replaces (ops/attention.py::multi_head_attention_plain:
// a batched product, softmax, a second product) writes the (B, H, Lq, Lk)
// scores to device memory and reads them back twice: 537 MB a
// cross-attention at B = 64.
//
// What bounds it (NVIDIA H100 80GB HBM3, TF32 off as the configuration
// states): operations. The two products are 4 Lq Lk D operations a head,
// 19.3 GFLOP a cross-attention at B = 64 (0.29 ms at 67 TFLOP/s), against
// 189 MB of Q, K, V and O (0.056 ms at 3.35 TB/s); the exponentials (Lq Lk
// a head) go to the SFU, under a tenth of the FMA pipe's time.
//
// Design (flash attention's online softmax, on FFMA):
// - A block takes 256 queries of one head of one batch row: 128 threads,
//   each holding kRows = 2 queries (pre-scaled) and their 2 x D running
//   outputs in registers, so that every value read from shared memory feeds
//   two FMAs.
// - Keys and values stream through shared memory in tiles of kTile = 64
//   rows, two buffers, filled by cp.async (16 bytes a copy, the rows past
//   Lk zero-filled) while the block computes on the other buffer.
// - A tile is taken in chunks of kChunk = 16 keys: each thread forms its
//   2 x 16 scores (the keys' rows read as float4 broadcasts, 16 x 2
//   independent sums), takes the chunk's maximum, rescales its running
//   sum and outputs by exp(m_old - m_new), adds exp(s - m_new) to the sum
//   and p * v to the outputs. Keys past Lk score -inf and weigh 0.
// - The outputs are divided by the sum once, at the end, and written as
//   float4 rows.
// Every product-sum is an explicit fmaf (the library builds with
// -fmad=false); exp is the accurate expf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 2;                      // queries a thread
constexpr int kQueries = kThreads * kRows;    // queries a block
constexpr int kTile = 64;                     // keys a shared-memory tile
constexpr int kChunk = 16;                    // keys an online-softmax step

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Strides {
  long long q_batch, q_row, k_batch, k_row, v_batch, v_row;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ o, int Lq, int Lk, int H, Strides st, float scale) {
  static_assert(D % 4 == 0, "rows are copied as float4");
  constexpr int kParts = D / 4;
  __shared__ __align__(16) float ks[2][kTile][D];
  __shared__ __align__(16) float vs[2][kTile][D];

  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * st.q_batch + h * D;
  const float* kb = k + b * st.k_batch + h * D;
  const float* vb = v + b * st.v_batch + h * D;
  const int E = H * D;

  auto load = [&](int buf, int k0) {
    for (int c = threadIdx.x; c < kTile * kParts; c += kThreads) {
      const int row = c / kParts, part = c - row * kParts;
      const int j = k0 + row;
      const bool in = j < Lk;
      const long long jj = in ? j : 0;
      cp_async16(&ks[buf][row][4 * part], kb + jj * st.k_row + 4 * part, in ? 16 : 0);
      cp_async16(&vs[buf][row][4 * part], vb + jj * st.v_row + 4 * part, in ? 16 : 0);
    }
    cp_async_commit();
  };

  const int ntiles = (Lk + kTile - 1) / kTile;
  load(0, 0);

  // the thread's queries, scaled once (rows past Lq read row Lq - 1 and are not written)
  float qr[kRows][D];
  int qi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    qi[r] = blockIdx.x * kQueries + r * kThreads + threadIdx.x;
    const float4* src = reinterpret_cast<const float4*>(qb + static_cast<long long>(min(qi[r], Lq - 1)) * st.q_row);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const float4 t = src[p];
      qr[r][4 * p + 0] = __fmul_rn(t.x, scale);
      qr[r][4 * p + 1] = __fmul_rn(t.y, scale);
      qr[r][4 * p + 2] = __fmul_rn(t.z, scale);
      qr[r][4 * p + 3] = __fmul_rn(t.w, scale);
    }
  }
  float acc[kRows][D];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[r][d] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load((t + 1) & 1, (t + 1) * kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*kt)[D] = ks[t & 1];
    const float(*vt)[D] = vs[t & 1];
    const int n = min(kTile, Lk - t * kTile);  // valid keys of the tile (uniform over the block)
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float s[kRows][kChunk];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kChunk; ++j) s[r][j] = 0.0f;
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(&kt[c0 + j][4 * p]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            s[r][j] = fmaf(qr[r][4 * p + 0], kv.x, s[r][j]);
            s[r][j] = fmaf(qr[r][4 * p + 1], kv.y, s[r][j]);
            s[r][j] = fmaf(qr[r][4 * p + 2], kv.z, s[r][j]);
            s[r][j] = fmaf(qr[r][4 * p + 3], kv.w, s[r][j]);
          }
        }
      }
      const int valid = n - c0;  // keys of the chunk before Lk (>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float cmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (j >= valid) s[r][j] = -INFINITY;
          cmax = fmaxf(cmax, s[r][j]);
        }
        const float mn = fmaxf(m[r], cmax);
        const float alpha = expf(m[r] - mn);  // 0 on the first chunk (m = -inf)
        m[r] = mn;
        float sum = __fmul_rn(l[r], alpha);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          s[r][j] = expf(s[r][j] - mn);
          sum = __fadd_rn(sum, s[r][j]);
        }
        l[r] = sum;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[r][d] = __fmul_rn(acc[r][d], alpha);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          const float4 vv = *reinterpret_cast<const float4*>(&vt[c0 + j][4 * p]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][4 * p + 0] = fmaf(s[r][j], vv.x, acc[r][4 * p + 0]);
            acc[r][4 * p + 1] = fmaf(s[r][j], vv.y, acc[r][4 * p + 1]);
            acc[r][4 * p + 2] = fmaf(s[r][j], vv.z, acc[r][4 * p + 2]);
            acc[r][4 * p + 3] = fmaf(s[r][j], vv.w, acc[r][4 * p + 3]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled by the next iteration's load
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (qi[r] >= Lq) continue;
    float4* dst = reinterpret_cast<float4*>(o + (static_cast<long long>(b) * Lq + qi[r]) * E + h * D);
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      dst[p] = make_float4(__fdiv_rn(acc[r][4 * p + 0], l[r]), __fdiv_rn(acc[r][4 * p + 1], l[r]),
                           __fdiv_rn(acc[r][4 * p + 2], l[r]), __fdiv_rn(acc[r][4 * p + 3], l[r]));
  }
}

}  // namespace

extern "C" {

// Launches the attention on `stream`: q (B, Lq, H * 36), k and v (B, Lk,
// H * 36) f32 with the last dimension contiguous, 16-byte aligned, every
// stride (in elements) a multiple of 4; o (B, Lq, H * 36) f32, contiguous.
// scale multiplies q. Returns the cudaError_t of the launch.
int votenet_attention(const float* q, const float* k, const float* v, float* o, int B, int Lq, int Lk, int H,
                      int D, long long q_batch, long long q_row, long long k_batch, long long k_row,
                      long long v_batch, long long v_row, float scale, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D != 36 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const dim3 grid((Lq + kQueries - 1) / kQueries, H, B);
  attention_f32_kernel<36><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, Lq, Lk, H, Strides{q_batch, q_row, k_batch, k_row, v_batch, v_row}, scale);
  return cudaGetLastError();
}

}  // extern "C"
