// Fused set-abstraction MLP + max-pool (eval) on Hopper (sm_90a): two
// kernels, one for f32 operands on the tensor cores in 3xTF32
// (samlp_kernel), one for bf16 operands (samlp_bf16_kernel).
//
// Replaces the Pallas TPU kernel votenet_tpu/ops/pallas/samlp.py:78
// `_samlp_kernel` (wrapper `fused_sa_mlp_pool`, :100), which the JAX package
// runs from votenet_tpu/models/pointnet2.py:282-350 `_fused_eval_mlp_pool`
// when Config.samlp == "on": every eval-mode SA layer (sa1-sa4 and the
// proposal layer) after its ball query.
//
// What it computes, per batch row b and centre m, with eval batch norm and
// the dense biases already folded into per-channel scale/shift vectors by the
// caller (ops/cuda/samlp.py, models/pointnet2.py):
//   x[s, c]  = relu(h_all[b, idx[b, m, s], c] * s0[c] + sh0[b, m, c])
//   x[s, :]  = relu((x[s, :] @ W_i) * scale_i + shift_i)   for each later layer
//   out[b, m, :] = max over the S ball slots s of x[s, :]
// The kernels take the ungathered h_all and the indices and gather as their
// first load, so the (B, M, S, w0) tensor never reaches device memory (268
// MB at sa1, B=8, against 42 MB of h_all, which stays in the 50 MB L2). An
// index outside [0, N) gathers a row of zeros.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; the rates
// and sizes here are the data sheet's): multiply-adds. The five calls of a
// full-width forward at B=8 do 62.3 G of them. On the CUDA cores in f32 that is 1.9 ms
// at 67 TFLOP/s; here they run on the tensor cores in 3xTF32, three TF32
// products per f32 product, 3 x 124.6 GFLOP at 495 TFLOP/s: 0.76 ms. The
// bytes (h_all, idx, sh0, the pooled output, the weights) are a few hundred
// MB, ~0.1 ms at 3.35 TB/s. In bf16 the products take 126 us at 989
// TFLOP/s, and the gather of ~800 MB of f32 rows from L2 comes near them.
//
// 3xTF32: each f32 operand x is split as big = tf32(x) and small =
// tf32(x - big) (cvt.rna.tf32.f32: round to nearest, ties away, as the
// tensor core takes 10 mantissa bits), and x*y is taken as small*big +
// big*small + big*big into an f32 accumulator: the dropped small*small term
// is ~2^-22 of the product, so the chain stays within ~1e-6 of the f32
// result where one TF32 product (~1e-3) would not. The affine steps and the
// ReLU stay f32 with __fmul_rn/__fadd_rn (-fmad=false does not touch wgmma).
//
// Design of samlp_kernel (3xTF32). A block is one producer warpgroup and two
// consumer warpgroups, persistent over the grid's work; setmaxnreg moves
// registers from the producer (40 a thread) to the consumers (232), whose
// accumulators take up to 128. A consumer owns 64 rows (ball slots) at a
// time, one wgmma M tile: one centre when S = 64 (every S of the default
// configuration), 64 / S centres for a smaller S (rows past the last whole
// centre masked), and ceil(S / 64) tiles in turn for S > 64.
// - Activations never leave registers and shared memory. A thread's
//   accumulator fragment (rows g and g+8 of its warp's 16, columns 2t and
//   2t+1 of every 8) is reused as its A fragment of the next layer (rows g
//   and g+8, k-positions t and t+4 of every 8): the k order is permuted
//   within each group of 8, k-position p holding channel 2p (p < 4) or
//   2(p-4)+1, and the weights are laid out in the same order. A thread parks
//   its fragments in shared-memory slots that only it touches (16 bytes a
//   k8 step, conflict free) and loads them back one K slice at a time, split
//   into big and small, as wgmma's register A operand. No barrier between
//   the layers of a tile.
// - Layer 0 gathers each thread's own rows of h_all straight into those
//   fragments (8-byte loads, L2 hits, kGatherSteps k8 steps in flight), with
//   the scale, shift and ReLU.
// - Weights: the wrapper passes each layer's W as (w_out, w_in) (K-major,
//   which TF32 wgmma needs for both operands); a prologue kernel splits it
//   into big and small once per call, in the permuted k order and in wgmma's
//   no-swizzle K-major core-matrix layout (8 rows x 16 bytes a core matrix),
//   K slice by K slice. One producer thread streams the slices (32 channels
//   of K, both terms, up to 64 KB; 16 channels where the shared memory would
//   not hold two such stages) through a ring of stages with cp.async.bulk on
//   mbarriers; both consumers read each stage, so the weights cross L2 once
//   per 128 rows. sa2-sa4's second layer (128 x 256, 256 KB with both terms)
//   is never held whole. A consumer waits for each slice's products before
//   it releases the stage: a software-pipelined loop (two register sets of
//   fragments) made ptxas put a warpgroup.arrive before every wgmma and ran
//   slower.
// - Epilogue: scale, shift and ReLU (the vectors staged in shared memory) on
//   the accumulator, parked as the next layer's A fragments. The last layer
//   is pooled straight from the registers (pool_tile, which the bf16 kernel
//   shares). Where a warp's 16 rows belong to
//   one centre (S a multiple of 16, or S > 64) the lanes reduce over the
//   rows by a reduce-scatter of shuffles (each lane ends with the warp's
//   maxima of distinct columns) and fold them into the centre's pooled row in
//   shared memory; where only blocks of 8 rows do (S a multiple of 8), by
//   plain shuffles; otherwise every lane folds its own rows. Pooled values
//   are ReLU outputs, >= 0, which order as their bit patterns do, so the fold
//   is an integer atomicMax.
// Widths: each layer's output is padded to 32, 64, 128 or 256 columns (the
// wgmma N; zero weights, scale and shift past the width), and its input K to
// a multiple of kKS; every width may be at most 256. Offsets into h_all,
// idx, sh0 and out are 64-bit.
//
// bf16 operands (samlp_bf16_kernel): the TPU kernel's precision="bf16"
// (samlp.py:87-94): before each dense layer the f32 activations and the
// weights are rounded to bf16 (round to nearest even, as astype(bfloat16):
// cvt.rn.bf16x2.f32 on the A fragments, __float2bfloat16_rn in the weight
// prologue, samlp_round_weights) and multiplied with f32 accumulation, one
// k16 bf16 wgmma where 3xTF32 takes three k8 TF32 ones. Layer 0's affine +
// ReLU, every epilogue and the pooling stay f32, as in the TPU kernel. Its
// products are a sixth of 3xTF32's time, so what surrounds them sets its
// pace, and its design is its own:
// - Activations in registers as packed bf16. The accumulator fragment of
//   columns 8j + 2t, 8j + 2t + 1 (rows g and g+8) is wgmma's bf16 A fragment
//   of k-positions 2t, 2t + 1 (j even) or 2t + 8, 2t + 9 (j odd) of k16 step
//   j / 2, so each epilogue's affine + ReLU is rounded straight into the next
//   layer's A registers, one cvt.rn.bf16x2.f32 a pair, in the natural k
//   order (register a[2j] rows g, a[2j + 1] rows g+8). Nothing is parked in
//   shared memory. A layer reads up to 64 A registers (K = 256) and writes
//   the next layer's 64 (zeros past its width, so no earlier value stays
//   live across the layers' run-time dispatch); its products run in chunks
//   of at most kChunk = 128 columns, 64 accumulators a thread: with 128 and
//   the A registers live together ptxas spilled them and serialized every
//   wgmma.
// - Resident weights. The whole bf16 chain (sa1 24 KB, sa2-sa4 96 KB, the
//   proposal layer 64 KB) is copied into shared memory once per block by
//   one bulk-copy group on an mbarrier, in samlp_round_weights' layout. A
//   chunk's K steps are issued back to back from it and committed once: one
//   wait a chunk. The two consumers are staggered (ping-pong, named
//   barriers 3 and 4): one issues its products while the other runs its
//   epilogue, pooling or next tile's fragments, and they take turns.
//   Where the chain does not fit beside the tiles (ops/cuda/samlp.py
//   samlp_plan decides from the shapes; a caller can force either route),
//   the second route streams each chunk's K slices through a ring of
//   stages as the 3xTF32 kernel does: each slice a commit group, a stage
//   released when the next slice's products are issued (wait_group 1), no
//   ping-pong.
// - The gather off the consumers' path. The producer warpgroup (on the ring
//   route warps 1-3; warp 0's first lane streams the weights) stages the
//   tiles into a ring of 2-8 slots (as many as the shared memory holds), in
//   the order the consumers take them, both consumers' tiles of a step in
//   one pass: a tile's 64 rows of h_all and its T rows of sh0, one bulk
//   copy (TMA) a row, a row outside the data (an index outside [0, N), a
//   row past the tile's centres) copied from a row of zeros after the
//   chain in the weights' scratch; cp.async of 8 or 4 bytes where a row or
//   an address is not a multiple of 16 bytes (cp.async through L1 moved
//   about 1 TB/s of rows on an H100). Rows of K0 + 8 floats, 8 banks apart:
//   a warp's float2 reads take the two wavefronts they must. The index rows
//   come kIdxAhead steps ahead by cp.async. A consumer frees its slot once
//   the tile is in its registers. Columns past w0 and the sh0 row T (the
//   rows past the last whole centre) stay zero.
// - The last layer's pool (pool_rows_once, where a warp's 16 rows share a
//   centre) takes the max of the accumulators, sign-flipped by the scale's
//   sign, and applies the affine + ReLU once a column: the steps are
//   monotone, so the bits are those of the max of the ReLU outputs.
// - The f32 sums run in the same k order as the 3xTF32 kernel's ring of
//   k16 steps, so both routes give the same bits.
// What bounds it (chip_smoke.py --samlp-ablation takes the gather, the
// products and the epilogues out in turn) is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kConsumerWGs = 2;              // consumer warpgroups of a block
constexpr int kThreads = 128 * (1 + kConsumerWGs);  // + the producer warpgroup
// registers a thread keeps after setmaxnreg: the producer gives up what the
// consumers' accumulators (up to 128 a thread) need; 64K a block in all
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 128 * kConsumerWGs * kConsumerRegs <= 65536, "register file");
constexpr int kRows = 64;                    // rows of a wgmma M tile
constexpr int kMaxLayers = 8;                // dense layers after layer 0, at most
constexpr int kMaxStages = 4;                // weight-ring stages, at most

struct Chain {
  const float* scale[kMaxLayers];  // (width[l+1],)
  const float* shift[kMaxLayers];  // (width[l+1],)
  long long woff[kMaxLayers];      // layer l's first slice in the split weights (bytes)
  int width[kMaxLayers + 1];       // w0, then each layer's output width
  int npad[kMaxLayers];            // layer l's wgmma N: 32, 64, 128 or 256
  int kpad[kMaxLayers];            // layer l's K, a multiple of the slice's ks
  int n;                           // dense layers after layer 0
};

__device__ __forceinline__ float relu(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ float affine_relu(float x, float s, float t) {
  return relu(__fadd_rn(__fmul_rn(x, s), t));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// round to TF32 (10 mantissa bits), nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

// two values rounded to bf16 (nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

// ---- mbarriers, the bulk copy (TMA), cp.async and named barriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// CH bytes from global to shared memory; the bytes past src_bytes (all of
// them when it is 0) are zeros
template <int CH>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(CH), "r"(src_bytes)
               : "memory");
}
// an arrival on `bar` once the thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major B operand without swizzle: core matrices of 8 rows
// x 16 bytes, the next along K 128 bytes on (LBO), the next 8 rows `sbo`
// bytes on (SBO).
__device__ __forceinline__ uint64_t bdesc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The accumulator registers of a wgmma of width N (N / 2 a thread): the
// "%i" list of the instruction and the "+f" operands.
#define SAMLP_R32 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define SAMLP_R64 SAMLP_R32 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SAMLP_R128 SAMLP_R64 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SAMLP_R256 SAMLP_R128 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define SAMLP_D32 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SAMLP_D64 SAMLP_D32, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SAMLP_D128 SAMLP_D64, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SAMLP_D256 SAMLP_D128, "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// D (64 x N, f32) += A (64 x 8, TF32, registers) * B (8 x N, TF32, shared
// memory, K-major). A's fragment of the warp's 16 rows: a[0] (row g, k t),
// a[1] (row g+8, k t), a[2] (row g, k t+4), a[3] (row g+8, k t+4).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" SAMLP_R32 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : SAMLP_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" SAMLP_R64 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SAMLP_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" SAMLP_R128 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SAMLP_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {" SAMLP_R256 "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : SAMLP_D256
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x N, f32) = A (64 x 16, bf16, registers) * B (16 x N, bf16, shared
// memory, K-major) + (acc ? D : 0). A's fragment of the warp's 16 rows, two
// values a register, the lower k in the low half: a0 (row g, k 2t and
// 2t+1), a1 (row g+8, the same), a2 (row g, k 2t+8 and 2t+9), a3 (row g+8,
// the same). The last immediate, 0, says B is K-major.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" SAMLP_R32 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : SAMLP_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SAMLP_R64 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SAMLP_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SAMLP_R128 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : SAMLP_D128
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" SAMLP_R256 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : SAMLP_D256
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

// Where a thread's two rows (g and g+8 of its warp's 16) sit in the work.
struct Rows {
  int cl[2];       // centre within the tile's pooled rows
  bool ok[2];      // a real (centre, slot)
  bool blk_ok[2];  // the row's block of 8 may fold into the pooled rows
};

// What a consumer warpgroup's layers share.
struct Ctx {
  float4* afrag;       // the warpgroup's A-fragment slots: [k8 step][thread] (3xTF32 only)
  int t;               // thread within the warpgroup
  const uint8_t* ring;
  int stage_bytes, stages;
  uint64_t* full;
  uint64_t* empty;
  int* pooled;         // the warpgroup's pooled rows, T x pool_ld
  int pool_ld;
  bool grp8, grp16;    // 8 (16) consecutive rows from a multiple of 8 (16) share a centre
};

// The thread's rows of a tile (r0 and r0 + 8 of its 64, in tile j of the
// item's R): centre, and whether each is a real slot and may fold.
__device__ __forceinline__ Rows tile_rows(int r0, int S, int T, int M, int it, int j, bool live) {
  Rows rows;
  const bool wide = S > kRows;
  const int used = wide ? kRows : T * S;  // rows of a tile that hold slots
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int cl = wide ? 0 : r / S;
    const int centre = wide ? it : it * T + cl;
    const int slot = wide ? j * kRows + r : r - cl * S;
    rows.cl[h] = cl;
    rows.ok[h] = live && r < used && centre < M && slot < S;
    rows.blk_ok[h] = (r & ~7) < used;
  }
  return rows;
}

__device__ __forceinline__ void fold(int* p, float v) { atomicMax(p, __float_as_int(v)); }

// The last layer's epilogue: scale, shift and ReLU on the accumulator of N
// columns from col0, and the max over the tile's rows folded into the
// pooled rows. sc, sf: the layer's scale and shift at col0 (zero past its
// width), in shared memory.
template <int N>
__device__ __forceinline__ void pool_tile(const Ctx& cx, const float (&acc)[N / 2], const float* sc,
                                          const float* sf, const Rows& rows, int col0) {
  const int lane = cx.t & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  if (cx.grp16) {
    // Rows g and g+8, and all 16 rows of the warp, belong to one centre: the
    // max over the warp's 8 row pairs (lanes g = 0..7, lane bits 2-4) of
    // each of the thread's columns, as a reduce-scatter over CJ groups of 8
    // columns at a time: at each of three steps a lane sends the half of its
    // columns that its partner keeps, so the shuffles halve from step to step
    // (7/4 a group, not 6), and each lane ends with the warp's maxima of
    // CJ/4 distinct columns, which it folds into the pooled row.
    constexpr int CJ = N / 8 < 8 ? N / 8 : 8;
    const int b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1, b4 = (lane >> 4) & 1;
    int* const prow = cx.pooled + rows.cl[0] * cx.pool_ld + col0;
#pragma unroll
    for (int q = 0; q < N / 8 / CJ; ++q) {
      float a[CJ];
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {  // keep column 8j + 2t + b2
        const int j = q * CJ + jj;
        const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * tig);
        const float2 f = *reinterpret_cast<const float2*>(sf + 8 * j + 2 * tig);
        float m0 = fmaxf(rows.ok[0] ? affine_relu(acc[4 * j], s.x, f.x) : 0.0f,
                         rows.ok[1] ? affine_relu(acc[4 * j + 2], s.x, f.x) : 0.0f);
        float m1 = fmaxf(rows.ok[0] ? affine_relu(acc[4 * j + 1], s.y, f.y) : 0.0f,
                         rows.ok[1] ? affine_relu(acc[4 * j + 3], s.y, f.y) : 0.0f);
        a[jj] = fmaxf(b2 ? m1 : m0, __shfl_xor_sync(0xffffffffu, b2 ? m0 : m1, 4));
      }
      float c[CJ / 2];
#pragma unroll
      for (int i = 0; i < CJ / 2; ++i) {  // keep jj = 2i + b3
        c[i] = fmaxf(b3 ? a[2 * i + 1] : a[2 * i], __shfl_xor_sync(0xffffffffu, b3 ? a[2 * i] : a[2 * i + 1], 8));
      }
#pragma unroll
      for (int k = 0; k < CJ / 4; ++k) {  // keep i = 2k + b4: jj = 4k + 2 b4 + b3
        const float d = fmaxf(b4 ? c[2 * k + 1] : c[2 * k], __shfl_xor_sync(0xffffffffu, b4 ? c[2 * k] : c[2 * k + 1], 16));
        if (rows.blk_ok[0]) fold(prow + 8 * (q * CJ + 4 * k + 2 * b4 + b3) + 2 * tig + b2, d);
      }
    }
    return;
  }

#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c0 = 8 * j + 2 * tig;
    const int c1 = c0 + 1;
    const float2 s = *reinterpret_cast<const float2*>(sc + c0);
    const float2 f = *reinterpret_cast<const float2*>(sf + c0);
    float v00 = affine_relu(acc[4 * j], s.x, f.x);      // row g, column c0
    float v01 = affine_relu(acc[4 * j + 1], s.y, f.y);  // row g, column c1
    float v10 = affine_relu(acc[4 * j + 2], s.x, f.x);  // row g+8, column c0
    float v11 = affine_relu(acc[4 * j + 3], s.y, f.y);  // row g+8, column c1
    if (!rows.ok[0]) v00 = v01 = 0.0f;  // 0 folds into a max of ReLU outputs as nothing
    if (!rows.ok[1]) v10 = v11 = 0.0f;
    int* const p0 = cx.pooled + rows.cl[0] * cx.pool_ld + col0;
    int* const p1 = cx.pooled + rows.cl[1] * cx.pool_ld + col0;
    if (cx.grp8) {  // each block of 8 rows: one centre
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        v00 = fmaxf(v00, __shfl_xor_sync(0xffffffffu, v00, o));
        v01 = fmaxf(v01, __shfl_xor_sync(0xffffffffu, v01, o));
        v10 = fmaxf(v10, __shfl_xor_sync(0xffffffffu, v10, o));
        v11 = fmaxf(v11, __shfl_xor_sync(0xffffffffu, v11, o));
      }
      if (g == 0 && rows.blk_ok[0]) {
        fold(p0 + c0, v00);
        fold(p0 + c1, v01);
      }
      if (g == 0 && rows.blk_ok[1]) {
        fold(p1 + c0, v10);
        fold(p1 + c1, v11);
      }
    } else {  // any S: every lane folds its own rows
      if (rows.ok[0]) {
        fold(p0 + c0, v00);
        fold(p0 + c1, v01);
      }
      if (rows.ok[1]) {
        fold(p1 + c0, v10);
        fold(p1 + c1, v11);
      }
    }
  }
}

// The item's centres are pooled: write them out, zero the pooled rows.
__device__ __forceinline__ void write_pooled(const Ctx& cx, int cw, int T, int wl, int S, int M, int it,
                                             size_t bm, bool live, float* __restrict__ out) {
  const bool wide = S > kRows;
  wg_barrier(cw);
  for (int i = cx.t; i < T * wl; i += 128) {
    const int cl = i / wl;
    const int c = i - cl * wl;
    const int centre = wide ? it : it * T + cl;
    if (live && centre < M) out[(bm + centre) * wl + c] = __int_as_float(cx.pooled[cl * cx.pool_ld + c]);
    cx.pooled[cl * cx.pool_ld + c] = 0;
  }
  wg_barrier(cw);
}

// ---- samlp_kernel: 3xTF32 ----

// One dense layer of a tile: acc = A @ W over the K slices of the ring (KB
// wgmma k8 steps a slice), then the epilogue: parked as the next layer's A
// fragments, or pooled (last). aff: the layer's scale (N floats, zero past
// its width) then shift, in shared memory.
template <int N, int KB>
__device__ __forceinline__ void dense_layer(const Ctx& cx, int kpad, const float* aff, bool last,
                                            const Rows& rows, int& stage, int& phase) {
  // a K step is two core matrices (256 bytes), so a slice's 8-row groups
  // lie KB * 256 bytes apart
  constexpr uint32_t kSbo = KB * 2 * 128;  // bytes from one 8-row core-matrix group to the next
  const int lane = cx.t & 31;
  const int tig = lane & 3;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < kpad; k0 += 8 * KB) {
    uint32_t big[KB][4];
    uint32_t small[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 f = cx.afrag[(k0 / 8 + kk) * 128 + cx.t];
      const float x[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        big[kk][i] = tf32_rna(x[i]);
        small[kk][i] = tf32_rna(__fsub_rn(x[i], __uint_as_float(big[kk][i])));
      }
    }
    mbar_wait(&cx.full[stage], phase);
    const uint32_t base = smem_u32(cx.ring + stage * cx.stage_bytes);
    const uint32_t sbase = base + N * KB * 8 * 4;  // the small term follows the big one
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {  // the small products first, then big * big
      wgmma_tf32<N>(acc, small[kk], bdesc(base + kk * 256, kSbo));
      wgmma_tf32<N>(acc, big[kk], bdesc(sbase + kk * 256, kSbo));
      wgmma_tf32<N>(acc, big[kk], bdesc(base + kk * 256, kSbo));
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait0();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&cx.empty[stage]);  // this warp is done with the stage
    if (++stage == cx.stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (last) {
    pool_tile<N>(cx, acc, aff, aff + N, rows, 0);
    return;
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c0 = 8 * j + 2 * tig;
    const float2 sc = *reinterpret_cast<const float2*>(aff + c0);
    const float2 sf = *reinterpret_cast<const float2*>(aff + N + c0);
    const float v00 = affine_relu(acc[4 * j], sc.x, sf.x);      // row g, column c0
    const float v01 = affine_relu(acc[4 * j + 1], sc.y, sf.y);  // row g, column c0 + 1
    const float v10 = affine_relu(acc[4 * j + 2], sc.x, sf.x);  // row g+8, column c0
    const float v11 = affine_relu(acc[4 * j + 3], sc.y, sf.y);  // row g+8, column c0 + 1
    // the next layer's A fragment: k-positions t and t+4 hold channels c0, c0 + 1
    cx.afrag[j * 128 + cx.t] = make_float4(v00, v10, v01, v11);
  }
}

__device__ __forceinline__ float2 load_pair(const float* __restrict__ p, int c, int w) {
  if ((w & 1) == 0) return c < w ? __ldg(reinterpret_cast<const float2*>(p + c)) : make_float2(0.0f, 0.0f);
  return make_float2(c < w ? __ldg(p + c) : 0.0f, c + 1 < w ? __ldg(p + c + 1) : 0.0f);
}

constexpr int kGatherSteps = 8;  // k8 steps of layer 0 whose loads are in flight together

// grid = min(ceil(items / 2), SMs), block = kThreads: warpgroup 0 the
// producer (one thread streams the weight slices), warpgroups 1 and 2 the
// consumers. Dynamic shared memory: the weight ring (stages x stage_bytes),
// each consumer's A-fragment slots (kb_max x 128 threads x 16 bytes) and
// pooled rows (T x pool_ld ints), the affine vectors (s0 padded to kpad[0],
// then each layer's scale and shift padded to npad), the ring's mbarriers.
// An item is one tile of T centres (S <= 64) or the R tiles of one centre
// (S > 64); consumer w of a block takes item 2p + w of each pair p the
// block walks. Two TF32 terms a weight in the ring (ks 16 or 32).
__global__ void __launch_bounds__(kThreads, 1)
    samlp_kernel(const float* __restrict__ h_all, const int* __restrict__ idx, const float* __restrict__ sh0,
                 const float* __restrict__ s0, const uint8_t* __restrict__ wsplit,
                 const __grid_constant__ Chain chain, int N, int M, int S, int T, int R, int items_per_row,
                 int items, int ks, int stages, int stage_bytes, int kb_max, int pool_ld,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const ring = smem;
  float4* const afrag_all = reinterpret_cast<float4*>(smem + stages * stage_bytes);
  int* const pooled_all = reinterpret_cast<int*>(afrag_all + kConsumerWGs * kb_max * 128);
  float* const affine = reinterpret_cast<float*>(pooled_all + kConsumerWGs * T * pool_ld);
  int n_aff = chain.kpad[0];
  for (int l = 0; l < chain.n; ++l) n_aff += 2 * chain.npad[l];
  uint64_t* const full = reinterpret_cast<uint64_t*>(affine + n_aff);
  uint64_t* const empty = full + kMaxStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumerWGs);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kConsumerWGs * T * pool_ld; i += kThreads) pooled_all[i] = 0;  // +0.0f
  {
    const int w0 = chain.width[0];
    for (int c = tid; c < chain.kpad[0]; c += kThreads) affine[c] = c < w0 ? s0[c] : 0.0f;
    float* a = affine + chain.kpad[0];
    for (int l = 0; l < chain.n; ++l) {
      const int np = chain.npad[l], w = chain.width[l + 1];
      for (int c = tid; c < np; c += kThreads) {
        a[c] = c < w ? chain.scale[l][c] : 0.0f;
        a[np + c] = c < w ? chain.shift[l][c] : 0.0f;
      }
      a += 2 * np;
    }
  }
  __syncthreads();

  const int pairs = (items + 1) / 2;
  const int wg = tid >> 7;
  if (wg == 0) {  // the producer: every slice of every layer of every tile, in order
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      int stage = 0, phase = 0;
      for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
        for (int j = 0; j < R; ++j) {
          for (int l = 0; l < chain.n; ++l) {
            const int bytes = chain.npad[l] * ks * 8;
            const uint8_t* src = wsplit + chain.woff[l];
            for (int k0 = 0; k0 < chain.kpad[l]; k0 += ks, src += bytes) {
              mbar_wait(&empty[stage], phase ^ 1);
              mbar_expect_tx(&full[stage], bytes);
              bulk_load(ring + stage * stage_bytes, src, bytes, &full[stage]);
              if (++stage == stages) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int cw = wg - 1;  // consumer warpgroup 0 or 1
  const int t = tid & 127;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r0 = (t >> 5) * 16 + g;  // the thread's rows r0 and r0 + 8 of the tile
  const bool wide = S > kRows;
  Ctx cx;
  cx.afrag = afrag_all + cw * kb_max * 128;
  cx.t = t;
  cx.ring = ring;
  cx.stage_bytes = stage_bytes;
  cx.stages = stages;
  cx.full = full;
  cx.empty = empty;
  cx.pooled = pooled_all + cw * T * pool_ld;
  cx.pool_ld = pool_ld;
  cx.grp8 = wide || S % 8 == 0;
  cx.grp16 = wide || S % 16 == 0;
  const int w0 = chain.width[0];
  const int wl = chain.width[chain.n];
  const int kb0 = chain.kpad[0] / 8;  // a multiple of 4
  int stage = 0, phase = 0;

  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int item = 2 * pair + cw;
    const bool live = item < items;  // else a dummy tile keeps the ring in step
    const int b = live ? item / items_per_row : 0;
    const int it = item - b * items_per_row;
    const size_t bm = static_cast<size_t>(b) * M;
    for (int j = 0; j < R; ++j) {
      // layer 0: gather the thread's rows into its A fragments
      const Rows rows = tile_rows(r0, S, T, M, it, j, live);
      const float* hrow[2];
      const float* srow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int centre = wide ? it : it * T + rows.cl[h];
        const int slot = wide ? j * kRows + r : r - rows.cl[h] * S;
        hrow[h] = nullptr;
        srow[h] = nullptr;
        if (rows.ok[h]) {
          const int n = __ldg(idx + (bm + centre) * S + slot);
          if (n >= 0 && n < N) hrow[h] = h_all + (static_cast<size_t>(b) * N + n) * w0;
          srow[h] = sh0 + (bm + centre) * w0;
        }
      }
      for (int kbase = 0; kbase < kb0; kbase += kGatherSteps) {
        float2 x[kGatherSteps][2], sh[kGatherSteps][2];
#pragma unroll
        for (int u = 0; u < kGatherSteps; ++u) {  // all loads first
          const int c = 8 * (kbase + u) + 2 * tig;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            x[u][h] = hrow[h] != nullptr && kbase + u < kb0 ? load_pair(hrow[h], c, w0) : make_float2(0.0f, 0.0f);
            sh[u][h] = srow[h] != nullptr && kbase + u < kb0 ? load_pair(srow[h], c, w0) : make_float2(0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int u = 0; u < kGatherSteps; ++u) {
          const int kb = kbase + u;
          if (kb >= kb0) break;
          const int c = 8 * kb + 2 * tig;
          const float2 sc = *reinterpret_cast<const float2*>(affine + c);
          float2 v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h] = make_float2(0.0f, 0.0f);
            if (srow[h] != nullptr) {  // zero scale past w0: relu(0 * 0 + 0)
              v[h] = make_float2(affine_relu(x[u][h].x, sc.x, sh[u][h].x), affine_relu(x[u][h].y, sc.y, sh[u][h].y));
            }
          }
          cx.afrag[kb * 128 + t] = make_float4(v[0].x, v[1].x, v[0].y, v[1].y);
        }
      }

      const float* aff = affine + chain.kpad[0];
      for (int l = 0; l < chain.n; ++l) {
        const bool last = l == chain.n - 1;
        const int np = chain.npad[l];
#define SAMLP_LAYER(NP, KB) dense_layer<NP, KB>(cx, chain.kpad[l], aff, last, rows, stage, phase)
        if (ks == 32) {  // four wgmma K steps a slice, else two
          switch (np) {
            case 32: SAMLP_LAYER(32, 4); break;
            case 64: SAMLP_LAYER(64, 4); break;
            case 128: SAMLP_LAYER(128, 4); break;
            default: SAMLP_LAYER(256, 4); break;
          }
        } else {
          switch (np) {
            case 32: SAMLP_LAYER(32, 2); break;
            case 64: SAMLP_LAYER(64, 2); break;
            case 128: SAMLP_LAYER(128, 2); break;
            default: SAMLP_LAYER(256, 2); break;
          }
        }
#undef SAMLP_LAYER
        aff += 2 * np;
      }
    }
    write_pooled(cx, cw, T, wl, S, M, it, bm, live, out);
  }
}

// ---- samlp_bf16_kernel: bf16 operands ----

constexpr int kAFrag = 64;    // packed bf16 A registers of a K of 256: 4 a k16 step
constexpr int kStagePad = 8;  // floats past K0 in a staged row: rows 8 banks apart
constexpr int kMaxSlots = 8;  // staging slots, at most
constexpr int kStageBar = 5;  // the staging threads' named barrier (1-2: the consumers, 3-4: their turns)

constexpr int kChunk = 128;   // columns of a layer's products at a time: 64 accumulators a thread
constexpr int kIdxAhead = 4;  // steps (a tile of each consumer) whose index rows the producer fetches ahead

// Dynamic shared memory of samlp_bf16_kernel, in bytes from its start: the
// resident chain (stages == 0) or the ring; `slots` staged tiles, each 64
// rows of h_all and T + 1 rows of sh0 (the last zeros) of K0 + kStagePad
// floats; the pooled rows; the affine vectors (s0, each layer's scale and
// shift, the last layer's scale's signs); kIdxAhead + 1 steps' index
// rows (two tiles a step); the mbarriers (the chain's; each slot's full and empty; the ring's
// full and empty, kMaxStages each).
struct Bf16Smem {
  size_t hst, sst, pooled, affine, rowsrc, bars, total;
};

__host__ __device__ inline Bf16Smem bf16_smem(const Chain& c, int T, int ks, int stages, int slots) {
  size_t weights = 0, n_aff = c.kpad[0] + c.npad[c.n - 1];  // s0, then each layer's scale and shift, and signs
  int np_max = 0;
  for (int l = 0; l < c.n; ++l) {
    weights += static_cast<size_t>(c.kpad[l]) * c.npad[l] * 2;
    n_aff += 2 * c.npad[l];
    np_max = c.npad[l] > np_max ? c.npad[l] : np_max;
  }
  const size_t row = static_cast<size_t>(c.kpad[0] + kStagePad) * 4;
  Bf16Smem m;
  m.hst = stages == 0 ? weights : static_cast<size_t>(stages) * (np_max < kChunk ? np_max : kChunk) * ks * 2;
  m.sst = m.hst + static_cast<size_t>(slots) * kRows * row;
  m.pooled = m.sst + static_cast<size_t>(slots) * (T + 1) * row;
  m.affine = m.pooled + static_cast<size_t>(kConsumerWGs) * T * c.npad[c.n - 1] * 4;
  m.rowsrc = m.affine + n_aff * 4;
  m.bars = m.rowsrc + (kIdxAhead + 1) * kConsumerWGs * kRows * 4;
  m.total = m.bars + (1 + 2 * kMaxSlots + 2 * kMaxStages) * 8;
  return m;
}

// What the staging threads need.
struct Staging {
  const float* h_all;
  const int* idx;
  const float* sh0;
  const float* zeros;  // a row of w0 zeros (the bulk copies' source for a row that gathers none)
  float* hst;          // [slot][64 rows][stride]
  float* sst;          // [slot][T + 1 rows][stride]
  int* rowsrc;         // [step % (kIdxAhead + 1)][consumer][64 rows]: idx, or -1 for a row past the slots
  uint64_t* full;      // [slot]
  uint64_t* empty;     // [slot]
  int N, M, S, T, R, items_per_row, items, w0, stride, slots;
};

// Row rr (< 128) of a step's two index rows (the step: tile j of the pair
// of items the block walks, consumer rr / 64's tile), fetched ahead by
// cp.async (4 bytes: a tile's indices are contiguous in idx, at any
// alignment), or -1 stored for a row past the tile's centres or slots.
__device__ __forceinline__ void fetch_index(const Staging& st, int pair, int j, int rr, int* dst) {
  const bool wide = st.S > kRows;
  const int item = 2 * pair + (rr >> 6), r = rr & (kRows - 1);
  if (item < st.items && r < (wide ? kRows : st.T * st.S)) {
    const int b = item / st.items_per_row;
    const int it = item - b * st.items_per_row;
    const int cl = wide ? 0 : r / st.S;
    const int centre = wide ? it : it * st.T + cl;
    const int slot = wide ? j * kRows + r : r - cl * st.S;
    if (centre < st.M && slot < st.S) {
      cp_async_zfill<4>(smem_u32(dst), st.idx + (static_cast<size_t>(b) * st.M + centre) * st.S + slot, 4);
      return;
    }
  }
  *dst = -1;
}

// The producer's staging loop: a step a pass, both consumers' tiles of it
// (tile j of the pair of items the block walks), into the ring of slots in
// the order the consumers take them, threads p of G. The staging threads
// fetch each step's two index rows kIdxAhead steps ahead into rowsrc (a
// commit group a step: the wait for the group of step q - kIdxAhead and one
// barrier a step make step q's indices visible). CH = 0: one bulk copy a
// row (a tile's 64 h_all rows and T sh0 rows, a row outside the data from
// `zeros`), counted on the slot's full barrier by the bytes thread 0
// expects; else cp.async of CH bytes, every thread walking the flat (row,
// chunk) list, zeros filled, the thread's own arrival once its copies land.
template <int CH>
__device__ __forceinline__ void stage_tiles(const Staging& st, int p, int G) {
  constexpr int kF = CH == 0 ? 1 : CH / 4;  // floats a chunk
  const int cpr = CH == 0 ? 1 : st.w0 / kF;
  const int rows_all = kRows + st.T;
  const int drow = G / cpr, dch = G - drow * cpr;
  const int row0 = p / cpr, ch0 = p - row0 * cpr;
  const bool wide = st.S > kRows;
  const int pairs = (st.items + 1) / 2;
  const int steps = (pairs - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * st.R;
  constexpr int kIdx = kConsumerWGs * kRows;  // index rows a step
  for (int q = 0; q < kIdxAhead; ++q) {
    if (q < steps) {
      for (int rr = p; rr < kIdx; rr += G) {
        fetch_index(st, blockIdx.x + q / st.R * gridDim.x, q % st.R, rr, st.rowsrc + q * kIdx + rr);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int slot = 0, phase = 0, buf = 0;
  for (int q = 0, pair = blockIdx.x, j = 0; q < steps; ++q) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kIdxAhead - 1) : "memory");  // this step's indices
    bar_sync(kStageBar, G);
    for (int c = 0; c < kConsumerWGs; ++c) {
      const int item = 2 * pair + c;
      const bool live = item < st.items;
      const int b = live ? item / st.items_per_row : 0;
      const int it = item - b * st.items_per_row;
      const size_t bm = static_cast<size_t>(b) * st.M;
      const int* const rs = st.rowsrc + buf * kIdx + c * kRows;
      float* const hb = st.hst + slot * kRows * st.stride;
      float* const sb = st.sst + slot * (st.T + 1) * st.stride;
      mbar_wait(&st.empty[slot], phase ^ 1);
      if constexpr (CH == 0) {
        const int bytes = st.w0 * 4;
        if (p == 0) mbar_expect_tx(&st.full[slot], rows_all * bytes);
        for (int row = p; row < rows_all; row += G) {
          const float* src = st.zeros;
          float* dst;
          if (row < kRows) {
            const int n = rs[row];
            if (n >= 0 && n < st.N) src = st.h_all + (static_cast<size_t>(b) * st.N + n) * st.w0;
            dst = hb + row * st.stride;
          } else {
            const int cl = row - kRows;
            const int centre = wide ? it : it * st.T + cl;
            if (live && centre < st.M) src = st.sh0 + (bm + centre) * st.w0;
            dst = sb + cl * st.stride;
          }
          bulk_load(dst, src, bytes, &st.full[slot]);
        }
      } else {
        int row = row0, ch = ch0;
#pragma unroll 4
        for (; row < rows_all;) {
          const float* src;
          float* dst;
          bool ok;
          if (row < kRows) {
            const int n = rs[row];
            ok = n >= 0 && n < st.N;
            src = st.h_all + (static_cast<size_t>(b) * st.N + (ok ? n : 0)) * st.w0 + ch * kF;
            dst = hb + row * st.stride + ch * kF;
          } else {
            const int cl = row - kRows;
            const int centre = wide ? it : it * st.T + cl;
            ok = live && centre < st.M;
            src = st.sh0 + (bm + (ok ? centre : 0)) * st.w0 + ch * kF;
            dst = sb + cl * st.stride + ch * kF;
          }
          cp_async_zfill<CH>(smem_u32(dst), src, ok ? CH : 0);
          row += drow;
          ch += dch;
          if (ch >= cpr) {
            ch -= cpr;
            ++row;
          }
        }
        cp_async_arrive(&st.full[slot]);
      }
      if (++slot == st.slots) {
        slot = 0;
        phase ^= 1;
      }
    }
    // step q + kIdxAhead's indices, into the buffer step q - 1 read before the barrier
    const int ahead = q + kIdxAhead;
    if (ahead < steps) {
      for (int rr = p; rr < kIdx; rr += G) {
        fetch_index(st, blockIdx.x + ahead / st.R * gridDim.x, ahead % st.R, rr,
                    st.rowsrc + (buf == 0 ? kIdxAhead : buf - 1) * kIdx + rr);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    buf = buf == kIdxAhead ? 0 : buf + 1;
    if (++j == st.R) {
      j = 0;
      pair += gridDim.x;
    }
  }
}

// The first KA A registers as they stand: every later use reads these
// values, so what computes them stays before the barriers and the wgmma
// fence that follow (else ptxas puts a warpgroup.arrive before the
// products).
template <int KA>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[kAFrag]) {
#pragma unroll
  for (int i = 0; i < KA; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Layer 0 from the staged tile: the affine + ReLU of the thread's rows
// (h0/h1 the staged h_all rows r0 and r0 + 8, u0/u1 their centres' sh0
// rows, sc the affine's s0, each at column 2t), rounded into the A
// registers of K0 / 16 k16 steps; zeros past them up to KA (the chain at
// run time: every register a layer may read is defined).
template <int K0, int KA>
__device__ __forceinline__ void staged_frags(uint32_t (&a)[kAFrag], const float* h0, const float* h1,
                                             const float* u0, const float* u1, const float* sc) {
#pragma unroll
  for (int j = 0; j < K0 / 8; ++j) {
    const float2 x0 = *reinterpret_cast<const float2*>(h0 + 8 * j);
    const float2 x1 = *reinterpret_cast<const float2*>(h1 + 8 * j);
    const float2 t0 = *reinterpret_cast<const float2*>(u0 + 8 * j);
    const float2 t1 = *reinterpret_cast<const float2*>(u1 + 8 * j);
    const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j);
    a[2 * j] = bf16x2_rn(affine_relu(x0.x, s.x, t0.x), affine_relu(x0.y, s.y, t0.y));
    a[2 * j + 1] = bf16x2_rn(affine_relu(x1.x, s.x, t1.x), affine_relu(x1.y, s.y, t1.y));
  }
#pragma unroll
  for (int i = K0 / 4; i < KA; ++i) a[i] = 0;
  fence_frags<KA>(a);
}

// A chunk's epilogue into the next layer's A registers: the affine + ReLU
// of columns 8j + 2t, 8j + 2t + 1 of the chunk (sc, sf its scale and
// shift) rounded to a bf16 pair, rows g (out[off + 2j]) and g+8
// (out[off + 2j + 1]).
template <int NC>
__device__ __forceinline__ void acc_frags(const float (&acc)[NC / 2], uint32_t (&out)[kAFrag], int off,
                                          const float* sc, const float* sf, int tig) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * tig);
    const float2 f = *reinterpret_cast<const float2*>(sf + 8 * j + 2 * tig);
    out[off + 2 * j] = bf16x2_rn(affine_relu(acc[4 * j], s.x, f.x), affine_relu(acc[4 * j + 1], s.y, f.y));
    out[off + 2 * j + 1] =
        bf16x2_rn(affine_relu(acc[4 * j + 2], s.x, f.x), affine_relu(acc[4 * j + 3], s.y, f.y));
  }
}

// A chunk's K / 16 products from the resident chain (the chunk's columns
// at base in each slice of ks channels, the slices `slice` bytes apart: k16
// step s in slice s / (ks / 16)), back to back: one commit group.
template <int K, int NC>
__device__ __forceinline__ void issue_resident(float (&acc)[NC / 2], const uint32_t (&a)[kAFrag], uint32_t base,
                                               uint32_t slice, int ks) {
  const int kb_log = ks == 64 ? 2 : 1;  // k16 steps a slice: 4 or 2
  const uint32_t sbo = ks * 16;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    const uint32_t addr = base + (s >> kb_log) * slice + (s & ((1 << kb_log) - 1)) * 256;
    wgmma_bf16<NC>(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3], bdesc(addr, sbo), s > 0);
  }
  wgmma_commit();
}

// A chunk's products from the ring, a commit group a slice; the stage of a
// slice is released once the next slice's products are issued and its own
// have completed (wait_group 1), the last one after the wait for all.
template <int K, int NC, int KS>
__device__ __forceinline__ void issue_ring(float (&acc)[NC / 2], const uint32_t (&a)[kAFrag], const Ctx& cx,
                                           int& stage, int& phase) {
  constexpr int KB = KS / 16;
  const int lane = cx.t & 31;
  int prev = 0;
#pragma unroll
  for (int sl = 0; sl < K / KS; ++sl) {
    mbar_wait(&cx.full[stage], phase);
    const uint32_t base = smem_u32(cx.ring + stage * cx.stage_bytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int s = sl * KB + kk;
      wgmma_bf16<NC>(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3], bdesc(base + kk * 256, KS * 16),
                     s > 0);
    }
    wgmma_commit();
    if (sl > 0) {
      fence_regs(acc);
      wgmma_wait1();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&cx.empty[prev]);
    }
    prev = stage;
    if (++stage == cx.stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  fence_regs(acc);
  wgmma_wait0();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(&cx.empty[prev]);
}

// max that propagates a NaN (as the pooled max of the ReLU outputs does)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The last layer's pool where a warp's 16 rows share a centre (S a multiple
// of 16, or S > 64), the affine + ReLU taken once a column: y -> relu((y *
// s) + t), each step rounded, is monotone in y (non-decreasing for s >= 0,
// non-increasing for s < 0), so its max over the rows is its value at the
// max of the accumulators times sg = (s < 0 ? -1 : 1), bit for bit. Rows
// outside the data are -inf there (a warp with none in the data folds
// nothing, as zeros fold nothing). The max over the warp's rows is the
// reduce-scatter of pool_tile's 16-row path; sc, sf, sg at col0.
template <int N>
__device__ __forceinline__ void pool_rows_once(const Ctx& cx, const float (&acc)[N / 2], const float* sc,
                                               const float* sf, const float* sg, const Rows& rows, int col0) {
  const int lane = cx.t & 31;
  const int tig = lane & 3;
  if (!__any_sync(0xffffffffu, rows.ok[0] || rows.ok[1])) return;
  const bool all = __all_sync(0xffffffffu, rows.ok[0] && rows.ok[1]);
  constexpr int CJ = N / 8 < 8 ? N / 8 : 8;
  const int b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1, b4 = (lane >> 4) & 1;
  int* const prow = cx.pooled + rows.cl[0] * cx.pool_ld + col0;
#pragma unroll
  for (int q = 0; q < N / 8 / CJ; ++q) {
    float a[CJ];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {  // keep column 8j + 2t + b2
      const int j = q * CJ + jj;
      const float2 g = *reinterpret_cast<const float2*>(sg + 8 * j + 2 * tig);
      float y00 = __fmul_rn(acc[4 * j], g.x), y01 = __fmul_rn(acc[4 * j + 1], g.y);
      float y10 = __fmul_rn(acc[4 * j + 2], g.x), y11 = __fmul_rn(acc[4 * j + 3], g.y);
      if (!all) {
        const float ninf = __int_as_float(0xff800000);
        if (!rows.ok[0]) y00 = y01 = ninf;
        if (!rows.ok[1]) y10 = y11 = ninf;
      }
      const float m0 = max_nan(y00, y10), m1 = max_nan(y01, y11);
      a[jj] = max_nan(b2 ? m1 : m0, __shfl_xor_sync(0xffffffffu, b2 ? m0 : m1, 4));
    }
    float c[CJ / 2];
#pragma unroll
    for (int i = 0; i < CJ / 2; ++i) {  // keep jj = 2i + b3
      c[i] = max_nan(b3 ? a[2 * i + 1] : a[2 * i], __shfl_xor_sync(0xffffffffu, b3 ? a[2 * i] : a[2 * i + 1], 8));
    }
#pragma unroll
    for (int k = 0; k < CJ / 4; ++k) {  // keep i = 2k + b4: jj = 4k + 2 b4 + b3
      const float d = max_nan(b4 ? c[2 * k + 1] : c[2 * k], __shfl_xor_sync(0xffffffffu, b4 ? c[2 * k] : c[2 * k + 1], 16));
      const int col = 8 * (q * CJ + 4 * k + 2 * b4 + b3) + 2 * tig + b2;
      if (rows.blk_ok[0]) fold(prow + col, affine_relu(__fmul_rn(d, sg[col]), sc[col], sf[col]));
    }
  }
}

// What a bf16 layer needs besides the consumer's Ctx.
struct Turn {
  bool resident;  // the chain is in shared memory (else the ring)
  bool pingpong;  // the consumers take turns at issuing
  bool first;     // the consumer has issued nothing yet
  int cw;         // the consumer, 0 or 1
};

// One bf16 dense layer of a tile (its K and wgmma N, the chain at wbase
// with slices of ks channels, aff its scale then shift), in chunks of at
// most kChunk columns: each chunk's products, then its epilogue into the
// next layer's A registers `out` or the pool (LAST). Past N / 4, `out` is
// zero up to KA (the chain at run time: every register a layer may read is
// defined).
template <int K, int N, bool LAST, int KA>
__device__ __forceinline__ void bf16_layer(const Ctx& cx, Turn& turn, const uint32_t (&a)[kAFrag],
                                           uint32_t (&out)[kAFrag], int ks, uint32_t wbase, const float* aff,
                                           const Rows& rows, int& stage, int& phase) {
  constexpr int NC = N < kChunk ? N : kChunk;
#pragma unroll
  for (int c = 0; c < N / NC; ++c) {
    float acc[NC / 2];
    if (turn.resident) {
      if (turn.pingpong && !(turn.cw == 0 && turn.first)) bar_sync(3 + turn.cw, 256);  // this consumer's turn
      turn.first = false;
      issue_resident<K, NC>(acc, a, wbase + c * NC * ks * 2, N * ks * 2, ks);
      if (turn.pingpong) bar_arrive(3 + (turn.cw ^ 1), 256);  // the other consumer's turn
      fence_regs(acc);
      wgmma_wait0();
      fence_regs(acc);
    } else if (K % 64 == 0 && ks == 64) {
      issue_ring<K, NC, (K % 64 == 0 ? 64 : 32)>(acc, a, cx, stage, phase);
    } else {
      issue_ring<K, NC, 32>(acc, a, cx, stage, phase);
    }
    if constexpr (LAST) {
      if (cx.grp16) {
        pool_rows_once<NC>(cx, acc, aff + c * NC, aff + N + c * NC, aff + 2 * N + c * NC, rows, c * NC);
      } else {
        pool_tile<NC>(cx, acc, aff + c * NC, aff + N + c * NC, rows, c * NC);
      }
    } else {
      acc_frags<NC>(acc, out, c * NC / 4, aff + c * NC, aff + N + c * NC, cx.t & 3);
    }
  }
  if constexpr (!LAST) {
#pragma unroll
    for (int i = N / 4; i < KA; ++i) out[i] = 0;
    fence_frags<KA>(out);
  }
}

// A layer of K input channels whose wgmma N is np, chosen at run time.
template <int K, bool LAST, int KA>
__device__ __forceinline__ void bf16_layer_n(int np, const Ctx& cx, Turn& turn, const uint32_t (&a)[kAFrag],
                                             uint32_t (&out)[kAFrag], int ks, uint32_t wbase, const float* aff,
                                             const Rows& rows, int& stage, int& phase) {
  switch (np) {
    case 32: bf16_layer<K, 32, LAST, KA>(cx, turn, a, out, ks, wbase, aff, rows, stage, phase); break;
    case 64: bf16_layer<K, 64, LAST, KA>(cx, turn, a, out, ks, wbase, aff, rows, stage, phase); break;
    case 128: bf16_layer<K, 128, LAST, KA>(cx, turn, a, out, ks, wbase, aff, rows, stage, phase); break;
    default: bf16_layer<K, 256, LAST, KA>(cx, turn, a, out, ks, wbase, aff, rows, stage, phase); break;
  }
}

// A layer of the chain dispatched at run time (its K kp and wgmma N np),
// every A register of `out` defined after it.
template <bool LAST>
__device__ __forceinline__ void bf16_layer_any(int kp, int np, const Ctx& cx, Turn& turn, const uint32_t (&a)[kAFrag],
                                               uint32_t (&out)[kAFrag], int ks, uint32_t wbase, const float* aff,
                                               const Rows& rows, int& stage, int& phase) {
  switch (kp) {
    case 32: bf16_layer_n<32, LAST, kAFrag>(np, cx, turn, a, out, ks, wbase, aff, rows, stage, phase); break;
    case 64: bf16_layer_n<64, LAST, kAFrag>(np, cx, turn, a, out, ks, wbase, aff, rows, stage, phase); break;
    case 128: bf16_layer_n<128, LAST, kAFrag>(np, cx, turn, a, out, ks, wbase, aff, rows, stage, phase); break;
    default: bf16_layer_n<256, LAST, kAFrag>(np, cx, turn, a, out, ks, wbase, aff, rows, stage, phase); break;
  }
}

// grid = min(ceil(items / 2), SMs), block = kThreads: warpgroup 0 the
// producer (the chain's bulk copy or the ring, and the staging), warpgroups
// 1 and 2 the consumers; items and pairs as samlp_kernel's. stages == 0:
// the chain resident in shared memory, else a ring of `stages` slices of ks
// channels. `slots` staged tiles (2 to kMaxSlots); tile q of the block's
// order (a pair's tile j of each consumer in turn) takes slot q % slots.
// chunk: 0, a bulk copy a staged row
// (w0 * 4 and h_all's and sh0's addresses multiples of 16), else the bytes
// a cp.async (8 or 4, dividing them). wsplit: the rounded chain, then a row
// of zeros.
// Dynamic shared memory: bf16_smem. Each layer's K and N are dispatched at
// run time; every A register is defined after each layer (zeros past its
// width), so none of an earlier layer's stays live.
__global__ void __launch_bounds__(kThreads, 1)
    samlp_bf16_kernel(const float* __restrict__ h_all, const int* __restrict__ idx, const float* __restrict__ sh0,
                      const float* __restrict__ s0, const uint8_t* __restrict__ wsplit,
                      const __grid_constant__ Chain chain, int N, int M, int S, int T, int R, int items_per_row,
                      int items, int ks, int stages, int slots, int chunk, float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Bf16Smem lay = bf16_smem(chain, T, ks, stages, slots);
  const bool resident = stages == 0;
  const int k0 = chain.kpad[0];
  const int stride = k0 + kStagePad;
  const int pool_ld = chain.npad[chain.n - 1];
  float* const hst = reinterpret_cast<float*>(smem + lay.hst);
  float* const sst = reinterpret_cast<float*>(smem + lay.sst);
  int* const pooled_all = reinterpret_cast<int*>(smem + lay.pooled);
  float* const affine = reinterpret_cast<float*>(smem + lay.affine);
  int* const rowsrc = reinterpret_cast<int*>(smem + lay.rowsrc);
  uint64_t* const wbar = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* const sfull = wbar + 1;
  uint64_t* const sempty = sfull + kMaxSlots;
  uint64_t* const rfull = sempty + kMaxSlots;
  uint64_t* const rempty = rfull + kMaxStages;
  const int stagers = resident ? 128 : 96;  // the producer's staging threads: all, or warps 1-3
  const float* const zeros = reinterpret_cast<const float*>(wsplit + chain.woff[chain.n - 1]) +
                             chain.kpad[chain.n - 1] * chain.npad[chain.n - 1] / 2;  // past the chain

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int q = 0; q < slots; ++q) {
      mbar_init(&sfull[q], chunk == 0 ? 1 : stagers);  // the bulk copies' bytes, or cp.async's own arrivals
      mbar_init(&sempty[q], 4);       // one arrival a warp of the consumer
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(&rfull[s], 1);
      mbar_init(&rempty[s], 4 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the staged rows' padding, sh0's zero rows and the pooled rows start at 0
  for (size_t i = tid; i < (lay.affine - lay.hst) / 4; i += kThreads) reinterpret_cast<int*>(smem + lay.hst)[i] = 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the bulk copies write the rows
  {
    const int w0 = chain.width[0];
    for (int c = tid; c < k0; c += kThreads) affine[c] = c < w0 ? s0[c] : 0.0f;
    float* a = affine + k0;
    for (int l = 0; l < chain.n; ++l) {
      const int np = chain.npad[l], w = chain.width[l + 1];
      for (int c = tid; c < np; c += kThreads) {
        a[c] = c < w ? chain.scale[l][c] : 0.0f;
        a[np + c] = c < w ? chain.shift[l][c] : 0.0f;
      }
      a += 2 * np;
    }
    const int l = chain.n - 1, np = chain.npad[l], w = chain.width[l + 1];  // its scale's signs: pool_rows_once
    for (int c = tid; c < np; c += kThreads) a[c] = c < w && chain.scale[l][c] < 0.0f ? -1.0f : 1.0f;
  }
  __syncthreads();

  const int pairs = (items + 1) / 2;
  const int wg = tid >> 7;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (resident && tid == 0) {  // the whole chain, once
      const int bytes = static_cast<int>(lay.hst);
      mbar_expect_tx(wbar, bytes);
      for (int l = 0; l < chain.n; ++l) {
        const long long end = l + 1 < chain.n ? chain.woff[l + 1] : bytes;
        bulk_load(smem + chain.woff[l], wsplit + chain.woff[l], static_cast<int>(end - chain.woff[l]), wbar);
      }
    }
    if (!resident && tid < 32) {  // the ring: every slice of every layer of every tile, in order
      if (tid == 0) {
        const int stage_bytes = static_cast<int>(lay.hst) / stages;
        int stage = 0, phase = 0;
        for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
          for (int j = 0; j < R; ++j) {
            for (int l = 0; l < chain.n; ++l) {
              const int np = chain.npad[l], nc = np < kChunk ? np : kChunk;
              const int bytes = nc * ks * 2;  // a chunk's columns of a slice
              for (int c = 0; c < np / nc; ++c) {
                const uint8_t* src = wsplit + chain.woff[l] + c * bytes;
                for (int kk = 0; kk < chain.kpad[l]; kk += ks, src += np * ks * 2) {
                  mbar_wait(&rempty[stage], phase ^ 1);
                  mbar_expect_tx(&rfull[stage], bytes);
                  bulk_load(smem + stage * stage_bytes, src, bytes, &rfull[stage]);
                  if (++stage == stages) {
                    stage = 0;
                    phase ^= 1;
                  }
                }
              }
            }
          }
        }
      }
      return;
    }
    const Staging st{h_all, idx, sh0, zeros, hst, sst, rowsrc, sfull, sempty,
                     N, M, S, T, R, items_per_row, items, chain.width[0], stride, slots};
    const int p = resident ? tid : tid - 32;
    switch (chunk) {
      case 0: stage_tiles<0>(st, p, stagers); break;
      case 8: stage_tiles<8>(st, p, stagers); break;
      default: stage_tiles<4>(st, p, stagers); break;
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int cw = wg - 1;  // consumer warpgroup 0 or 1
  const int t = tid & 127;
  const int lane = tid & 31;
  const int tig = lane & 3;
  const int r0 = (t >> 5) * 16 + (lane >> 2);  // the thread's rows r0 and r0 + 8 of the tile
  const bool wide = S > kRows;
  Ctx cx;
  cx.afrag = nullptr;
  cx.t = t;
  cx.ring = smem;
  cx.stage_bytes = resident ? 0 : static_cast<int>(lay.hst) / stages;
  cx.stages = stages;
  cx.full = rfull;
  cx.empty = rempty;
  cx.pooled = pooled_all + cw * T * pool_ld;
  cx.pool_ld = pool_ld;
  cx.grp8 = wide || S % 8 == 0;
  cx.grp16 = wide || S % 16 == 0;
  Turn turn{resident, resident, true, cw};
  const int wl = chain.width[chain.n];
  const uint32_t wsm = smem_u32(smem);
  int stage = 0, phase = 0;
  int slot = cw, sphase = 0;  // the consumer's tiles are every other of the block's order
  if (resident) mbar_wait(wbar, 0);

  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int item = 2 * pair + cw;
    const bool live = item < items;  // else a dummy tile keeps the staging and the turns in step
    const int b = live ? item / items_per_row : 0;
    const int it = item - b * items_per_row;
    const size_t bm = static_cast<size_t>(b) * M;
    for (int j = 0; j < R; ++j) {
      const Rows rows = tile_rows(r0, S, T, M, it, j, live);
      // layer 0 from the staged tile (a row's centre T, past the last whole
      // centre, is the zero row)
      uint32_t a[kAFrag];
      mbar_wait(&sfull[slot], sphase);
      {
        const float* const hb = hst + slot * kRows * stride;
        const float* const sb = sst + slot * (T + 1) * stride;
        const float* h0 = hb + r0 * stride + 2 * tig;
        const float* u0 = sb + rows.cl[0] * stride + 2 * tig;
        const float* u1 = sb + rows.cl[1] * stride + 2 * tig;
        const float* sc = affine + 2 * tig;
        switch (k0) {
          case 32: staged_frags<32, kAFrag>(a, h0, h0 + 8 * stride, u0, u1, sc); break;
          case 64: staged_frags<64, kAFrag>(a, h0, h0 + 8 * stride, u0, u1, sc); break;
          case 128: staged_frags<128, kAFrag>(a, h0, h0 + 8 * stride, u0, u1, sc); break;
          default: staged_frags<256, kAFrag>(a, h0, h0 + 8 * stride, u0, u1, sc); break;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sempty[slot]);  // the producer may stage a later tile here
      slot += kConsumerWGs;
      if (slot >= slots) {
        slot -= slots;
        sphase ^= 1;
      }

      const float* aff = affine + k0;
      for (int l = 0; l + 1 < chain.n; ++l) {
        uint32_t next[kAFrag];
        bf16_layer_any<false>(chain.kpad[l], chain.npad[l], cx, turn, a, next, ks,
                              wsm + static_cast<uint32_t>(chain.woff[l]), aff, rows, stage, phase);
#pragma unroll
        for (int i = 0; i < kAFrag; ++i) a[i] = next[i];
        aff += 2 * chain.npad[l];
      }
      const int l = chain.n - 1;
      bf16_layer_any<true>(chain.kpad[l], chain.npad[l], cx, turn, a, a, ks, wsm + static_cast<uint32_t>(chain.woff[l]),
                           aff, rows, stage, phase);
    }
    write_pooled(cx, cw, T, wl, S, M, it, bm, live, out);
  }
  if (turn.pingpong && cw == 0) bar_sync(3, 256);  // the other consumer's last turn
}

struct Split {
  const float* w[kMaxLayers];  // layer l's weight, (w_out, w_in) row-major
  long long woff[kMaxLayers + 1];  // layer l's first element in the split weights
  int win[kMaxLayers], wout[kMaxLayers], npad[kMaxLayers];
  int n, ks;
};

// The weights' big and small TF32 terms in the order the ring streams them:
// per layer, per K slice of ks channels, [term][n / 8][k / 4 in the slice]
// [n % 8][k % 4] (wgmma's no-swizzle K-major core matrices), with the
// k-positions of each group of 8 permuted as the A fragments are (position
// p < 4 holds channel 2p, p >= 4 channel 2(p-4)+1); zero past the widths.
__global__ void samlp_split_weights(const __grid_constant__ Split a, float* __restrict__ wsplit) {
  const long long total = a.woff[a.n];
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    int l = 0;
    while (e >= a.woff[l + 1]) ++l;
    const int np = a.npad[l];
    const long long r = e - a.woff[l];
    const int slice = static_cast<int>(r / (2 * np * a.ks));
    int q = static_cast<int>(r - static_cast<long long>(slice) * 2 * np * a.ks);
    const int term = q / (np * a.ks);
    q -= term * np * a.ks;
    const int ng = q / (8 * a.ks);
    q -= ng * 8 * a.ks;
    const int kc = q / 32;
    q -= kc * 32;
    const int n = ng * 8 + q / 4;
    const int kpos = slice * a.ks + kc * 4 + (q & 3);
    const int p = kpos & 7;
    const int k = (kpos & ~7) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);
    const float x = (n < a.wout[l] && k < a.win[l]) ? a.w[l][static_cast<size_t>(n) * a.win[l] + k] : 0.0f;
    const float big = __uint_as_float(tf32_rna(x));
    wsplit[e] = term == 0 ? big : __uint_as_float(tf32_rna(__fsub_rn(x, big)));
  }
}

// The bf16 kernel's weights, one term rounded to bf16 (nearest, ties to
// even), in the ring's order (the resident chain too): per layer, per K
// slice of ks channels, [n / 8][k / 8 in the slice][n % 8][k % 8], the
// natural k order; zero past the widths. Then a row of 256 f32 zeros, the
// staging's source for rows that gather none.
constexpr int kZeroRow = 512;  // bf16 elements of the zero row
__global__ void samlp_round_weights(const __grid_constant__ Split a, __nv_bfloat16* __restrict__ wsplit) {
  const long long total = a.woff[a.n];
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    int l = 0;
    while (e >= a.woff[l + 1]) ++l;
    const int np = a.npad[l];
    const long long r = e - a.woff[l];
    const int slice = static_cast<int>(r / (np * a.ks));
    int q = static_cast<int>(r - static_cast<long long>(slice) * np * a.ks);
    const int ng = q / (8 * a.ks);
    q -= ng * 8 * a.ks;
    const int kc = q / 64;
    q -= kc * 64;
    const int n = ng * 8 + q / 8;
    const int k = slice * a.ks + kc * 8 + (q & 7);
    const float x = (n < a.wout[l] && k < a.win[l]) ? a.w[l][static_cast<size_t>(n) * a.win[l] + k] : 0.0f;
    wsplit[e] = __float2bfloat16_rn(x);
  }
  for (long long e = total + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total + kZeroRow;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    wsplit[e] = __float2bfloat16_rn(0.0f);
  }
}

// The chain and the weights' prologue arguments of a launch; false for
// arguments out of range. bf16: kpad[0] a power of two (32-256), one 2-byte
// term a weight; else kpad[0] a multiple of 32, two 4-byte terms.
bool chain_args(const void* const* wt, const void* const* scale, const void* const* shift, const int* widths,
                const int* npad, const int* kpad, int n_layers, int ks, bool bf16, Chain& chain, Split& split) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  chain.n = split.n = n_layers;
  split.ks = ks;
  long long off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || widths[l] > 256) return false;
    chain.width[l] = widths[l];
  }
  if (bf16 && (kpad[0] & (kpad[0] - 1)) != 0) return false;
  for (int l = 0; l < n_layers; ++l) {
    const int np = npad[l], kp = kpad[l];
    if ((np != 32 && np != 64 && np != 128 && np != 256) || np < widths[l + 1] || kp % 32 != 0 || kp > 256 ||
        kp % ks != 0 || kp < widths[l] || (l > 0 && kp != npad[l - 1]))
      return false;
    chain.scale[l] = static_cast<const float*>(scale[l]);
    chain.shift[l] = static_cast<const float*>(shift[l]);
    chain.npad[l] = split.npad[l] = np;
    chain.kpad[l] = kp;
    split.woff[l] = off;
    chain.woff[l] = off * (bf16 ? 2 : 4);
    split.w[l] = static_cast<const float*>(wt[l]);
    split.win[l] = widths[l];
    split.wout[l] = widths[l + 1];
    off += (bf16 ? 1LL : 2LL) * kp * np;
  }
  split.woff[n_layers] = off;
  return true;
}

bool tiles_ok(int B, int N, int M, int S, int T, int R) {
  if (B < 1 || N < 1 || M < 1 || S < 1 || T < 1 || R < 1) return false;
  return !((S <= kRows && (R != 1 || T * S > kRows)) || (S > kRows && (T != 1 || R * kRows < S)));
}

int split_blocks(const Split& split) {
  const long long off = split.woff[split.n];
  return static_cast<int>((off + 255) / 256 < 1024 ? (off + 255) / 256 : 1024);
}

}  // namespace

extern "C" {

// Launches the weight split and the 3xTF32 fused SA MLP + max-pool on
// `stream`. h_all (B, N, w0) f32, idx (B, M, S) int32, sh0 (B, M, w0) f32,
// s0 (w0,) f32; for each of the n_layers dense layers l, wt[l] (widths[l+1],
// widths[l]) f32 row-major (nn.Linear's weight), scale[l] and shift[l]
// (widths[l+1],) f32; out (B, M, widths[n_layers]) f32. The launch plan
// (ops/cuda/samlp.py samlp_plan): npad[l] (32, 64, 128 or 256) and kpad[l]
// (a multiple of 32, kpad[l+1] == npad[l]) per layer, T centres a tile
// (S <= 64) or R tiles a centre (S > 64), ks channels a weight slice (16
// or 32, dividing every kpad), `stages` ring stages, `grid` blocks. wsplit
// is scratch of sum(kpad[l] * npad[l]) x 8 bytes (two f32 terms). Returns
// the cudaError_t of the launches (cudaErrorInvalidValue for arguments out
// of range).
int votenet_samlp(const float* h_all, const int* idx, const float* sh0, const float* s0,
                  const void* const* wt, const void* const* scale, const void* const* shift,
                  const int* widths, const int* npad, const int* kpad, int n_layers, int B, int N, int M,
                  int S, int T, int R, int ks, int stages, int grid, void* wsplit, float* out, void* stream) {
  Chain chain;
  Split split;
  if ((ks != 16 && ks != 32) || stages < 2 || stages > kMaxStages || grid < 1 || !tiles_ok(B, N, M, S, T, R) ||
      !chain_args(wt, scale, shift, widths, npad, kpad, n_layers, ks, false, chain, split))
    return cudaErrorInvalidValue;
  int kb_max = 0, np_max = 0, n_aff = kpad[0];
  for (int l = 0; l < n_layers; ++l) {
    kb_max = kpad[l] / 8 > kb_max ? kpad[l] / 8 : kb_max;
    np_max = npad[l] > np_max ? npad[l] : np_max;
    n_aff += 2 * npad[l];
  }
  const int stage_bytes = np_max * ks * 8;
  const int pool_ld = npad[n_layers - 1];
  const size_t smem = static_cast<size_t>(stages) * stage_bytes +
                      static_cast<size_t>(kConsumerWGs) * kb_max * 128 * 16 +
                      static_cast<size_t>(kConsumerWGs) * T * pool_ld * 4 + static_cast<size_t>(n_aff) * 4 +
                      2 * kMaxStages * 8;
  const cudaError_t attr =
      cudaFuncSetAttribute(samlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  samlp_split_weights<<<split_blocks(split), 256, 0, s>>>(split, static_cast<float*>(wsplit));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items_per_row = S <= kRows ? (M + T - 1) / T : M;
  samlp_kernel<<<grid, kThreads, smem, s>>>(h_all, idx, sh0, s0, static_cast<const uint8_t*>(wsplit), chain, N, M,
                                            S, T, R, items_per_row, B * items_per_row, ks, stages, stage_bytes,
                                            kb_max, pool_ld, out);
  return cudaGetLastError();
}

// Launches the weights' rounding and the bf16-operand fused SA MLP +
// max-pool on `stream`: the arguments as votenet_samlp's, with kpad[0] a
// power of two (32 to 256), ks 32 or 64 (dividing every kpad), stages 0
// (the chain resident in shared memory) or 2-4 (the ring), `slots` staged
// tiles (2 to 8), `chunk` 0 (a bulk copy a staged row: w0 * 4 and the
// addresses of h_all and sh0 multiples of 16) or the staging's cp.async
// bytes (8 or 4, dividing them), wsplit scratch of sum(kpad[l] * npad[l]) x
// 2 bytes and a row of zeros (1 KB).
int votenet_samlp_bf16(const float* h_all, const int* idx, const float* sh0, const float* s0,
                       const void* const* wt, const void* const* scale, const void* const* shift,
                       const int* widths, const int* npad, const int* kpad, int n_layers, int B, int N, int M,
                       int S, int T, int R, int ks, int stages, int grid, int slots, int chunk, void* wsplit,
                       float* out, void* stream) {
  Chain chain;
  Split split;
  if ((ks != 32 && ks != 64) || stages == 1 || stages < 0 || stages > kMaxStages || grid < 1 || slots < 2 ||
      slots > kMaxSlots || (chunk != 0 && chunk != 4 && chunk != 8) || !tiles_ok(B, N, M, S, T, R) ||
      !chain_args(wt, scale, shift, widths, npad, kpad, n_layers, ks, true, chain, split))
    return cudaErrorInvalidValue;
  const int align = chunk == 0 ? 16 : chunk;
  if ((widths[0] * 4) % align != 0 || reinterpret_cast<uintptr_t>(h_all) % align != 0 ||
      reinterpret_cast<uintptr_t>(sh0) % align != 0)
    return cudaErrorInvalidValue;
  const Bf16Smem lay = bf16_smem(chain, T, ks, stages, slots);
  const cudaError_t attr =
      cudaFuncSetAttribute(samlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.total));
  if (attr != cudaSuccess) return attr;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  samlp_round_weights<<<split_blocks(split), 256, 0, s>>>(split, static_cast<__nv_bfloat16*>(wsplit));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items_per_row = S <= kRows ? (M + T - 1) / T : M;
  samlp_bf16_kernel<<<grid, kThreads, lay.total, s>>>(h_all, idx, sh0, s0, static_cast<const uint8_t*>(wsplit),
                                                      chain, N, M, S, T, R, items_per_row, B * items_per_row, ks,
                                                      stages, slots, chunk, out);
  return cudaGetLastError();
}

}  // extern "C"
