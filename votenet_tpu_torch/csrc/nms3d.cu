// Greedy oriented 3D NMS on Hopper (sm_90a): the priority order, the
// candidates and the walk, on the card, in one launch.
//
// The port's own kernel: the JAX package has no Pallas kernel for NMS. Its
// votenet_tpu/ops/nms3d.py:40-58 `_jacobi_greedy` iterates a fixpoint in a
// lax.while_loop on the device after a stable argsort of the scores; the
// port's plain version is the same argsort and fixpoint in PyTorch, which
// must ask the host after every round whether anything changed (one sync a
// round). This kernel replaces all of it on a CUDA tensor: no round trip to
// the host, no sort launched before it.
//
// What it computes, for each batch row (one CTA): the candidates cand[i] =
// objectness[i, 1] > objectness[i, 0]; the priority order, score
// descending, then index ascending, with every NaN score above every number
// and the NaNs among themselves by index, and -0 equal to +0: exactly the
// permutation torch.argsort(scores, descending=True, stable=True) gives on
// the CPU (tests/test_torch_nms.py transcribes the rule); then the greedy:
// walking the order, box i is kept iff cand[i] and no kept box j before it
// has iou[j, i] > thr. That is the fixpoint of "kept = cand & ~any(kept &
// supp)" which the Jacobi loop reaches (votenet_tpu/ops/nms3d.py:40-45:
// "exactly the greedy solution").
//
// Design, up to kMaxBoxes boxes a row (one CTA of 1024 threads a row, a
// thread a box):
// - Candidates first. A box that is no candidate is never kept and
//   suppresses nothing, so the kernel writes its keep bit at once and works
//   on the Nc candidates alone, compacted by a ballot a word and a prefix
//   count: the rank, the bit rows and the walk shrink with them (at N = 256
//   about half the boxes are candidates on the serving and eval paths).
// - Order. Each candidate gets a 64-bit key, its score's order-preserving
//   bits above its complemented index, so that "j before i" is key[j] >
//   key[i]; its rank counts the keys above it. kThreads / Nc threads share
//   a candidate (at most 32, a power of two), each counting every S-th key,
//   summed by shuffles; ord[rank] = the box.
// - Bits in order space. Row p (the candidate at position p) holds bit q of
//   word q / 32 iff q > p and iou[ord[p], ord[q]] > thr: a lane reads
//   iou[ord[p], ord[q]] for q = 32 w + lane and a ballot makes word w. Only
//   words w >= p / 32 are needed, so a row reads only its upper triangle;
//   a warp keeps kTasks (row, word) loads in flight. diag[p] = row p's word
//   p / 32: the chunk's diagonal block, contiguous.
// - The walk in chunks of 32 positions, one warp, lane w holding word w of
//   the running `blocked` mask. For chunk c: alive = the chunk's positions
//   not blocked (word c, one shuffle); the 32 x 32 diagonal block is loaded
//   into registers as 32 uniform words and the chunk's 32 positions are
//   resolved by a register-only chain, "if position k is alive, clear the
//   bits its row suppresses"; the survivors are kept, and lane w > c ORs
//   their rows' word w into `blocked`. 256 boxes are at most 8 chunks of
//   register steps in place of 256 dependent shared-memory steps.
//
// Rows of more than kMaxBoxes boxes (the JAX package answers for any
// Config.proposal_num: votenet_tpu/ops/nms3d.py:91-147) take a second
// route, three launches over a global-memory workspace (allocated by the
// caller): nms_rank_kernel writes each row's order and candidates (many
// CTAs a row, the same keys), nms_pack_kernel packs the bit rows by box
// index with one warp a row and many CTAs a batch row, and nms_walk_kernel
// walks the order with one warp a batch row, `blocked` in shared memory (W
// words) and a kept box's row ORed in from the workspace, W / 32 words a
// lane. Those bit rows leave out the order test: a kept box's bits for
// boxes before it in the order fall on boxes already decided, whose
// `blocked` bits are never read again, so they change no decision.
//
// What bounds it (NVIDIA H100 80GB HBM3): the bytes, the scores and
// objectness read once and the keep mask written (13 bytes a box), and the
// IoUs the candidates' rows need, the upper triangle among the candidates
// in the order (at most B * N * (N - 1) / 2 floats: ~0.3 us at B = 8, N =
// 256, at 3.35 TB/s). The design is held above that by one CTA a batch row:
// the launch, a row's gathered IoU reads all through one SM's path to L2,
// the rank's Nc^2 compares on one SM and the walk's chain of dependent
// register steps (32 a chunk), which no parallelism across rows shortens.
//
// Exactness: the threshold test is the only float operation, `iou > thr`
// in f32, with thr the f32 rounding of the Python threshold, as PyTorch's
// comparison with a Python scalar rounds it; the order and the candidates
// are comparisons, equal to the plain version's by construction.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // 32 warps a CTA: the ranks and the packing's rows in parallel
constexpr int kMaxBoxes = 1024; // 32 words a row: one word a lane of the walking warp
constexpr int kBatch = 8;       // words of a row whose loads a lane issues before their ballots (long rows)
constexpr int kTasks = 16;      // (row, word) tasks whose loads a lane issues before their ballots
static_assert(kMaxBoxes <= kThreads, "the one-launch route takes one box a thread");
constexpr unsigned kFull = 0xffffffffu;

// Score bits whose unsigned order is the priority's: every NaN at the top
// (all equal), -0 as +0, the sign flipped or the bits complemented.
__device__ __forceinline__ uint32_t score_bits(float s) {
  if (s != s) return 0xffffffffu;
  const uint32_t u = s == 0.0f ? 0u : __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// key[j] > key[i] iff j comes before i: score bits above the complemented index
__device__ __forceinline__ unsigned long long order_key(float s, int i) {
  return (static_cast<unsigned long long>(score_bits(s)) << 32) | (0xffffffffu - static_cast<uint32_t>(i));
}

__device__ __forceinline__ bool is_candidate(const float* obj, long long sb, long long sn, int b, int i) {
  const float* o = obj + b * sb + i * sn;
  return o[1] > o[0];
}

__global__ void __launch_bounds__(kThreads)
    nms_greedy_kernel(const float* __restrict__ iou, const float* __restrict__ scores,
                      const float* __restrict__ obj, long long osb, long long osn, int N, float thr,
                      uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = (N + 31) / 32;
  uint32_t* diag = smem;                                   // 32 * W words: diag[p] = row p's word p / 32
  unsigned long long* key = reinterpret_cast<unsigned long long*>(diag + 32 * W);  // the candidates' keys
  uint32_t* bits = diag + 32 * W + 2 * N;                  // Nc rows of Wc words, by candidate position
  int* ord = reinterpret_cast<int*>(bits + N * W);         // ord[p]: the box at candidate position p
  uint32_t* cw = reinterpret_cast<uint32_t*>(ord + N);     // W words: bit i of word i / 32, box i a candidate

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(b) * N;

  // one box a thread (N <= kThreads): the candidates, one ballot a word, and
  // their scores; a box that is no candidate is not kept
  const int i = 32 * warp + lane;
  const bool cand = i < N && is_candidate(obj, osb, osn, b, i);
  const float score = cand ? scores[row0 + i] : 0.0f;
  if (i < N && !cand) keep[row0 + i] = 0;
  const uint32_t ballot = __ballot_sync(kFull, cand);
  if (lane == 0 && warp < W) cw[warp] = ballot;
  __syncthreads();
  int Nc = 0;   // the candidates, the same count in every thread
  int pos = 0;  // the candidates in the warps before this one
  for (int c = 0; c < W; ++c) {
    const int n = __popc(cw[c]);
    if (c < warp) pos += n;
    Nc += n;
  }
  if (Nc == 0) return;
  // compaction: a candidate's key at its place among the candidates by index
  if (cand) key[pos + __popc(ballot & ((1u << lane) - 1u))] = order_key(score, i);
  __syncthreads();

  // ranks among the candidates: S threads (adjacent lanes) a candidate, each
  // counting every S-th key; the box's index comes back from its key
  int S = 1;
  while (S < 32 && 2 * S * Nc <= kThreads) S *= 2;
  for (int base = 0; base < Nc * S; base += kThreads) {  // uniform across each warp
    const int p = (base + tid) / S;
    const int part = (base + tid) % S;
    int cnt = 0;
    unsigned long long mine = 0ull;
    if (p < Nc) {
      mine = key[p];
      for (int j = part; j < Nc; j += S) cnt += key[j] > mine;
    }
    for (int o = S / 2; o > 0; o /= 2) cnt += __shfl_xor_sync(kFull, cnt, o);
    if (p < Nc && part == 0) ord[cnt] = static_cast<int>(0xffffffffu - static_cast<uint32_t>(mine));
  }
  __syncthreads();

  // pack: warp `warp` takes the rows warp + 32 r, row r's words r .. Wc - 1,
  // kTasks (row, word) tasks' loads in flight before their ballots
  const int Wc = (Nc + 31) / 32;
  const float* m = iou + row0 * N;
  const int R = warp < Nc ? (Nc - warp + 31) / 32 : 0;
  int r = 0, w = 0;
  while (r < R) {  // uniform across the warp
    int task[kTasks];
    float v[kTasks];
#pragma unroll
    for (int k = 0; k < kTasks; ++k) {
      task[k] = -1;
      v[k] = 0.0f;
      if (r < R) {
        const int p = warp + 32 * r;
        const int q = 32 * w + lane;
        if (q < Nc && q > p) v[k] = m[static_cast<size_t>(ord[p]) * N + ord[q]];
        task[k] = (r << 5) | w;
        if (++w == Wc) {
          ++r;
          w = r;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTasks; ++k) {
      if (task[k] >= 0) {
        const int tr = task[k] >> 5, tw = task[k] & 31;
        const int p = warp + 32 * tr;
        const int q = 32 * tw + lane;
        const uint32_t word = __ballot_sync(kFull, q < Nc && q > p && v[k] > thr);
        if (lane == 0) {
          bits[p * Wc + tw] = word;
          if (tw == tr) diag[p] = word;
        }
      }
    }
  }
  __syncthreads();

  // the walk: one warp, lane w holds word w of `blocked`
  if (warp != 0) return;
  uint32_t blocked = 0u;
  for (int c = 0; c < Wc; ++c) {
    const int n = min(32, Nc - 32 * c);
    uint32_t d[32];
    const uint4* dv = reinterpret_cast<const uint4*>(diag + 32 * c);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint4 t = dv[k];
      d[4 * k] = t.x;
      d[4 * k + 1] = t.y;
      d[4 * k + 2] = t.z;
      d[4 * k + 3] = t.w;
    }
    uint32_t alive = (n == 32 ? kFull : (1u << n) - 1u) & ~__shfl_sync(kFull, blocked, c);
#pragma unroll
    for (int k = 0; k < 32; ++k)  // position k alive: it is kept, and clears what its row suppresses
      if ((alive >> k) & 1u) alive &= ~d[k];
    const int q = 32 * c + lane;
    if (q < Nc) keep[row0 + ord[q]] = (alive >> lane) & 1u;
    if (lane > c && lane < Wc) {
      const uint32_t* rows = bits + 32 * c * Wc + lane;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if ((alive >> k) & 1u) blocked |= rows[k * Wc];
    }
  }
}

// Global route, pass 0: each box's rank (as above, one thread a box, many
// CTAs a row, the keys staged in shared memory a tile at a time) ->
// order[b, rank] = i, and cand[b, i].
constexpr int kRankThreads = 256;
constexpr int kRankTile = 2048;

__global__ void __launch_bounds__(kRankThreads)
    nms_rank_kernel(const float* __restrict__ scores, const float* __restrict__ obj, long long osb,
                    long long osn, int N, int* __restrict__ order, uint8_t* __restrict__ cand) {
  __shared__ unsigned long long tile[kRankTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * N;
  const unsigned long long mine = i < N ? order_key(scores[row0 + i], i) : 0ull;
  int cnt = 0;
  for (int j0 = 0; j0 < N; j0 += kRankTile) {
    const int n = min(kRankTile, N - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kRankThreads) tile[t] = order_key(scores[row0 + j0 + t], j0 + t);
    __syncthreads();
    for (int t = 0; t < n; ++t) cnt += tile[t] > mine;
  }
  if (i < N) {
    order[row0 + cnt] = i;
    cand[row0 + i] = is_candidate(obj, osb, osn, b, i);
  }
}

// Global route, pass 1: bits[b, j, w] bit l = iou[b, j, 32 w + l] > thr for
// every candidate j (a non-candidate's row is never read, so not written).
__global__ void __launch_bounds__(kThreads)
    nms_pack_kernel(const float* __restrict__ iou, const uint8_t* __restrict__ cand, int N, float thr,
                    uint32_t* __restrict__ bits) {
  const int W = (N + 31) / 32;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const size_t row0 = static_cast<size_t>(b) * N;
  if (j >= N || !cand[row0 + j]) return;  // uniform across the warp
  const float* mj = iou + (row0 + j) * N;
  uint32_t* out = bits + (row0 + j) * W;
  for (int w0 = 0; w0 < W; w0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = 32 * (w0 + k) + lane;
      v[k] = (w0 + k < W && i < N) ? mj[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (w0 + k < W) {  // uniform across the warp
        const int i = 32 * (w0 + k) + lane;
        const uint32_t word = __ballot_sync(kFull, i < N && v[k] > thr);
        if (lane == 0) out[w0 + k] = word;
      }
    }
  }
}

// Global route, pass 2: one warp a batch row walks the order; `blocked` is
// W words of shared memory. The order and the candidate flags come 32
// positions at a time, one a lane, and are passed round by shuffles.
__global__ void __launch_bounds__(32)
    nms_walk_kernel(const int* __restrict__ order, const uint8_t* __restrict__ cand,
                    const uint32_t* __restrict__ bits, int N, uint8_t* __restrict__ keep) {
  extern __shared__ uint32_t blocked[];
  const int W = (N + 31) / 32;
  const int lane = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * N;
  for (int w = lane; w < W; w += 32) blocked[w] = 0u;
  __syncwarp();
  for (int p0 = 0; p0 < N; p0 += 32) {
    const int p = p0 + lane;
    const int mine = p < N ? order[row0 + p] : 0;
    const int mine_c = p < N ? cand[row0 + mine] : 0;
    const int n = min(32, N - p0);
    for (int k = 0; k < n; ++k) {
      const int i = __shfl_sync(kFull, mine, k);
      const int c = __shfl_sync(kFull, mine_c, k);
      const bool kept = c && !((blocked[i >> 5] >> (i & 31)) & 1u);
      __syncwarp();  // every lane has read `blocked` before any lane writes it
      if (kept) {
        const uint32_t* r = bits + (row0 + i) * W;
        for (int w = lane; w < W; w += 32) blocked[w] |= r[w];
      }
      __syncwarp();
      if (lane == 0) keep[row0 + i] = kept ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// The workspace the route past kMaxBoxes needs, in 32-bit words (0 below):
// the bit rows (B * N * W), the order (B * N) and the candidates (B * N
// bytes).
long long votenet_nms3d_workspace_words(int B, int N) {
  if (N <= kMaxBoxes) return 0;
  const long long bn = static_cast<long long>(B) * N;
  return bn * ((N + 31) / 32) + bn + (bn + 3) / 4;
}

// Launches the greedy on `stream`: iou (B, N, N) f32 contiguous, scores (B,
// N) f32 contiguous, objectness (B, N, 2) f32 with strides (osb, osn, 1) in
// elements, keep (B, N) one byte a box (0 or 1). Up to kMaxBoxes boxes a
// row (1024, mirrored by ops/cuda/nms3d.py) one launch with everything in
// shared memory, `workspace` unused; above, three launches over
// `workspace` (votenet_nms3d_workspace_words). Returns the first
// cudaError_t.
int votenet_nms3d(const float* iou, const float* scores, const float* obj, long long osb, long long osn, int B,
                  int N, float thr, uint8_t* keep, uint32_t* workspace, void* stream) {
  if (B < 1 || N < 1 || B > 65535) return cudaErrorInvalidValue;
  const int W = (N + 31) / 32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > kMaxBoxes) {
    if (workspace == nullptr) return cudaErrorInvalidValue;
    const size_t bn = static_cast<size_t>(B) * N;
    uint32_t* bits = workspace;
    int* order = reinterpret_cast<int*>(bits + bn * W);
    uint8_t* cand = reinterpret_cast<uint8_t*>(order + bn);
    const int walk_smem = W * 4;
    cudaError_t err = cudaFuncSetAttribute(nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           walk_smem);
    if (err != cudaSuccess) return err;
    nms_rank_kernel<<<dim3((N + kRankThreads - 1) / kRankThreads, B), kRankThreads, 0, st>>>(
        scores, obj, osb, osn, N, order, cand);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    nms_pack_kernel<<<dim3((N + kThreads / 32 - 1) / (kThreads / 32), B), kThreads, 0, st>>>(iou, cand, N, thr,
                                                                                            bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    nms_walk_kernel<<<B, 32, walk_smem, st>>>(order, cand, bits, N, keep);
    return cudaGetLastError();
  }
  // diagonal words, keys, bit rows, order, candidate words
  const size_t smem = 4 * (32 * static_cast<size_t>(W) + 2 * N + static_cast<size_t>(N) * W + N + W);
  cudaError_t err = cudaFuncSetAttribute(nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_greedy_kernel<<<B, kThreads, smem, st>>>(iou, scores, obj, osb, osn, N, thr, keep);
  return cudaGetLastError();
}

}  // extern "C"
