// Oriented 3D box IoU matrix on Hopper (sm_90a).
//
// The port's own kernel: the JAX package computes the NMS IoU matrix in
// XLA (votenet_tpu/ops/iou3d.py:329-353, box3d_iou_pairwise and
// box3d_iou_matrix; no Pallas kernel). On the card the port's eager version
// of it takes ~2.5 ms at B = 8, N = 256 in some 60 passes over (B, N, N, 4,
// 4) intermediates, and its torch.sum reductions would add in an order that
// depends on the device. This kernel computes every pair in registers, in
// the order the plain version (votenet_tpu_torch/ops/iou3d.py) states.
//
// What it computes: out[b, i, j] = IoU(c1[b, i], c2[b, j]) for corners
// (B, N, 8, 3) and (B, M, 8, 3): the exact intersection area of the two
// top-face (x, z) quads by edge clipping (each edge of one quad clipped to
// the other's four half-planes by interval arithmetic, the shoelace
// integral summed over the clipped segments), times the y overlap, over the
// union volume; 0 where the union is at most 1e-12.
//
// Exactness: the result equals the plain version's float for float. Every
// product, sum and difference is one IEEE rounding (__fmul_rn, __fadd_rn,
// __fsub_rn, and -fmad=false besides), the division is __fdiv_rn, the four
// edges' and four planes' terms are added as ((t0 + t1) + t2) + t3, which
// is what the plain version writes out, and max, min, abs and the compares
// round nothing. The 1e-12 tolerance is compared in f32, as PyTorch
// compares a tensor with a Python float. A box's edge vectors, signed area,
// sign and volume are the same operations on the same floats whether
// computed once a box (here) or once a pair (the plain version).
//
// Symmetry: box_iou(P, Q) == box_iou(Q, P) bit for bit: the two boundary
// sums swap places in one commutative addition, min and max are
// symmetric, and so is vol1 + vol2. So for the self-matrix (c1 and c2 the
// same memory, as NMS calls it) the kernel computes the pairs i <= j only
// and writes each float to both halves: N (N + 1) / 2 pairs, not N^2.
//
// What bounds it (NVIDIA H100 80GB HBM3): operations. A pair costs 941
// f32 operations (two boundary sums of 16 edge-plane clips each, one
// division a clip; chip_smoke.py IOU_PAIR_OPS), so the self-matrix at B =
// 8, N = 256 is 8 x 32896 pairs, ~0.25 G operations, 3.7 us at the 67
// TFLOP/s f32 peak, while the output is 2 MiB (~0.6 us at 3.35 TB/s). The
// divisions are IEEE (~10 instructions each), so the issue rate of the
// ~1,300 non-FMA instructions a pair sets the floor, near 10 us for the
// triangle at B = 8.
//
// Design: a block takes a tile of kTile rows by kTile columns, one pair a
// thread. The tile's boxes are staged once in shared memory with what every
// pair of them needs (the quad, its edge vectors, the y range, the signed
// area, its sign and the volume: 21 floats), so that no pair loads or
// recomputes a box. For the self-matrix the grid walks the tiles on and
// above the diagonal; a diagonal tile computes its upper triangle, and each
// tile's floats go out twice: in place, and transposed through shared
// memory, so that both writes are coalesced.
//
// The head's launch (decode_iou_kernel, models/decode.py::predict_boxes):
// the decode (csrc/decode.cuh, the decode kernel's order) inside the
// self-matrix's tiles. A tile stages its 16 + 16 proposals' head channels
// (~10 KB at C = 79), decodes each into a Box from its corners, and a
// diagonal tile also writes the decode's outputs; so a box is decoded once
// a tile it takes part in (~16 times at N = 256: ~6 M f32 operations at B =
// 8, far below the pairs' 0.25 G), and the head is this launch and the NMS
// greedy's. The decode kernel stays for callers that want the decode alone.
// Each tile's staging and decode are the fused launch's cost over the IoU
// kernel's: at N = 1025-4096 (no path sends them) it is slower than the
// decode kernel and the IoU kernel's two launches (PERF.md).

#include <cuda_runtime.h>

#include <cstddef>

#include "decode.cuh"

namespace {

constexpr int kTile = 16;  // rows and columns of a tile, one pair a thread
constexpr int kThreads = kTile * kTile;
constexpr float kEps = 1e-12f;

struct Box {
  float x[4], z[4];    // the top face's corners 0-3 in (x, z)
  float dx[4], dz[4];  // its edges, corner k to corner k + 1
  float yt, yb;        // corner 0's and corner 4's y
  float area, sgn;     // the quad's signed shoelace area and its sign
  float vol;           // |area| * (yt - yb)
};

__device__ __forceinline__ float sum4(float t0, float t1, float t2, float t3) {
  return __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
}

__device__ __forceinline__ float sign_of(float a) { return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : 0.0f); }

__device__ __forceinline__ void load_box(const float* __restrict__ c, Box& b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.x[k] = c[3 * k];
    b.z[k] = c[3 * k + 2];
  }
  b.yt = c[1];
  b.yb = c[13];
  float t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = (k + 1) & 3;
    b.dx[k] = __fsub_rn(b.x[n], b.x[k]);
    b.dz[k] = __fsub_rn(b.z[n], b.z[k]);
    t[k] = __fsub_rn(__fmul_rn(b.x[k], b.z[n]), __fmul_rn(b.x[n], b.z[k]));
  }
  b.area = __fmul_rn(0.5f, sum4(t[0], t[1], t[2], t[3]));
  b.sgn = sign_of(b.area);
  b.vol = __fmul_rn(fabsf(b.area), __fsub_rn(b.yt, b.yb));
}

// Sum of cross(x0, x1) over A's edges clipped to the inside of B (sb: B's
// orientation sign), edges added in order 0-3.
__device__ __forceinline__ float boundary_contrib(const Box& A, const Box& B, float sb) {
  float cr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ax = A.x[i], az = A.z[i];
    const float dx = A.dx[i], dz = A.dz[i];
    float lo[4], hi[4];
    bool dead = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ex = B.dx[j], ez = B.dz[j];
      const float amx = __fsub_rn(ax, B.x[j]), amz = __fsub_rn(az, B.z[j]);
      const float c0 = __fmul_rn(sb, __fsub_rn(__fmul_rn(ex, amz), __fmul_rn(ez, amx)));
      const float c1 = __fmul_rn(sb, __fsub_rn(__fmul_rn(ex, dz), __fmul_rn(ez, dx)));
      const bool pos = c1 > kEps;
      const bool neg = c1 < -kEps;
      const float t = __fdiv_rn(-c0, (pos || neg) ? c1 : 1.0f);
      lo[j] = pos ? t : 0.0f;
      hi[j] = neg ? t : 1.0f;
      dead = dead || (!pos && !neg && c0 < -kEps);
    }
    float l = fmaxf(fmaxf(fmaxf(lo[0], lo[1]), lo[2]), lo[3]);
    float h = fminf(fminf(fminf(hi[0], hi[1]), hi[2]), hi[3]);
    l = fminf(fmaxf(l, 0.0f), 1.0f);
    h = fminf(fmaxf(h, 0.0f), 1.0f);
    const bool valid = h > l && !dead;
    const float x0 = __fadd_rn(ax, __fmul_rn(l, dx)), z0 = __fadd_rn(az, __fmul_rn(l, dz));
    const float x1 = __fadd_rn(ax, __fmul_rn(h, dx)), z1 = __fadd_rn(az, __fmul_rn(h, dz));
    const float c = __fsub_rn(__fmul_rn(x0, z1), __fmul_rn(x1, z0));
    cr[i] = valid ? c : 0.0f;
  }
  return sum4(cr[0], cr[1], cr[2], cr[3]);
}

__device__ __forceinline__ float box_iou(const Box& P, const Box& Q) {
  const float bp = boundary_contrib(P, Q, Q.sgn);
  const float bq = boundary_contrib(Q, P, P.sgn);
  const float area = __fmul_rn(0.5f, __fadd_rn(__fmul_rn(P.sgn, bp), __fmul_rn(Q.sgn, bq)));
  const float cap = fminf(fabsf(P.area), fabsf(Q.area));
  const float inter = fminf(fmaxf(area, 0.0f), cap);
  const float y_overlap = fmaxf(__fsub_rn(fminf(P.yt, Q.yt), fmaxf(P.yb, Q.yb)), 0.0f);
  const float inter_vol = __fmul_rn(inter, y_overlap);
  const float denom = __fsub_rn(__fadd_rn(P.vol, Q.vol), inter_vol);
  return denom > kEps ? __fdiv_rn(inter_vol, denom) : 0.0f;
}

// Tile t of the self-matrix's triangle, tiles (ti, tj) with ti <= tj
// walked row by row over `tiles` tiles a side (ops/cuda/iou3d.py::self_tiles
// transcribes the walk)
__device__ __forceinline__ void self_tile(int t, int tiles, int& ti, int& tj) {
  ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  tj = ti + t;
}

// The pairs of tile (ti, tj) from its staged boxes, one a thread: out[b, i,
// j] for the live pairs and, for the self-matrix (kSelf: the triangle's
// tiles, a diagonal tile's upper triangle), out[b, j, i] too
template <bool kSelf>
__device__ __forceinline__ void tile_pairs(const Box (&rows)[kTile], const Box (&cols)[kTile],
                                           float (&mirror)[kTile][kTile + 1], int b, int ti, int tj, int N, int M,
                                           float* __restrict__ out) {
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tid = threadIdx.x;
  const int r = tid / kTile, c = tid % kTile;
  const int i = i0 + r, j = j0 + c;
  const bool live = i < N && j < M && (!kSelf || ti != tj || r <= c);
  const float v = live ? box_iou(rows[r], cols[c]) : 0.0f;
  if (live) out[(static_cast<size_t>(b) * N + i) * M + j] = v;
  if (kSelf) {  // the transposed tile: out[j0 + r, i0 + c] = IoU(i0 + c, j0 + r), from thread (c, r)
    mirror[c][r] = v;
    __syncthreads();
    const int mi = j0 + r, mj = i0 + c;
    if (mi < N && mj < N && (ti != tj || r > c)) out[(static_cast<size_t>(b) * N + mi) * N + mj] = mirror[r][c];
  }
}

// kSelf: c1 == c2 (N == M); blockIdx.x walks the tiles (ti, tj), ti <= tj,
// row by row. Otherwise blockIdx.x = ti * tiles_m + tj over every tile.
template <bool kSelf>
__global__ void __launch_bounds__(kThreads)
    iou3d_kernel(const float* __restrict__ c1, const float* __restrict__ c2, int N, int M, int tiles_m,
                 float* __restrict__ out) {
  __shared__ Box rows[kTile], cols[kTile];
  __shared__ float mirror[kTile][kTile + 1];
  const int b = blockIdx.y;
  int ti, tj;
  if (kSelf) {
    self_tile(blockIdx.x, tiles_m, ti, tj);
  } else {
    ti = blockIdx.x / tiles_m;
    tj = blockIdx.x % tiles_m;
  }
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tid = threadIdx.x;
  if (tid < kTile) {
    if (i0 + tid < N) load_box(c1 + (static_cast<size_t>(b) * N + i0 + tid) * 24, rows[tid]);
  } else if (tid < 2 * kTile) {
    const int j = j0 + tid - kTile;
    if (j < M) load_box(c2 + (static_cast<size_t>(b) * M + j) * 24, cols[tid - kTile]);
  }
  __syncthreads();
  tile_pairs<kSelf>(rows, cols, mirror, b, ti, tj, N, M, out);
}

// The detection head's decode and the self-matrix of its boxes in one
// launch: tile (ti, tj) of the triangle copies its 16 + 16 proposals' head
// channels into shared memory (coalesced, as the decode kernel does); warp
// 0 decodes them, a proposal a lane, in the order of csrc/decode.cuh, and
// forms each Box from the corners as load_box does, while the other warps
// wait and the SM's other CTAs compute their pairs; the diagonal tiles, in
// which each proposal lies exactly once, write the decode's outputs. The
// pairs are bound by issue slots, so the decode takes as few as it can: one
// warp, its latency hidden by the other CTAs (8 lanes a proposal, each
// argmax shuffled and each corner a lane, was slower at B = 8: PERF.md).
// 4 CTAs an SM: iou3d_kernel's registers.
__global__ void __launch_bounds__(kThreads, 4)
    decode_iou_kernel(const float* __restrict__ head, const float* __restrict__ xyz,
                      const float* __restrict__ mean_size, int N, int C, int NH, int NS, int NC,
                      float heading_scale, int tiles, DecodeOut dout, float* __restrict__ out) {
  extern __shared__ float chans[];  // 2 x kTile rows of C channels: the tile's rows' proposals, then its columns'
  __shared__ Box rows[kTile], cols[kTile];
  __shared__ float mirror[kTile][kTile + 1];
  __shared__ float corners[2 * kTile][24];
  const int b = blockIdx.y;
  int ti, tj;
  self_tile(blockIdx.x, tiles, ti, tj);
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int nr = min(kTile, N - i0), nc = min(kTile, N - j0);
  const float* src_r = head + (static_cast<size_t>(b) * N + i0) * C;
  const float* src_c = head + (static_cast<size_t>(b) * N + j0) * C;
  for (int k = threadIdx.x; k < nr * C; k += kThreads) chans[k] = src_r[k];
  for (int k = threadIdx.x; k < nc * C; k += kThreads) chans[kTile * C + k] = src_c[k];
  __syncthreads();
  if (threadIdx.x < 2 * kTile) {  // warp 0: a proposal a lane, a row's, then a column's
    const int box = threadIdx.x;
    const bool is_row = box < kTile;
    const int slot = is_row ? box : box - kTile;
    if (slot < (is_row ? nr : nc)) {
      const float* o = chans + box * C;
      const size_t p = static_cast<size_t>(b) * N + (is_row ? i0 : j0) + slot;
      const int hc = argmax_first(o + 5, NH);
      const int sc = argmax_first(o + 5 + 2 * NH, NS);
      const int cc = argmax_first(o + C - NC, NC);
      Pose ps;
      decode_pose(o, xyz + 3 * p, mean_size, NH, NS, hc, sc, heading_scale, ps);
      for (int k = 0; k < 8; ++k) decode_corner(ps, k, corners[box] + 3 * k);
      if (is_row && ti == tj) {  // the decode's outputs, once a proposal
        for (int k = 0; k < 24; ++k) dout.corners[24 * p + k] = corners[box][k];
        for (int k = 0; k < 3; ++k) {
          dout.center[3 * p + k] = ps.center[k];
          dout.size[3 * p + k] = ps.size[k];
        }
        dout.heading[p] = ps.heading;
        dout.nms_score[p] = o[C - NC + cc];
        dout.size_cls[p] = sc;
        dout.heading_cls[p] = hc;
      }
      load_box(corners[box], is_row ? rows[slot] : cols[slot]);
    }
  }
  __syncthreads();
  tile_pairs<true>(rows, cols, mirror, b, ti, tj, N, N, out);
}

}  // namespace

extern "C" {

// Launches the IoU matrix on `stream`: c1 (B, N, 8, 3) and c2 (B, M, 8, 3)
// f32, contiguous, -> out (B, N, M) f32. c1 == c2 with N == M (the same
// memory) takes the self-matrix's triangle. Returns the cudaError_t of the
// launch; shapes past the grid's limits (B above 65535) are
// cudaErrorInvalidValue.
int votenet_iou3d(const float* c1, const float* c2, int B, int N, int M, float* out, void* stream) {
  if (B < 1 || N < 1 || M < 1 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tn = (N + kTile - 1) / kTile, tm = (M + kTile - 1) / kTile;
  if (c1 == c2 && N == M) {
    iou3d_kernel<true><<<dim3(static_cast<unsigned>(tn * (tn + 1) / 2), B), kThreads, 0, st>>>(
        c1, c2, N, M, static_cast<int>(tm), out);
  } else {
    iou3d_kernel<false><<<dim3(static_cast<unsigned>(tn * tm), B), kThreads, 0, st>>>(
        c1, c2, N, M, static_cast<int>(tm), out);
  }
  return cudaGetLastError();
}

// Launches the head's decode and the IoU self-matrix of its corners on
// `stream`: head (B, N, C), xyz (B, N, 3) and mean_size (NS, 3) f32,
// contiguous; the decode's outputs as votenet_decode's (B * N proposals)
// and out (B, N, N) f32, equal to votenet_decode followed by votenet_iou3d
// on the corners twice. `tiles` is ceil(N / 16) and `grid` the triangle's
// tiles, tiles (tiles + 1) / 2 (ops/cuda/iou3d.py::self_tiles). Returns the
// cudaError_t of the launch.
int votenet_decode_iou(const float* head, const float* xyz, const float* mean_size, int B, int N, int C, int NH,
                       int NS, int NC, float heading_scale, int tiles, long long grid, float* corners, float* center,
                       float* size, float* heading, float* nms_score, int* size_cls, int* heading_cls, float* out,
                       void* stream) {
  if (B < 1 || N < 1 || B > 65535 || !decode_shape_ok(C, NH, NS, NC) || tiles != (N + kTile - 1) / kTile ||
      grid != static_cast<long long>(tiles) * (tiles + 1) / 2)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(kTile) * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(decode_iou_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_iou_kernel<<<dim3(static_cast<unsigned>(grid), B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      head, xyz, mean_size, N, C, NH, NS, NC, heading_scale, tiles,
      DecodeOut{corners, center, size, heading, nms_score, size_cls, heading_cls}, out);
  return cudaGetLastError();
}

}  // extern "C"
