// Shared device code of the NMS kernels (csrc/nms_seq.cu, csrc/nms_fixpoint.cu).
//
// Every kernel is held to one greedy mask, bit for bit, against the plain
// PyTorch versions, so the IoU is written here once. It rounds where the
// reference rounds (explicit _rn intrinsics, and every file is compiled with
// -fmad=false), in the reference's operation order:
//   area = max(x2-x1,0)*max(y2-y1,0); ix = max(min(x2i,x2j)-max(x1i,x1j),0);
//   union = (area_i+area_j)-inter; iou = inter/max(union,1e-9f);  iou > t.
//
// build_bits computes one image's suppression bits M[i][j] = i < j < K and
// iou(i,j) > t with the whole CTA. The strict upper triangle is cut into 32x32
// tiles (w, t), t >= w: rows 32w..32w+31, columns 32t..32t+31, and each tile
// into 4 slices of 8 rows. Warp g takes slices g, g + warps, ...; in a slice,
// lane l owns column j = 32t + l and walks the slice's rows, whose box every
// lane reads at one shared address (a broadcast). At K=256 that is 144
// slices over 32 warps, at most 40 IoUs in a row for any warp, and no warp
// is left to run a last unit alone. The same loop gives either layout:
//   Rows:  R[i * W + t], bit l = M[i][32t + l]  (one ballot per row)
//   Cols:  C[w * Kp + j], bit r = M[32w + r][j] (each lane ORs its bits, then
//          one shared-memory atomicOr per slice; the caller zeroes C first)
// with W = ceil(K/32) words and Kp = 32W. Every row word of a tile is
// written, zeros included, so rows and columns past K read as empty.
//
// greedy_rows runs the sequential greedy over one image's row words on one
// warp, a 32-bit word at a time, with no IoU and no barrier in its loop.
//
// Sizes: the CTA has one warp per slice, at most 32 warps (build_threads); the
// words take 4*W*Kp bytes of shared memory, 8 KB at K=256 and 128 KB at
// K=1024 (above 48 KB a launch needs allow_smem).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nms {

constexpr int kMaxK = 1024;                // 32 words of 32 candidates
constexpr int kMaxThreads = 1024;          // 32 warps: every kernel's __launch_bounds__
constexpr size_t kMaxSmem = 232448;        // per-CTA opt-in limit on sm_90
constexpr uint32_t kFull = 0xffffffffu;

enum class Layout { kRows, kCols };

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b, float area_b) {
  const float ix = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float iy = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(ix, iy);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // A zero dividend (boxes that do not meet) sends __fdiv_rn to its slow path
  // (FCHK flags exponent 0), which costs the whole warp; 0/u is that zero.
  return inter == 0.f ? inter : __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__host__ __device__ __forceinline__ int num_words(int K) { return (K + 31) >> 5; }

__host__ __device__ __forceinline__ int num_tiles(int W) { return W * (W + 1) / 2; }

// Threads of a CTA that builds the bits of K candidates: one warp per slice,
// at most 32 warps. Never fewer than Kp = 32W, since 4W(W+1)/2 >= W.
__host__ __device__ __forceinline__ int build_threads(int K) {
  const int slices = 4 * num_tiles(num_words(K));
  return 32 * (slices < 32 ? slices : 32);
}

// One image's boxes and areas into shared memory, zeros from K up to Kp.
__device__ __forceinline__ void load_boxes(const float4* __restrict__ boxes, float4* sbox,
                                           float* sarea, int K, int Kp) {
  for (int j = threadIdx.x; j < Kp; j += blockDim.x) {
    const float4 b = j < K ? boxes[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    sbox[j] = b;
    sarea[j] = box_area(b);
  }
}

// The suppression bits of one image (see the top of this file). Reads sbox and
// sarea after a barrier; the caller syncs again before it reads `bits`.
template <Layout L>
__device__ __forceinline__ void build_bits(const float4* sbox, const float* sarea,
                                           uint32_t* bits, int K, float thresh) {
  constexpr int kRows = 8;  // rows of a slice; 4 slices a tile
  const int W = num_words(K);
  const int Kp = W << 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int u = threadIdx.x >> 5; u < 4 * num_tiles(W); u += warps) {
    int w = 0;
    int t = u >> 2;  // tile u/4 is (w, t): row w holds tiles t = w..W-1
    while (t >= W) {
      t -= W - w - 1;
      ++w;
    }
    const int i0 = w << 5;
    const int j = (t << 5) + lane;
    const int cols = min(32, K - (t << 5));
    // rows past K meet no column; row r of a diagonal tile meets only l > r
    const int rows = t == w ? min(32, cols - 1) : min(32, K - i0);
    const int r0 = (u & 3) * kRows;
    const int r1 = min(r0 + kRows, rows);
    const float4 bj = sbox[j];
    const float aj = sarea[j];
    uint32_t word = 0u;
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const int i = i0 + r;
      const bool over = box_iou(sbox[i], sarea[i], bj, aj) > thresh;
      const bool hit = over && i < j && lane < cols;
      if constexpr (L == Layout::kRows) {
        const uint32_t row = __ballot_sync(kFull, hit);
        if (lane == r - r0) word = row;
      } else {
        word |= static_cast<uint32_t>(hit) << r;
      }
    }
    if constexpr (L == Layout::kRows) {
      if (lane < kRows) bits[(i0 + r0 + lane) * W + t] = word;
    } else if (word) {
      atomicOr(&bits[w * Kp + j], word);
    }
  }
}

// The sequential greedy over one image's row words R (build_bits<kRows>) on
// one warp. Lane s passes alive word s (0 for s >= W) and gets keep word s
// back. For block b it resolves the block's own word in registers from its 32
// diagonal row words (in score order: that is the greedy exactly), then every
// lane s > b clears the OR of R[32b+k][s] over the block's kept k, all its
// loads in flight at once: W short steps, whatever the number of live anchors.
__device__ __forceinline__ uint32_t greedy_rows(const uint32_t* rows, uint32_t alive, int W) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < W; ++b) {
    const int i0 = b << 5;
    // lane k: row i0+k's bits in block b (bits only for columns past the row)
    const uint32_t diag = rows[(i0 + lane) * W + b];
    uint32_t kept = __shfl_sync(kFull, alive, b);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t dk = __shfl_sync(kFull, diag, k);
      if ((kept >> k) & 1u) kept &= ~dk;
    }
    uint32_t sup = 0u;
    if (lane > b && lane < W) {
#pragma unroll
      for (int k = 0; k < 32; ++k)  // predicated loads, all in flight at once
        if ((kept >> k) & 1u) sup |= rows[(i0 + k) * W + lane];
    }
    alive = lane == b ? kept : (alive & ~sup);
  }
  return alive;
}

// The dynamic shared memory a kernel asks for; above 48 KB it must opt in.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace nms
