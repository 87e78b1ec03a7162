// Sequential greedy NMS keep masks for Hopper (sm_90a): two kernels.
//
// Replace cvsd_tpu/ops/nms.py::_nms_kernel (behind nms_pallas, the NMS of
// detector.nms_method 'pallas_seq') and ::_nms_kernel_multi (behind
// nms_pallas_multi, G images per grid step).
//
// What both compute, per image b over its K score-sorted candidates:
//   alive_0[j] = alive_in[j] > 0.5
//   for i = 0..K-1:  if alive[i]: alive[j] = 0 for every j > i with iou(i,j) > t
//   keep[j] = alive[j] ? 1.0f : 0.0f                       (float32 0/1)
// which is the greedy-NMS keep mask (nms_seq_torch, the plain version).
//
// What bounds them: at B=128, K=256 they read 128*256*(16+4) B and write
// 128*256*4 B (about 0.8 MB) and need at most 4.2 M upper-triangle IoUs of
// ~12 FLOP plus one mask op each (about 54 MFLOP). Against 3.35 TB/s and
// 67 TFLOP/s FP32 that is under 1 us of bound, so launch latency, the IoU
// work of one CTA (each with an IEEE division) and the K dependent greedy
// steps set the time.
//
// What the designs do about it:
//   nms_seq_kernel — one CTA per image, no batch padding. The whole CTA (one
//     warp per 8-row slice of a 32x32 tile of the upper triangle, at most 32
//     warps) builds the suppression bits as row words R[i][t] in shared memory
//     (build_bits in nms_common.cuh: at K=256 no warp computes more than 40
//     IoUs in a row). After one barrier, warp 0 alone runs the greedy a word
//     at a time, lane s holding alive word s: for block b it resolves the
//     block's own word in registers from its 32 diagonal row words (in score
//     order: that is the greedy exactly), then every lane s > b clears the OR
//     of R[32b+k][s] over the block's kept k, all its loads in flight at once.
//     No CTA barrier per anchor: ceil(K/32) short steps, whatever the number
//     of live anchors. The other warps exit after the build.
//   nms_seq_multi_kernel — G images per CTA (the TPU kernel's grouping), one
//     warp per image and no barrier across warps. Lane l owns candidates
//     j = 32*s + l and keeps their alive flags as the bits s of one register;
//     alive[i] reaches every lane by __shfl_sync. IoUs are computed in the
//     loop, only for alive anchors and still-alive j > i, so shared memory
//     holds just the boxes and areas (20 B per candidate). The last CTA may
//     hold fewer than G images: its spare warps return at once.
//
// Bit-exactness: the masks must equal the plain version bit for bit; the IoU
// is nms_common.cuh's, shared with csrc/nms_fixpoint.cu.
//
// Limits: K <= 1024 (32 words; for the multi kernel 32 lane slots), the
// sequential kernel's shared memory 20*Kp + 128 + 4*W*Kp bytes (148 KB at
// K=1024); for the multi kernel G*32 <= 1024 threads and G*Kp*20 B of shared
// memory per CTA. The launchers allocate nothing and return
// cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

using nms::kFull;

// blockDim.x == nms::build_threads(K); one CTA per image.
// Shared layout: box[Kp] float4 | area[Kp] | alive[32] | R[Kp][W] row words.
__global__ void __launch_bounds__(nms::kMaxThreads, 1)
    nms_seq_kernel(const float4* __restrict__ boxes, const float* __restrict__ alive_in,
                   float* __restrict__ keep, int K, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = nms::num_words(K);
  const int Kp = W << 5;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + Kp);
  uint32_t* salive = reinterpret_cast<uint32_t*>(sarea + Kp);
  uint32_t* srow = salive + 32;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;

  nms::load_boxes(boxes + base, sbox, sarea, K, Kp);
  if (warp < W) {  // warp s builds alive word s (blockDim.x >= Kp)
    const int j = threadIdx.x;
    const uint32_t word = __ballot_sync(kFull, j < K && alive_in[base + j] > 0.5f);
    if (lane == 0) salive[warp] = word;
  }
  __syncthreads();
  nms::build_bits<nms::Layout::kRows>(sbox, sarea, srow, K, thresh);
  __syncthreads();
  if (warp != 0) return;

  // lane s holds alive word s; lanes past W hold 0 and never change
  uint32_t alive = lane < W ? salive[lane] : 0u;
  for (int b = 0; b < W; ++b) {
    const int i0 = b << 5;
    // lane k: row i0+k's bits in block b (bits only for columns past the row)
    const uint32_t diag = srow[(i0 + lane) * W + b];
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
        if ((kept >> k) & 1u) sup |= srow[(i0 + k) * W + lane];
    }
    alive = lane == b ? kept : (alive & ~sup);
  }
  for (int s = 0; s < W; ++s) {
    const uint32_t word = __shfl_sync(kFull, alive, s);
    const int j = (s << 5) + lane;
    if (j < K) keep[base + j] = ((word >> lane) & 1u) ? 1.f : 0.f;
  }
}

// blockDim.x == 32 * G; warp g owns image blockIdx.x * G + g.
// Shared layout per warp: box[Kp] float4 | area[Kp].
__global__ void nms_seq_multi_kernel(const float4* __restrict__ boxes,
                                     const float* __restrict__ alive_in,
                                     float* __restrict__ keep, int B, int K, int G,
                                     float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = nms::num_words(K);
  const int Kp = W << 5;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * G + g;
  if (b >= B) return;  // ragged last CTA; nothing below syncs across warps
  float4* sbox = reinterpret_cast<float4*>(smem) + static_cast<size_t>(g) * Kp;
  float* sarea = reinterpret_cast<float*>(reinterpret_cast<float4*>(smem) + static_cast<size_t>(G) * Kp) +
                 static_cast<size_t>(g) * Kp;
  const size_t base = static_cast<size_t>(b) * K;

  // bit s of `alive` is candidate 32*s + lane
  uint32_t alive = 0u;
  for (int s = 0; s < W; ++s) {
    const int j = (s << 5) + lane;
    if (j < K) {
      const float4 bj = boxes[base + j];
      sbox[j] = bj;
      sarea[j] = nms::box_area(bj);
      if (alive_in[base + j] > 0.5f) alive |= 1u << s;
    }
  }
  __syncwarp();

  for (int i = 0; i < K - 1; ++i) {
    const uint32_t owner = __shfl_sync(kFull, alive, i & 31);
    if (!((owner >> (i >> 5)) & 1u)) continue;  // dead anchor: the same in every lane
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    // slots whose candidate j = 32*s + lane is past i and still alive
    for (int s = i >> 5; s < W; ++s) {
      const int j = (s << 5) + lane;
      if (j > i && ((alive >> s) & 1u) && nms::box_iou(bi, ai, sbox[j], sarea[j]) > thresh)
        alive &= ~(1u << s);
    }
  }
  for (int s = 0; s < W; ++s) {
    const int j = (s << 5) + lane;
    if (j < K) keep[base + j] = ((alive >> s) & 1u) ? 1.f : 0.f;
  }
}

size_t seq_smem_bytes(int K) {
  const size_t W = static_cast<size_t>(nms::num_words(K));
  const size_t Kp = W * 32;
  return Kp * (sizeof(float4) + sizeof(float)) + 32 * sizeof(uint32_t) +
         Kp * W * sizeof(uint32_t);
}

size_t multi_smem_bytes(int K, int G) {
  const size_t Kp = static_cast<size_t>(nms::num_words(K)) * 32;
  return static_cast<size_t>(G) * Kp * (sizeof(float4) + sizeof(float));
}

}  // namespace

extern "C" {

// boxes: (B, K, 4) float32 xyxy, contiguous, score-sorted per image;
// alive: (B, K) float32 initial mask (> 0.5 is alive); keep: (B, K) float32
// 0/1 output. Return a cudaError_t (0 on success).
int cvsd_nms_seq(const void* boxes, const void* alive, void* keep, int B, int K,
                 float iou_thresh, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > nms::kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = seq_smem_bytes(K);
  const cudaError_t e = nms::allow_smem(reinterpret_cast<const void*>(nms_seq_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_seq_kernel<<<B, nms::build_threads(K), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(alive),
      static_cast<float*>(keep), K, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}

int cvsd_nms_seq_multi(const void* boxes, const void* alive, void* keep, int B, int K,
                       int G, float iou_thresh, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > nms::kMaxK || G <= 0 || G > 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = multi_smem_bytes(K, G);
  const cudaError_t e =
      nms::allow_smem(reinterpret_cast<const void*>(nms_seq_multi_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (B + G - 1) / G;
  nms_seq_multi_kernel<<<grid, 32 * G, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(alive),
      static_cast<float*>(keep), B, K, G, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a launch asks for per CTA.
long long cvsd_nms_seq_smem_bytes(int K) { return static_cast<long long>(seq_smem_bytes(K)); }
long long cvsd_nms_seq_multi_smem_bytes(int K, int G) {
  return static_cast<long long>(multi_smem_bytes(K, G));
}

const char* cvsd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
