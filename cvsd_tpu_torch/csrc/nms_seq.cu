// Sequential greedy NMS keep masks for Hopper (sm_90a): one kernel, one CTA per image.
//
// Replaces cvsd_tpu/ops/nms.py::_nms_kernel (behind nms_pallas, the NMS of
// detector.nms_method 'pallas_seq') and ::_nms_kernel_multi (behind
// nms_pallas_multi, G images per grid step). The reference's G is a VMEM
// budget and changes nothing in the mask, so nms_seq_cuda and
// nms_seq_multi_cuda launch this same kernel.
//
// What it computes, per image b over its K score-sorted candidates:
//   alive_0[j] = alive_in[j] > 0.5
//   for i = 0..K-1:  if alive[i]: alive[j] = 0 for every j > i with iou(i,j) > t
//   keep[j] = alive[j] ? 1.0f : 0.0f                       (float32 0/1)
// which is the greedy-NMS keep mask (nms_seq_torch, the plain version).
//
// What bounds it: at B=128, K=256 it reads 128*256*(16+4) B and writes
// 128*256*4 B (about 0.8 MB) and needs at most 4.2 M upper-triangle IoUs of
// ~12 FLOP plus one mask op each (about 54 MFLOP). Against 3.35 TB/s and
// 67 TFLOP/s FP32 that is under 1 us of bound, so launch latency, the IoU
// work of one CTA (each with an IEEE division) and the K dependent greedy
// steps set the time.
//
// What the design does about it: the whole CTA (one warp per 8-row slice of a
// 32x32 tile of the upper triangle, at most 32 warps) builds the suppression
// bits as row words R[i][t] in shared memory (build_bits in nms_common.cuh:
// at K=256 no warp computes more than 40 IoUs in a row). After one barrier,
// warp 0 alone runs the greedy a word at a time, with no IoU and no barrier
// in the loop (greedy_rows in nms_common.cuh); the other warps exit.
//
// Bit-exactness: the masks must equal the plain version bit for bit; the IoU
// is nms_common.cuh's, shared with csrc/nms_fixpoint.cu.
//
// Limits: K <= 1024 (32 words) and 20*Kp + 128 + 4*W*Kp bytes of shared
// memory per CTA (148 KB at K=1024). The launcher allocates nothing and
// returns cudaGetLastError() after the launch.

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
  const uint32_t alive = nms::greedy_rows(srow, lane < W ? salive[lane] : 0u, W);
  for (int s = 0; s < W; ++s) {
    const uint32_t word = __shfl_sync(kFull, alive, s);
    const int j = (s << 5) + lane;
    if (j < K) keep[base + j] = ((word >> lane) & 1u) ? 1.f : 0.f;
  }
}

size_t smem_bytes(int K) {
  const size_t W = static_cast<size_t>(nms::num_words(K));
  const size_t Kp = W * 32;
  return Kp * (sizeof(float4) + sizeof(float)) + 32 * sizeof(uint32_t) +
         Kp * W * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// boxes: (B, K, 4) float32 xyxy, contiguous, score-sorted per image;
// alive: (B, K) float32 initial mask (> 0.5 is alive); keep: (B, K) float32
// 0/1 output. Returns a cudaError_t (0 on success).
int cvsd_nms_seq(const void* boxes, const void* alive, void* keep, int B, int K,
                 float iou_thresh, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > nms::kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(K);
  const cudaError_t e = nms::allow_smem(reinterpret_cast<const void*>(nms_seq_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_seq_kernel<<<B, nms::build_threads(K), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(alive),
      static_cast<float*>(keep), K, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a launch asks for per CTA.
long long cvsd_nms_seq_smem_bytes(int K) { return static_cast<long long>(smem_bytes(K)); }

const char* cvsd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
