// Greedy NMS keep mask by Jacobi fixpoint, one CTA per image, for Hopper (sm_90a).
//
// Replaces cvsd_tpu/ops/nms.py::_nms_fixpoint_kernel (the Pallas kernel behind
// nms_pallas_fixpoint, the default NMS of the detection path).
//
// What it computes, per image b over its K score-sorted candidates:
//   M[i,j] = iou(i,j) > t  and  i < j            (suppression adjacency)
//   a_0 = init;  a_{k+1}[j] = init[j] & !any_i(M[i,j] & a_k[i])   until a stops changing
// which is exactly the greedy-NMS keep mask (see nms_fixpoint_jax).
//
// What bounds it: at B=128, K=256 it reads 128*256*(16+4) B and writes
// 128*256 B (about 0.7 MB) and computes about 4.2 M upper-triangle IoUs of
// ~12 FLOP each (about 50 MFLOP). Against 3.35 TB/s and 67 TFLOP/s FP32 that is
// about 1 us of bound, so launch latency, the IoU work of one CTA (each with
// an IEEE division) and the serial depth of the Jacobi loop (data dependent,
// a few steps on real detections) dominate.
//
// What the design does about it:
//   - one launch for the whole batch, one CTA per image (no grouping or batch
//     padding: CTAs are independent and each stops when its own image converges);
//   - M never touches device memory: the whole CTA, one warp per 8-row slice
//     of a 32x32 tile of the upper triangle (at most 32 warps), builds it as
//     column words C[w][j] in shared memory (build_bits in nms_common.cuh;
//     8 KB at K=256), so no warp computes more than 40 IoUs in a row at K=256;
//   - after one barrier the warps past Kp/32 exit, and thread j < Kp runs the
//     Jacobi steps on its own column, its words loaded with no early exit so
//     the loads overlap. The alive words are double-buffered: a step reads
//     one buffer, writes the other by __ballot_sync, and one named-barrier
//     OR-reduction (bar.red.or over the Kp threads) both publishes them and
//     ends the loop once nothing changed: one barrier a step.
//
// Bit-exactness: the mask must equal the plain PyTorch version bit for bit;
// the IoU is nms_common.cuh's, shared with csrc/nms_seq.cu.
//
// Limits: K <= 1024 (32 words); shared memory 20*Kp + 256 + 4*W*Kp bytes
// (148 KB at K=1024). The launcher allocates nothing and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

using nms::kFull;

// Barrier 1 over the first `nthreads` threads (a multiple of 32): returns
// whether `pred` held in any of them. Threads past them may have exited;
// barrier 0 (__syncthreads) would wait for them.
__device__ __forceinline__ bool any_among(int nthreads, bool pred) {
  int any;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, 1, %2, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(any)
      : "r"(static_cast<int>(pred)), "r"(nthreads)
      : "memory");
  return any != 0;
}

// blockDim.x == nms::build_threads(K) >= Kp == 32 * ceil(K/32).
// Shared layout: box[Kp] float4 | area[Kp] | alive[2][32] | C[W][Kp] (word-major,
// so the 32 threads of a warp read 32 consecutive words: no bank conflicts).
__global__ void __launch_bounds__(nms::kMaxThreads, 1)
    nms_fixpoint_kernel(const float4* __restrict__ boxes, const float* __restrict__ alive_in,
                        uint8_t* __restrict__ keep, int K, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = nms::num_words(K);
  const int Kp = W << 5;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + Kp);
  uint32_t* salive = reinterpret_cast<uint32_t*>(sarea + Kp);
  uint32_t* scol = salive + 64;

  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;

  nms::load_boxes(boxes + base, sbox, sarea, K, Kp);
  for (int x = j; x < W * Kp; x += blockDim.x) scol[x] = 0u;  // the slices OR into it
  const bool init = j < K && alive_in[base + j] > 0.5f;
  if (warp < W) {
    const uint32_t word = __ballot_sync(kFull, init);
    if (lane == 0) salive[warp] = word;
  }
  __syncthreads();
  nms::build_bits<nms::Layout::kCols>(sbox, sarea, scol, K, thresh);
  __syncthreads();  // a column's words come from several warps
  if (warp >= W) return;

  const int nw = warp + 1;  // words past j>>5 hold no bit of column j
  bool cur = init;
  int buf = 0;
  for (int it = 0; it < K; ++it) {
    const uint32_t* a = salive + (buf << 5);
    uint32_t by = 0u;  // alive rows that suppress column j, no early exit: the loads overlap
#pragma unroll 8
    for (int w = 0; w < nw; ++w) by |= scol[w * Kp + j] & a[w];
    const bool nxt = init && !by;
    const uint32_t bits = __ballot_sync(kFull, nxt);
    buf ^= 1;
    // nobody reads this buffer until every thread has passed the last barrier
    if (lane == 0) salive[(buf << 5) + warp] = bits;
    const bool changed = nxt != cur;
    cur = nxt;
    if (!any_among(Kp, changed)) break;  // also publishes the new words
  }
  if (j < K) keep[base + j] = cur ? 1 : 0;
}

// Dynamic shared memory of one CTA (the layout above).
size_t smem_bytes(int K) {
  const size_t W = static_cast<size_t>(nms::num_words(K));
  const size_t Kp = W * 32;
  return Kp * (sizeof(float4) + sizeof(float)) + 64 * sizeof(uint32_t) +
         W * Kp * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// boxes: (B, K, 4) float32 xyxy, contiguous, score-sorted per image;
// alive: (B, K) float32 0/1 initial mask; keep: (B, K) uint8/bool output.
// Returns a cudaError_t (0 on success).
int cvsd_nms_fixpoint(const void* boxes, const void* alive, void* keep, int B, int K,
                      float iou_thresh, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > nms::kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(K);
  const cudaError_t e =
      nms::allow_smem(reinterpret_cast<const void*>(nms_fixpoint_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_fixpoint_kernel<<<B, nms::build_threads(K), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(alive),
      static_cast<uint8_t*>(keep), K, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a launch at this K asks for per CTA.
long long cvsd_nms_fixpoint_smem_bytes(int K) { return static_cast<long long>(smem_bytes(K)); }

const char* cvsd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
