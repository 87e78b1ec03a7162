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
// about 1 us of bound, so launch latency and the serial depth of the Jacobi
// loop (data dependent, a few steps on real detections) dominate.
//
// What the design does about it:
//   - one launch for the whole batch, one CTA per image (no grouping or batch
//     padding: CTAs are independent and each stops when its own image converges);
//   - M never touches device memory: thread j builds column j of M as
//     ceil(K/32) bit words in shared memory (8 KB at K=256);
//   - the alive vector is ceil(K/32) words in shared memory, rebuilt each step
//     with __ballot_sync; __syncthreads_or(changed) ends the loop.
//
// Bit-exactness: the mask must equal the plain PyTorch version bit for bit, so
// the IoU rounds where the reference rounds (explicit _rn intrinsics, and the
// file is compiled with -fmad=false), in the reference's operation order:
//   area = max(x2-x1,0)*max(y2-y1,0); ix = max(min(x2i,x2j)-max(x1i,x1j),0);
//   union = (area_i+area_j)-inter; iou = inter/max(union,1e-9f).
//
// Limits: K <= 1024 (one thread per candidate). The launcher allocates nothing
// and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b, float area_b) {
  const float ix = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float iy = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(ix, iy);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

// blockDim.x == Kp == 32 * ceil(K/32); thread j owns candidate j.
// Shared layout: box[Kp] float4 | area[Kp] | alive[W] | col[W][Kp] (word-major,
// so the 32 threads of a warp read 32 consecutive words: no bank conflicts).
__global__ void nms_fixpoint_kernel(const float4* __restrict__ boxes,
                                    const float* __restrict__ alive_in,
                                    uint8_t* __restrict__ keep, int K, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;
  const int Kp = W << 5;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + Kp);
  uint32_t* salive = reinterpret_cast<uint32_t*>(sarea + Kp);
  uint32_t* scol = salive + W;

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const size_t base = static_cast<size_t>(b) * K;

  float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);
  float aj = 0.f;
  if (j < K) {
    bj = boxes[base + j];
    aj = box_area(bj);
    sbox[j] = bj;
    sarea[j] = aj;
  }
  const bool init = (j < K) && alive_in[base + j] > 0.5f;
  const uint32_t init_bits = __ballot_sync(0xffffffffu, init);
  if (lane == 0) salive[warp] = init_bits;
  __syncthreads();

  // column j of M: bit (i - 32w) of word w is set iff i < j and iou(i,j) > t.
  // Words past j>>5 are never read, so they are never written.
  const int nw = (j >> 5) + 1;
  if (j < K) {
    for (int w = 0; w < nw; ++w) {
      uint32_t bits = 0u;
      const int i0 = w << 5;
      const int iend = min(i0 + 32, j);
      for (int i = i0; i < iend; ++i) {
        if (box_iou(sbox[i], sarea[i], bj, aj) > thresh) bits |= 1u << (i - i0);
      }
      scol[w * Kp + j] = bits;
    }
  }

  // Jacobi steps; each thread reads only its own column, so no barrier is
  // needed between the build and the first step (salive was synced above).
  bool cur = init;
  for (int it = 0; it < K; ++it) {
    bool suppressed = false;
    if (j < K) {
      for (int w = 0; w < nw; ++w) {
        if (scol[w * Kp + j] & salive[w]) {
          suppressed = true;
          break;
        }
      }
    }
    const bool nxt = init && !suppressed;
    const uint32_t bits = __ballot_sync(0xffffffffu, nxt);
    __syncthreads();  // every thread has read salive for this step
    if (lane == 0) salive[warp] = bits;
    const int changed = nxt != cur;
    cur = nxt;
    if (!__syncthreads_or(changed)) break;  // also publishes the new salive
  }
  if (j < K) keep[base + j] = cur ? 1 : 0;
}

// Dynamic shared memory of one CTA (the layout above).
size_t smem_bytes(int K) {
  const size_t W = static_cast<size_t>((K + 31) / 32);
  const size_t Kp = W * 32;
  return Kp * (sizeof(float4) + sizeof(float)) + W * sizeof(uint32_t) + W * Kp * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// boxes: (B, K, 4) float32 xyxy, contiguous, score-sorted per image;
// alive: (B, K) float32 0/1 initial mask; keep: (B, K) uint8/bool output.
// Returns a cudaError_t (0 on success).
int cvsd_nms_fixpoint(const void* boxes, const void* alive, void* keep, int B, int K,
                      float iou_thresh, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = (K + 31) / 32 * 32;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_fixpoint_kernel<<<B, Kp, smem, static_cast<cudaStream_t>(stream)>>>(
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
