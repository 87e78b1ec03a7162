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
// 67 TFLOP/s FP32 that is under 1 us of bound, so launch latency, the serial
// IoU work of one thread or lane, and the K dependent greedy steps set the time.
//
// What the designs do about it:
//   nms_seq_kernel — one CTA per image, Kp = 32*ceil(K/32) threads, no batch
//     padding. Thread j builds column j of the suppression bits in shared
//     memory (ceil(K/32) words, word-major, as csrc/nms_fixpoint.cu does);
//     then the greedy runs in order with one __syncthreads() per step whose
//     anchor is alive. A dead anchor suppresses nothing, and every thread
//     reads the same flag, so its step is skipped by all threads together.
//   nms_seq_multi_kernel — G images per CTA (the TPU kernel's grouping), one
//     warp per image and no barrier across warps. Lane l owns candidates
//     j = 32*s + l and keeps their alive flags as the bits s of one register;
//     alive[i] reaches every lane by __shfl_sync. IoUs are computed in the
//     loop, only for alive anchors and still-alive j > i, so shared memory
//     holds just the boxes and areas (20 B per candidate). The last CTA may
//     hold fewer than G images: its spare warps return at once.
//
// Bit-exactness: the masks must equal the plain version bit for bit, so the
// IoU rounds where the reference rounds (explicit _rn intrinsics, and the file
// is compiled with -fmad=false), in the reference's operation order:
//   area = max(x2-x1,0)*max(y2-y1,0); ix = max(min(x2i,x2j)-max(x1i,x1j),0);
//   union = (area_i+area_j)-inter; iou = inter/max(union,1e-9f);  iou > t.
//
// Limits: K <= 1024 (one thread, or 32 lane slots, per candidate); for the
// multi kernel G*32 <= 1024 threads and G*Kp*20 B of shared memory per CTA.
// The launchers allocate nothing and return cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr size_t kMaxSmem = 232448;  // per-CTA opt-in limit on sm_90

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

// blockDim.x == Kp; thread j owns candidate j.
// Shared layout: box[Kp] float4 | area[Kp] | col[W][Kp] words | anchor[Kp] bytes.
__global__ void nms_seq_kernel(const float4* __restrict__ boxes,
                               const float* __restrict__ alive_in,
                               float* __restrict__ keep, int K, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;
  const int Kp = W << 5;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + Kp);
  uint32_t* scol = reinterpret_cast<uint32_t*>(sarea + Kp);
  uint8_t* salive = reinterpret_cast<uint8_t*>(scol + W * Kp);

  const int j = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;

  float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);
  float aj = 0.f;
  if (j < K) {
    bj = boxes[base + j];
    aj = box_area(bj);
    sbox[j] = bj;
    sarea[j] = aj;
  }
  salive[j] = (j < K) && alive_in[base + j] > 0.5f;
  __syncthreads();

  // column j: bit (i - 32w) of word w is set iff i < j and iou(i,j) > t.
  // Words past j>>5 are never read, so they are never written.
  if (j < K) {
    for (int w = 0; w <= (j >> 5); ++w) {
      uint32_t bits = 0u;
      const int i0 = w << 5;
      const int iend = min(i0 + 32, j);
      for (int i = i0; i < iend; ++i) {
        if (box_iou(sbox[i], sarea[i], bj, aj) > thresh) bits |= 1u << (i - i0);
      }
      scol[w * Kp + j] = bits;
    }
  }
  __syncthreads();

  // Greedy in score order. Step i writes only salive[j] for j > i and reads
  // salive[i], so one barrier after each step with a live anchor orders it.
  for (int i = 0; i < K - 1; ++i) {
    if (!salive[i]) continue;  // the same value in every thread
    if (j > i && j < K && ((scol[(i >> 5) * Kp + j] >> (i & 31)) & 1u)) salive[j] = 0;
    __syncthreads();
  }
  if (j < K) keep[base + j] = salive[j] ? 1.f : 0.f;
}

// blockDim.x == 32 * G; warp g owns image blockIdx.x * G + g.
// Shared layout per warp: box[Kp] float4 | area[Kp].
__global__ void nms_seq_multi_kernel(const float4* __restrict__ boxes,
                                     const float* __restrict__ alive_in,
                                     float* __restrict__ keep, int B, int K, int G,
                                     float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;
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
      sarea[j] = box_area(bj);
      if (alive_in[base + j] > 0.5f) alive |= 1u << s;
    }
  }
  __syncwarp();

  for (int i = 0; i < K - 1; ++i) {
    const uint32_t owner = __shfl_sync(0xffffffffu, alive, i & 31);
    if (!((owner >> (i >> 5)) & 1u)) continue;  // dead anchor: the same in every lane
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    // slots whose candidate j = 32*s + lane is past i and still alive
    for (int s = i >> 5; s < W; ++s) {
      const int j = (s << 5) + lane;
      if (j > i && ((alive >> s) & 1u) && box_iou(bi, ai, sbox[j], sarea[j]) > thresh)
        alive &= ~(1u << s);
    }
  }
  for (int s = 0; s < W; ++s) {
    const int j = (s << 5) + lane;
    if (j < K) keep[base + j] = ((alive >> s) & 1u) ? 1.f : 0.f;
  }
}

size_t seq_smem_bytes(int K) {
  const size_t W = static_cast<size_t>((K + 31) / 32);
  const size_t Kp = W * 32;
  return Kp * (sizeof(float4) + sizeof(float)) + W * Kp * sizeof(uint32_t) + Kp;
}

size_t multi_smem_bytes(int K, int G) {
  const size_t Kp = static_cast<size_t>((K + 31) / 32) * 32;
  return static_cast<size_t>(G) * Kp * (sizeof(float4) + sizeof(float));
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// boxes: (B, K, 4) float32 xyxy, contiguous, score-sorted per image;
// alive: (B, K) float32 initial mask (> 0.5 is alive); keep: (B, K) float32
// 0/1 output. Return a cudaError_t (0 on success).
int cvsd_nms_seq(const void* boxes, const void* alive, void* keep, int B, int K,
                 float iou_thresh, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = (K + 31) / 32 * 32;
  const size_t smem = seq_smem_bytes(K);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(nms_seq_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_seq_kernel<<<B, Kp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(alive),
      static_cast<float*>(keep), K, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}

int cvsd_nms_seq_multi(const void* boxes, const void* alive, void* keep, int B, int K,
                       int G, float iou_thresh, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK || G <= 0 || G > 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = multi_smem_bytes(K, G);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(nms_seq_multi_kernel), smem);
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
