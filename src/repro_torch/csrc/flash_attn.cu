// Online-softmax (flash) attention over (B, H, S, d) tensors, with causal
// and sliding-window masks, grouped-query heads and explicit kv positions.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py:flash_attention (body
// _attn_kernel), the TPU kernel whose grid (B, Hq, nq, nk) walks kv blocks
// in order and carries (m, l, acc) in VMEM scratch from one grid step to
// the next. It computes the function of the reference models' jnp twin,
// src/repro/models/layers.py:_chunk_attention: query row i sits at
// absolute position q_offset + i; kv slot t sits at k_pos[t] (-1 = empty)
// or, without k_pos, at t. A kv slot is masked when its position is < 0,
// above the query's (causal), or at or below the query's minus the window.
// flash_attention is the case q_offset = Skv - Sq with no k_pos. A row
// whose every slot is masked gives 0, as the TPU kernel's masked p and
// clamped l give it. All arithmetic is f32 (expf, as the TPU kernel); the
// output is written in the input's type.
//
// What bounds it on an H100: the prefill's score and value products
// (4 * Sq * Skv * d operations a head, halved by the causal mask) are a
// tensor-core product at heart, and against 989 TFLOP/s of bf16 the bytes
// (q, k, v read once, the output written once) would bound it only in
// decode, where one query row reads the whole cache. This kernel does not
// reach the tensor cores: its products run on the f32 CUDA cores
// (67 TFLOP/s) and its inner loops are bound by shared-memory traffic, so
// it is far from the bound in prefill. What the design does: the kv axis
// is a loop inside one block per (q block of 16 rows, head, batch), so the
// running (m, l, acc) stay in registers and nothing crosses blocks; each
// kv tile of 32 slots is staged once into shared memory as f32 and read by
// all 8 warps; a warp owns two query rows, so each K and V value it loads
// from shared memory serves both rows; lane j scores slot j of the tile
// (K is stored transposed and padded so the 32 lanes hit 32 banks), and
// in the value product lanes stride over d. Causal and window masks cut
// the kv loop to the tiles a block can see (when kv positions are slot
// indices). Only the last dimension of q, k, v and out needs to be
// contiguous: a cache's valid prefix and the transposed projections come
// in as strided views.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* kpos;
  long long sqb, sqh, sqs;
  long long skb, skh, sks;
  long long svb, svh, svs;
  long long sob, soh, sos;
  int hq, hkv, sq, skv, d, q_offset, causal, window;
  float scale;
};

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float x) {
  p[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int kp, int qp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// kChunks = ceil(d / 32): the d-columns each lane holds of a row's output.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  constexpr int kPitch = kBlockK + 1;
  float* qs = smem;                  // [kBlockQ][d], scaled
  float* kt = qs + kBlockQ * d;      // [d][kPitch], transposed
  float* vs = kt + d * kPitch;       // [kBlockK][d]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* Q = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* K = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* V = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  T* O = static_cast<T*>(a.o) + b * a.sob + h * a.soh;

  for (int e = threadIdx.x; e < kBlockQ * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    qs[e] = q0 + r < a.sq ? load(Q, (q0 + r) * a.sqs + c) * a.scale : 0.f;
  }

  // the kv slots this block can see (every slot under explicit positions)
  int lo = 0, hi = a.skv;
  if (a.kpos == nullptr) {
    const int q_first = a.q_offset + q0;
    const int q_last = a.q_offset + min(q0 + kBlockQ, a.sq) - 1;
    if (a.causal) hi = min(hi, q_last + 1);
    if (a.window > 0) lo = max(0, q_first - a.window + 1);
  }

  const int r0 = warp * kRowsPerWarp;
  const bool rows_live = q0 + r0 < a.sq;
  const int qp0 = a.q_offset + q0 + r0;
  const int qp1 = qp0 + 1;
  const float* qrow0 = qs + r0 * d;
  const float* qrow1 = qrow0 + d;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc0[kChunks], acc1[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) acc0[i] = acc1[i] = 0.f;

  for (int t0 = (lo / kBlockK) * kBlockK; t0 < hi; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int e = threadIdx.x; e < kBlockK * d; e += kThreads) {
      const int j = e / d;
      const int c = e - j * d;
      float kx = 0.f, vx = 0.f;
      if (t0 + j < a.skv) {
        kx = load(K, (t0 + j) * a.sks + c);
        vx = load(V, (t0 + j) * a.svs + c);
      }
      kt[c * kPitch + j] = kx;
      vs[e] = vx;
    }
    __syncthreads();
    if (!rows_live) continue;  // warp-uniform: a tail block's idle warps

    // lane j scores slot t0 + j against both rows
    const int t = t0 + lane;
    int kp = -1;
    if (t < a.skv) kp = a.kpos == nullptr ? t : a.kpos[t];
    float s0 = 0.f, s1 = 0.f;
    if ((d & 3) == 0) {
      for (int c = 0; c < d; c += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(qrow0 + c);
        const float4 x1 = *reinterpret_cast<const float4*>(qrow1 + c);
        const float k0 = kt[c * kPitch + lane];
        const float k1 = kt[(c + 1) * kPitch + lane];
        const float k2 = kt[(c + 2) * kPitch + lane];
        const float k3 = kt[(c + 3) * kPitch + lane];
        s0 = fmaf(x0.x, k0, s0);
        s1 = fmaf(x1.x, k0, s1);
        s0 = fmaf(x0.y, k1, s0);
        s1 = fmaf(x1.y, k1, s1);
        s0 = fmaf(x0.z, k2, s0);
        s1 = fmaf(x1.z, k2, s1);
        s0 = fmaf(x0.w, k3, s0);
        s1 = fmaf(x1.w, k3, s1);
      }
    } else {
      for (int c = 0; c < d; ++c) {
        const float kx = kt[c * kPitch + lane];
        s0 = fmaf(qrow0[c], kx, s0);
        s1 = fmaf(qrow1[c], kx, s1);
      }
    }
    const bool ok0 = visible(kp, qp0, a.causal, a.window);
    const bool ok1 = visible(kp, qp1, a.causal, a.window);
    s0 = ok0 ? s0 : kNegInf;
    s1 = ok1 ? s1 : kNegInf;
    const float mn0 = fmaxf(m0, warp_max(s0));
    const float mn1 = fmaxf(m1, warp_max(s1));
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    const float p0 = ok0 ? expf(s0 - mn0) : 0.f;
    const float p1 = ok1 ? expf(s1 - mn1) : 0.f;
    l0 = l0 * alpha0 + warp_sum(p0);
    l1 = l1 * alpha1 + warp_sum(p1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc0[i] *= alpha0;
      acc1[i] *= alpha1;
    }
    // lanes stride over d; slot j's weights come from lane j
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float pj0 = __shfl_sync(kFull, p0, j);
      const float pj1 = __shfl_sync(kFull, p1, j);
      const float* vr = vs + j * d;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = lane + 32 * i;
        if (c < d) {
          const float x = vr[c];
          acc0[i] = fmaf(pj0, x, acc0[i]);
          acc1[i] = fmaf(pj1, x, acc1[i]);
        }
      }
    }
  }

  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c >= d) continue;
    if (q0 + r0 < a.sq) store(O, (q0 + r0) * a.sos + c, acc0[i] / den0);
    if (q0 + r0 + 1 < a.sq) store(O, (q0 + r0 + 1) * a.sos + c, acc1[i] / den1);
  }
}

template <typename T, int kChunks>
int launch_as(const Args& a, int batch, size_t smem, cudaStream_t s) {
  auto kernel = flash_attn_kernel<T, kChunks>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.hq, batch);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const Args& a, int batch, size_t smem, cudaStream_t s) {
  if (a.d <= 32) return launch_as<T, 1>(a, batch, smem, s);
  if (a.d <= 64) return launch_as<T, 2>(a, batch, smem, s);
  if (a.d <= 128) return launch_as<T, 4>(a, batch, smem, s);
  return launch_as<T, 8>(a, batch, smem, s);
}

}  // namespace

// q: (B, Hq, Sq, d), k/v: (B, Hkv, Skv, d), out: (B, Hq, Sq, d), each with
// its own (batch, head, sequence) strides in elements and a contiguous last
// dimension; kpos: (Skv,) int32 or null. dtype 0 = f32, 1 = bf16, for all
// four. window <= 0 means none. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); the wrapper checks d <= 256 and
// Hq % Hkv == 0.
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* kpos, int dtype, int batch, int hq, int hkv, int sq, int skv,
    int d, long long sqb, long long sqh, long long sqs, long long skb,
    long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long soh, long long sos,
    int q_offset, int causal, int window, float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q,   k,   v,   out, static_cast<const int32_t*>(kpos),
         sqb, sqh, sqs,
         skb, skh, sks,
         svb, svh, svs,
         sob, soh, sos,
         hq,  hkv, sq,  skv, d, q_offset, causal, window,
         scale};
  const size_t smem =
      sizeof(float) * static_cast<size_t>(d) *
      (kBlockQ + (kBlockK + 1) + kBlockK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(a, batch, smem, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(a, batch, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
