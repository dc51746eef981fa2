// RWKV6 ("Finch") wkv recurrence: for each (batch, head) a (hd x hd) f32
// state s[k][v] and, for each token t, with r, k, v and the decay w of
// the token (each hd wide) and the head's bonus u (hd, over the key
// dimension):
//   out[v]  = sum_k r[k] (s[k][v] + u[k] k[k] v[v])
//   s[k][v] = w[k] s[k][v] + k[k] v[v]
// The outputs are f32; the last state is written back.
//
// Replaces no TPU kernel. It computes the lax.scan of
// src/repro/models/rwkv.py:time_mix (its `step`, rwkv.py:58-69), which the
// reference leaves to XLA; in eager PyTorch that loop is one host
// iteration a token and layer (~65k a 2,048-token prefill of rwkv6-3b), so
// the port runs it as one launch a layer. As in the reference, r, k and v
// (in the activation type) are cast to f32 before any product, and w and
// u are f32. The plain version (kernels/wkv/ref.py:wkv6_plain) is the
// reference's step one token at a time.
//
// What bounds it on an H100: neither bytes nor operations at first. At
// rwkv6-3b's prefill (8 x 2,048 tokens, 40 heads of 64) the work is ~19
// GFLOP of f32 a layer (~0.28 ms at 67 TFLOP/s) and ~0.18 ms of bytes, but
// each (batch, head) is a chain of 2,048 dependent steps, so the latency of
// one step times the tokens bounds the simple design. The design: one CTA
// of hd threads a (batch, head); thread v keeps column v of the state in
// registers (hd floats) and walks the tokens in order. r, k, w (and v) of
// a block of 32 tokens are staged in shared memory as f32 with one
// barrier a block; the inner loop over k reads them as float4 broadcasts.
// The sum over k runs in four partial sums (k mod 4), added at the end, to
// shorten the chain of dependent adds. Prefill and decode (S = 1) are the
// same launch. A chunked formulation (products over blocks of tokens on
// the tensor cores) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTokens = 32;   // tokens staged in shared memory at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* sout, int S, int H) {
  __shared__ __align__(16) float sr[kTokens][HD];
  __shared__ __align__(16) float sk[kTokens][HD];
  __shared__ __align__(16) float sw[kTokens][HD];
  __shared__ float sv[kTokens][HD];
  __shared__ __align__(16) float su[HD];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long long head = static_cast<long long>(b) * H + h;
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s0[head * HD * HD + i * HD + j];
  su[j] = u[h * HD + j];
  for (int t0 = 0; t0 < S; t0 += kTokens) {
    const int n = min(kTokens, S - t0);
    __syncthreads();   // the previous block is consumed (and su written)
    for (int t = 0; t < n; ++t) {
      // (b, t, h, j) of a (B, S, H, HD) tensor
      const long long off = ((static_cast<long long>(b) * S + t0 + t) * H +
                             h) * HD + j;
      sr[t][j] = to_f32(r[off]);
      sk[t][j] = to_f32(k[off]);
      sv[t][j] = to_f32(v[off]);
      sw[t][j] = w[off];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = sv[t][j];
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&sr[t][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&sk[t][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&sw[t][i]);
        const float4 uu = *reinterpret_cast<const float4*>(&su[i]);
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
        const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = kv[q] * vj;
          o[q] = o[q] + rv[q] * (s[i + q] + uv[q] * a);
          s[i + q] = wv[q] * s[i + q] + a;
        }
      }
      const long long off = ((static_cast<long long>(b) * S + t0 + t) * H +
                             h) * HD + j;
      y[off] = (o[0] + o[1]) + (o[2] + o[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sout[head * HD * HD + i * HD + j] = s[i];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sout, int batch,
           int S, int H, cudaStream_t st) {
  wkv6_kernel<T, HD><<<dim3(H, batch), HD, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sout), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sout, int batch,
              int S, int H, int hd, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, sout, batch, S, H, st);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, sout, batch, S, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v: (batch, S, H, hd) in the activation type (dtype 0 f32, 1 bf16);
// w: (batch, S, H, hd) f32; u: (H, hd) f32; s0: (batch, H, hd, hd) f32,
// s0[k][v]; y: (batch, S, H, hd) f32; sout: (batch, H, hd, hd) f32, which
// may be s0 itself (thread v reads and writes only column v). All
// contiguous; hd is 32 or 64. Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* sout, int dtype, int batch, int S,
                           int H, int hd, void* stream) {
  if (batch <= 0 || H <= 0) return 0;
  if (S < 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_hd<float>(r, k, v, w, u, s0, y, sout, batch, S, H, hd, st);
  }
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, batch, S, H,
                                    hd, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
