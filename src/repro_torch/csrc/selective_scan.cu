// Mamba-1 selective scan: for each (batch, channel c) of d_inner and each
// state s of d_state, h_t[c, s] = exp(dt_t[c] A[c, s]) h_{t-1}[c, s] +
// dt_t[c] B_t[s] x_t[c], and the output y_t[c] = sum_s h_t[c, s] C_t[s] +
// x_t[c] D[c], with h_0 given and the last h returned.
//
// Replaces no TPU kernel. It computes what src/repro/models/ssm.py's
// mamba_block leaves to XLA: _selective_scan (a chunked associative scan
// over (B, S, d_inner, d_state) tensors of da = exp(dt A) and db = dt B x)
// and the C contraction (einsum "bsnk,bsk->bsn") plus the D skip. The
// reference materialises da, db and every h_t: at jamba's width (d_inner
// 16,384, d_state 16) that is 17 GB each in f32 for 8 x 2,048 tokens. Here
// they never leave registers. A scan on the hot path is a kernel; the port
// added it for that.
//
// Rounding follows the reference (ssm.py:80-84): da is exp of dt cast to
// f32 times A (f32); db is formed in the activation type, one rounding
// after each product (bf16(bf16(dt B) x)), and only then taken to f32; the
// recurrence and the output sum run in f32. The plain version
// (kernels/selective_scan/ref.py:selective_scan_plain) does the same steps
// in the same order, one token at a time; sums over d_state run here in
// index order.
//
// What bounds it on an H100: bytes at large d_inner (dt and x in the
// activation type, y in f32: ~2.1 GB at jamba's prefill of 8 x 2,048
// tokens, ~0.64 ms at 3.35 TB/s) and, nearly as much, the d_state
// exponentials (one SFU op each). The design is one thread a (batch,
// channel): its d_state values of h and its row of A live in registers,
// and it walks the tokens in order. B_t and C_t are shared by every
// channel of a token, so a CTA of 128 channels stages them in shared
// memory (as f32) a block of 64 tokens at a time. dt and x are read, and
// y written, at neighbouring addresses across a warp. Prefill and decode
// (S = 1) are the same launch. A chunked parallel scan over the tokens is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels a CTA
constexpr int kTokens = 64;     // tokens of B and C staged at a time
constexpr int kMaxState = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a product in the activation type: exact in f32 for bf16 inputs, then
// rounded once to bf16, as a bf16 multiply rounds
__device__ __forceinline__ float act_mul(float a, float b, float) {
  return a * b;
}
__device__ __forceinline__ float act_mul(float a, float b, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(a * b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ xc,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm,
                      const float* __restrict__ Dskip, const float* h0,
                      float* __restrict__ y, float* hout, int S, int di,
                      int ds) {
  __shared__ float sB[kTokens][kMaxState];
  __shared__ float sC[kTokens][kMaxState];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < di;
  float h[kMaxState], a[kMaxState];
#pragma unroll
  for (int s = 0; s < kMaxState; ++s) {
    const bool in = live && s < ds;
    h[s] = in ? h0[(static_cast<long long>(b) * di + c) * ds + s] : 0.f;
    a[s] = in ? A[static_cast<long long>(c) * ds + s] : 0.f;
  }
  const float dskip = live ? Dskip[c] : 0.f;
  const long long row = static_cast<long long>(b) * S;
  for (int t0 = 0; t0 < S; t0 += kTokens) {
    const int n = min(kTokens, S - t0);
    __syncthreads();   // the previous block of B and C is consumed
    for (int i = threadIdx.x; i < n * ds; i += kThreads) {
      const int t = i / ds, s = i % ds;
      const long long off = (row + t0 + t) * ds + s;
      sB[t][s] = to_f32(Bm[off]);
      sC[t][s] = to_f32(Cm[off]);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const long long off = (row + t0 + t) * di + c;
      const float d = to_f32(dt[off]);
      const float x = to_f32(xc[off]);
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxState; ++s) {
        if (s < ds) {
          const float da = expf(d * a[s]);
          const float db = act_mul(act_mul(d, sB[t][s], T()), x, T());
          h[s] = da * h[s] + db;
          acc = acc + h[s] * sC[t][s];
        }
      }
      y[off] = acc + x * dskip;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kMaxState; ++s) {
      if (s < ds) hout[(static_cast<long long>(b) * di + c) * ds + s] = h[s];
    }
  }
}

template <typename T>
int launch(const void* dt, const void* xc, const void* A, const void* Bm,
           const void* Cm, const void* Dskip, const void* h0, void* y,
           void* hout, int batch, int S, int di, int ds, cudaStream_t st) {
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(dt), static_cast<const T*>(xc),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dskip),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hout), S, di, ds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt, xc: (batch, S, di) in the activation type (dtype 0 f32, 1 bf16);
// Bm, Cm: (batch, S, ds) in it; A: (di, ds) f32; Dskip: (di,) f32; h0:
// (batch, di, ds) f32; y: (batch, S, di) f32; hout: (batch, di, ds) f32,
// which may be h0 itself (each thread reads its h0 before it writes). All
// contiguous. Launches on `stream` and returns the launch's cudaError_t.
extern "C" int selective_scan_launch(const void* dt, const void* xc,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* Dskip,
                                     const void* h0, void* y, void* hout,
                                     int dtype, int batch, int S, int di,
                                     int ds, void* stream) {
  if (batch <= 0 || di <= 0) return 0;
  if (S < 0 || ds <= 0 || ds > kMaxState || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(dt, xc, A, Bm, Cm, Dskip, h0, y, hout, batch, S, di,
                         ds, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(dt, xc, A, Bm, Cm, Dskip, h0, y, hout, batch,
                                 S, di, ds, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
