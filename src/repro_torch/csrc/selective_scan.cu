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
// Rounding follows the reference (ssm.py:80-84): db is formed in the
// activation type, one rounding after each product (bf16(bf16(dt B) x)),
// and only then taken to f32; the recurrence and the output sum run in
// f32. da = exp(dt A) is computed as exp2(dt A') with A' = A log2(e) formed
// once a channel: one FMUL and one ex2.approx.ftz.f32, a few f32 ulps of
// da from the plain version's exp. The plain version
// (kernels/selective_scan/ref.py:selective_scan_plain) does the reference's
// steps one token at a time; ref.py:selective_scan_ex2_plain mirrors this
// kernel's (exp2 of the pre-scaled A, db's two bf16 roundings); sums over
// d_state run here in index order.
//
// What bounds it on an H100: the SFU, then instruction slots, then bytes.
// At jamba's prefill (8 x 2,048 tokens, d_inner 16,384, d_state 16) there
// are 4.29e9 (token, channel, state) steps, each with one exponential: at
// 16 SFU results a clock an SM (9.0) that is ~1.03 ms at 1.98 GHz. A
// step's other work is ~6 instruction slots (dt A', the bf16 products,
// their unpacking, the two FMAs): ~0.9 ms. The bytes (dt, x in bf16, y
// in f32, the states) take ~0.65 ms at 3.35 TB/s. The design:
//  - A thread takes two adjacent channels of a batch row: their d_state
//    values of h and of A' live in registers (128 at most: 8 CTAs of 64
//    threads an SM, 1,056 slots for jamba's 1,024 CTAs, one wave) and it
//    walks the tokens in order. dt and x of the pair are one 32-bit load.
//    The state sum runs in index order.
//  - db of the two channels for a state with two __hmul2 on
//    __nv_bfloat162 ((dt0, dt1) (B_s, B_s), then (x0, x1)): each product of
//    two bf16 values rounded once to bf16 (RNE), bit for bit what the f32
//    product rounded by __float2bfloat16_rn gives; unpacked to f32 by an
//    integer shift and a mask, not F2F (conversions run at 16 a clock, as
//    the SFU). The f32 path keeps f32 products.
//  - h = fma(da, h, db) and acc = fma(h, C, acc) as __fmaf_rn: build.py
//    compiles every source with -fmad=false, which the kNN kernels'
//    bit-equality needs; this kernel's bar is a tolerance (2e-5 of the
//    largest value), not bit for bit.
//  - Tokens come in stages of 16: cp.async copies stage n + 1's dt, x
//    (16-byte chunks of the CTA's row) and B, C while stage n runs; a short
//    pass casts C to f32 and doubles each B_s into both halves of a word
//    once for the CTA. Rows that are not 16-byte aligned (d_inner or
//    d_state not a multiple of 16 bytes) are staged by plain loads.
// What the card shows (chip_smoke's selective_scan row): 32 MUFU and no
// F2F a thread a token in the loop, the SFU busy about three quarters of
// the time; a quarter of the channels takes well over a quarter of the
// time (the row's grid sweep), so a warp is latency-bound and 4 warps an
// SMSP do not hide it. Prefill and decode (S = 1) are the same launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;    // threads a CTA, two channels each
constexpr int kChannels = 128;  // channels a CTA
constexpr int kTokens = 16;     // tokens a stage
constexpr int kMaxState = 16;
constexpr float kLog2e = 1.4426950408889634f;

// how a staged element of type T is stored: bf16 as its bits
template <typename T>
struct RawOf {
  using type = float;
};
template <>
struct RawOf<__nv_bfloat16> {
  using type = unsigned short;
};

template <typename T>
struct __align__(16) Smem {
  using Raw = typename RawOf<T>::type;
  Raw dt[2][kTokens][kChannels], x[2][kTokens][kChannels];
  Raw B[2][kTokens][kMaxState], C[2][kTokens][kMaxState];
  unsigned Bd[kTokens][kMaxState];   // bf16: B_s in both halves of a word
  float Cf[kTokens][kMaxState];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ float to_raw(float v) { return v; }
__device__ __forceinline__ unsigned short to_raw(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
// the low and the high bf16 of a word, as f32 (integer moves, no F2F)
__device__ __forceinline__ float lo_f32(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float ex2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ unsigned hmul2(unsigned a, unsigned b) {
  const __nv_bfloat162 p =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// tokens [t0, t0 + n) of batch row `row` (= b * S) into stage buffer `buf`
template <typename T>
__device__ __forceinline__ void stage(Smem<T>& sm, int buf, const T* dt,
                                      const T* xc, const T* Bm, const T* Cm,
                                      long long row, int t0, int n, int c0,
                                      int di, int ds, bool vec_x,
                                      bool vec_bc) {
  constexpr int CT = 16 / sizeof(T);           // elements a 16-byte chunk
  constexpr int RC = kChannels / CT;           // chunks of a CTA's row
  if (vec_x) {   // di % CT == 0: whole chunks
    for (int i = threadIdx.x; i < n * RC; i += kThreads) {
      const int t = i / RC, c = (i % RC) * CT;
      if (c0 + c >= di) continue;
      const long long off = (row + t0 + t) * di + c0 + c;
      cp_async16(&sm.dt[buf][t][c], dt + off);
      cp_async16(&sm.x[buf][t][c], xc + off);
    }
  } else {
    for (int i = threadIdx.x; i < n * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      const long long off = (row + t0 + t) * di + c0 + c;
      const bool in = c0 + c < di;
      sm.dt[buf][t][c] = in ? to_raw(dt[off]) : 0;
      sm.x[buf][t][c] = in ? to_raw(xc[off]) : 0;
    }
  }
  if (vec_bc) {   // ds * sizeof(T) % 16 == 0: rows of whole chunks
    const int rc = ds / CT;
    for (int i = threadIdx.x; i < n * rc; i += kThreads) {
      const int t = i / rc, s = (i % rc) * CT;
      const long long off = (row + t0 + t) * ds + s;
      cp_async16(&sm.B[buf][t][s], Bm + off);
      cp_async16(&sm.C[buf][t][s], Cm + off);
    }
  } else {
    for (int i = threadIdx.x; i < n * ds; i += kThreads) {
      const int t = i / ds, s = i % ds;
      const long long off = (row + t0 + t) * ds + s;
      sm.B[buf][t][s] = to_raw(Bm[off]);
      sm.C[buf][t][s] = to_raw(Cm[off]);
    }
  }
}

// db of two channels for state s: bf16(bf16(d B_s) x) for bf16 (one
// __hmul2 a product on the channels' pair, each product rounded once,
// RNE), (d B_s) x in f32 for f32
struct Pair {
  float c0, c1;
};

__device__ __forceinline__ Pair db_pair(const Smem<__nv_bfloat16>& sm,
                                        int buf, int t, int s, unsigned dw,
                                        unsigned xw, float, float, float,
                                        float) {
  const unsigned p = hmul2(hmul2(dw, sm.Bd[t][s]), xw);
  return {lo_f32(p), hi_f32(p)};
}

__device__ __forceinline__ Pair db_pair(const Smem<float>& sm, int buf,
                                        int t, int s, unsigned, unsigned,
                                        float d0, float d1, float x0,
                                        float x1) {
  const float b = sm.B[buf][t][s];
  return {d0 * b * x0, d1 * b * x1};
}

// a thread's two channels' dt (or x) as f32, and (bf16) the pair's word
__device__ __forceinline__ unsigned load_pair(const float* p, float& a,
                                              float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
  return 0u;
}
__device__ __forceinline__ unsigned load_pair(const unsigned short* p,
                                              float& a, float& b) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  a = lo_f32(w);
  b = hi_f32(w);
  return w;
}

// a bf16 value's bits in both halves of a word (f32: unused)
__device__ __forceinline__ unsigned dup_bits(float) { return 0u; }
__device__ __forceinline__ unsigned dup_bits(unsigned short bits) {
  return static_cast<unsigned>(bits) * 0x10001u;
}

// kFull: ds == kMaxState (no guards on the states)
template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads, 8)
selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ xc,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm,
                      const float* __restrict__ Dskip, const float* h0,
                      float* __restrict__ y, float* hout, int S, int di,
                      int ds_arg, bool vec_x, bool vec_bc) {
  __shared__ Smem<T> sm;
  const int ds = kFull ? kMaxState : ds_arg;
  const int b = blockIdx.y, c0 = blockIdx.x * kChannels;
  const int lc = 2 * threadIdx.x;               // the CTA's channels lc, +1
  const int c = c0 + lc;
  const bool live[2] = {c < di, c + 1 < di};
  float h[2][kMaxState], a2[2][kMaxState], dskip[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long hrow = (static_cast<long long>(b) * di + c + e) * ds;
    const float* ap = A + static_cast<long long>(c + e) * ds;
#pragma unroll
    for (int s = 0; s < kMaxState; s += 4) {
      float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), av = hv;
      if (kFull && live[e]) {   // rows of 64 bytes
        hv = *reinterpret_cast<const float4*>(h0 + hrow + s);
        av = *reinterpret_cast<const float4*>(ap + s);
      } else if (live[e]) {
        if (s < ds) { hv.x = h0[hrow + s]; av.x = ap[s]; }
        if (s + 1 < ds) { hv.y = h0[hrow + s + 1]; av.y = ap[s + 1]; }
        if (s + 2 < ds) { hv.z = h0[hrow + s + 2]; av.z = ap[s + 2]; }
        if (s + 3 < ds) { hv.w = h0[hrow + s + 3]; av.w = ap[s + 3]; }
      }
      h[e][s] = hv.x; h[e][s + 1] = hv.y; h[e][s + 2] = hv.z;
      h[e][s + 3] = hv.w;
      a2[e][s] = av.x * kLog2e; a2[e][s + 1] = av.y * kLog2e;
      a2[e][s + 2] = av.z * kLog2e; a2[e][s + 3] = av.w * kLog2e;
    }
    dskip[e] = live[e] ? Dskip[c + e] : 0.f;
  }
  const long long row = static_cast<long long>(b) * S;

  if (S > 0) {
    stage(sm, 0, dt, xc, Bm, Cm, row, 0, min(kTokens, S), c0, di, ds, vec_x,
          vec_bc);
  }
  cp_async_commit();
  for (int t0 = 0, buf = 0; t0 < S; t0 += kTokens, buf ^= 1) {
    const int n = min(kTokens, S - t0);
    cp_async_wait_all();
    __syncthreads();   // stage t0 landed; the last stage's compute is done
    if (t0 + kTokens < S) {
      stage(sm, buf ^ 1, dt, xc, Bm, Cm, row, t0 + kTokens,
            min(kTokens, S - t0 - kTokens), c0, di, ds, vec_x, vec_bc);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < n * ds; i += kThreads) {
      const int t = i / ds, s = i % ds;
      sm.Cf[t][s] = to_f32(sm.C[buf][t][s]);
      sm.Bd[t][s] = dup_bits(sm.B[buf][t][s]);
    }
    __syncthreads();
    const long long yrow = (row + t0) * di + c;
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      float d0, d1, x0, x1;
      const unsigned dw = load_pair(&sm.dt[buf][t][lc], d0, d1);
      const unsigned xw = load_pair(&sm.x[buf][t][lc], x0, x1);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxState; ++s) {
        if (s < ds) {
          const Pair db = db_pair(sm, buf, t, s, dw, xw, d0, d1, x0, x1);
          const float cs = sm.Cf[t][s];
          h[0][s] = __fmaf_rn(ex2(d0 * a2[0][s]), h[0][s], db.c0);
          h[1][s] = __fmaf_rn(ex2(d1 * a2[1][s]), h[1][s], db.c1);
          acc0 = __fmaf_rn(h[0][s], cs, acc0);
          acc1 = __fmaf_rn(h[1][s], cs, acc1);
        }
      }
      const long long off = yrow + static_cast<long long>(t) * di;
      if (live[0]) y[off] = __fmaf_rn(x0, dskip[0], acc0);
      if (live[1]) y[off + 1] = __fmaf_rn(x1, dskip[1], acc1);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long hrow = (static_cast<long long>(b) * di + c + e) * ds;
    if (live[e] && kFull) {
#pragma unroll
      for (int s = 0; s < kMaxState; s += 4) {
        *reinterpret_cast<float4*>(hout + hrow + s) =
            make_float4(h[e][s], h[e][s + 1], h[e][s + 2], h[e][s + 3]);
      }
    } else if (live[e]) {
#pragma unroll
      for (int s = 0; s < kMaxState; ++s) {
        if (s < ds) hout[hrow + s] = h[e][s];
      }
    }
  }
}

template <typename T>
int launch(const void* dt, const void* xc, const void* A, const void* Bm,
           const void* Cm, const void* Dskip, const void* h0, void* y,
           void* hout, int batch, int S, int di, int ds, cudaStream_t st) {
  const dim3 grid((di + kChannels - 1) / kChannels, batch);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool vec_x = di * sizeof(T) % 16 == 0 && aligned(dt) && aligned(xc);
  const bool vec_bc = ds * sizeof(T) % 16 == 0 && aligned(Bm) && aligned(Cm);
  const auto kernel = ds == kMaxState ? selective_scan_kernel<T, true>
                                      : selective_scan_kernel<T, false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(dt), static_cast<const T*>(xc),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dskip),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hout), S, di, ds, vec_x, vec_bc);
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
