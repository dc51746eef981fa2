// The backward of Mamba-1's selective scan (csrc/selective_scan.cu): for
// each (batch, channel i, state n), with a_t = exp(dt_t A), b_t = dt_t B_t
// x_t (formed in the activation type, as the forward does; its gradient
// is the product's), h_{t-1} the state before token t and g_t = dy_t C_t +
// a_{t+1} g_{t+1} the gradient of h_t (g past the last token 0, the last
// state taking no gradient):
//   dC_t[n] = sum_i dy_t[i] h_t[i, n]
//   dlog a_t = g_t a_t h_{t-1}
//   ddt_t = sum_n (dlog a_t[n] A[n] + g_t[n] B_t[n] x_t)
//   dA = sum_{b,t} dlog a_t dt_t
//   dB_t[n] = sum_i g_t[i, n] dt_t[i] x_t[i]
//   dx_t = sum_n g_t[n] dt_t B_t[n] + dy_t D
//   dD = sum_{b,t} dy_t x_t, and dh0 = a g of the first token.
//
// Replaces no TPU kernel. The reference trains Mamba through XLA's
// autodiff of src/repro/models/ssm.py:_selective_scan and the C
// contraction of mamba_block (ssm.py:21-89); the port's forward is
// csrc/selective_scan.cu, and this is its gradient, joined to it by
// kernels/selective_scan/kernel.py:SelectiveScan. The plain version is
// kernels/selective_scan/ref.py:selective_scan_bwd_plain.
//
// The walk back needs h_{t-1}. Dividing h_t - b_t by a_t would rebuild
// it, but a_t underflows to 0 in f32, so states are recomputed from
// checkpoints, as mamba's own backward does. Three launches:
//  - selective_scan_bwd_ckpt_kernel (pass 1) runs the recurrence forward
//    from h0 (dt, x, B only) and writes the state at every kChunk-th token
//    to a scratch buffer; the forward kernel stays as it is and nothing
//    is held between forward and backward. Apart from the backward it
//    needs 128 registers, so 8 CTAs fit an SM: jamba's 1,024 CTAs in one
//    wave, where inside the backward the pass ran at the backward's 4;
//  - selective_scan_bwd_kernel (pass 2) takes the chunks from the last: it
//    reloads the chunk's checkpoint, recomputes its states (each thread's
//    own in shared memory) while it forms dC, then walks the chunk
//    backwards with g in registers. a_t is recomputed in the walk (ex2 on
//    the SFU, as the forward: exp2 of dt A log2(e)); db is recomputed bit
//    for bit as the forward forms it (two __hmul2 for bf16);
//  - selective_scan_bwd_reduce_kernel (below).
// In both passes a chunk's inputs (and in pass 2 the next checkpoint)
// are fetched into registers while the last chunk computes, then put in
// shared memory, so the loads' latency hides behind a chunk's work.
// A thread holds 2 adjacent channels by 8 states (a lane pair holds a
// channel pair's 16 states; a warp 32 channels, a CTA 64). The sums over
// states (ddt, dx) are the thread's FMAs and two shuffles over the lane
// pair, each lane keeping one channel; the sums over channels (dB, dC)
// are the thread's 2 FMAs a state and four shuffles over the warp's 16
// channel-pair lanes, each lane keeping one state, then the CTA's two
// warps added through shared memory. dB, dC (over the CTA blocks of
// d_inner), dA and dD (over the batch) leave as partials and the reduce
// kernel adds them in a fixed order, in f64, rounding once. No atomics:
// two calls give the same bits.
//
// What bounds it on an H100: the SFU, then FP32 instruction slots. A
// (token, channel, state) costs two exponentials (pass 2's recompute and
// the walk's; pass 1 a third) and ~20 FP32 instructions over the three
// passes. At jamba's training shape (4 x 2,048 tokens, d_inner 16,384,
// d_state 16) that is 2.15e9 steps: 6.4e9 exponentials, ~1.5 ms at 16 a
// clock an SM on 132 SMs at 1.98 GHz, and ~4.3e10 instructions, ~1.3 ms.
// The checkpoints add 1.07 GB of writes and as many reads. The backward's
// CTA of 64 threads holds 40 KB of shared memory and ~220 registers a
// thread: 4 CTAs (8 warps) an SM, 1,024 CTAs in two full waves, so the
// loop is latency-bound first. Throwaway builds timed in one call on the
// card (random inputs of that shape, device-bound): each chunk loaded
// between barriers 7.08 ms, with the register prefetch 5.44, and kChunk 4
// with it 6.60; pass 1 as its own kernel at 8 CTAs an SM 5.09 against
// 5.43 in one kernel.
//
// A redesign for more resident warps lost to this one in the same kind
// of builds: the chunk inputs in a 2-stage cp.async ring instead of the
// register prefetch and g carried as a g (168 registers) fit 6 CTAs an SM
// at 6-token chunks, but 1,024 CTAs over 792 resident slots is 1.29
// waves, and shorter chunks write more checkpoints; at 8-token chunks the
// ring's CTA needs 46 KB and fits 4 CTAs an SM, as this one does, with
// more instructions a token; forcing 8 CTAs (4-token chunks, 128
// registers) spilled. Keeping a_t beside h_{t-1} for the walk would
// double the states' shared memory, which costs CTAs at every chunk
// length that keeps the checkpoint traffic bounded. Time segments (the
// reference's chunked scan, mirrored on the CPU by
// kernels/selective_scan/ref.py:selective_scan_bwd_segmented_plain) were
// not taken: jamba's 1,024 CTAs already fill the card, one wave of the
// checkpoint kernel and two of the backward's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;    // threads a CTA: two warps
constexpr int kChannels = 64;   // channels a CTA
constexpr int kChunk = 8;       // tokens between pass 1's checkpoints
constexpr int kMaxState = 16;
constexpr int kHalf = 8;        // states a thread
constexpr int kCkptBlocks = 8;  // the checkpoint kernel's CTAs an SM
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

template <typename T>
struct RawOf {
  using type = float;
};
template <>
struct RawOf<__nv_bfloat16> {
  using type = unsigned short;
};

// a chunk's inputs, as the walks read them
template <typename T>
struct __align__(16) InSmem {
  using Raw = typename RawOf<T>::type;
  Raw dt[kChunk][kChannels], x[kChunk][kChannels];
  float dy[kChunk][kChannels];
  unsigned Bd[kChunk][kMaxState];   // bf16: B_s in both halves of a word
  float Bf[kChunk][kMaxState], Cf[kChunk][kMaxState];   // 0 past d_state
};

template <typename T>
struct __align__(16) Smem : InSmem<T> {
  float part_b[kChunk][2][kMaxState], part_c[kChunk][2][kMaxState];
  // h_{t-1} of the chunk's tokens, [token][tile element][thread]
  float states[kChunk][2 * kHalf][kThreads];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ float to_raw(float v) { return v; }
__device__ __forceinline__ unsigned short to_raw(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
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

__device__ __forceinline__ unsigned load_pair(const float* p, float& a,
                                              float& b) {
  a = p[0];
  b = p[1];
  return 0u;
}
__device__ __forceinline__ unsigned load_pair(const unsigned short* p,
                                              float& a, float& b) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  a = lo_f32(w);
  b = hi_f32(w);
  return w;
}

__device__ __forceinline__ unsigned dup_bits(float) { return 0u; }
__device__ __forceinline__ unsigned dup_bits(unsigned short bits) {
  return static_cast<unsigned>(bits) * 0x10001u;
}

struct Pair {
  float c0, c1;
};

// db of the thread's two channels for state s, as the forward forms it
__device__ __forceinline__ Pair db_pair(const InSmem<__nv_bfloat16>& sm,
                                        int t, int s, unsigned dw,
                                        unsigned xw, float, float, float,
                                        float) {
  const unsigned p = hmul2(hmul2(dw, sm.Bd[t][s]), xw);
  return {lo_f32(p), hi_f32(p)};
}
__device__ __forceinline__ Pair db_pair(const InSmem<float>& sm, int t, int s,
                                        unsigned, unsigned, float d0,
                                        float d1, float x0, float x1) {
  const float b = sm.Bf[t][s];
  return {d0 * b * x0, d1 * b * x1};
}

// a thread's share of a chunk's inputs, fetched into registers while the
// last chunk computes, then put in shared memory
template <typename T>
struct Chunk {
  using Raw = typename RawOf<T>::type;
  static constexpr int NX = kChunk * kChannels / kThreads;
  static constexpr int NS = (kChunk * kMaxState + kThreads - 1) / kThreads;
  Raw dt[NX], x[NX], B[NS], C[NS];
  float dy[NX];
};

// tokens [t0, t0 + n) of batch b: dt, x (the CTA's channels, 0 past
// d_inner) and B (0 past d_state), with kAll dy and C as well (0 past
// token n); `row` = b * S + t0
template <bool kAll, typename T>
__device__ __forceinline__ void fetch(Chunk<T>& c, const T* dt, const T* xc,
                                      const T* Bm, const T* Cm,
                                      const float* dy, long long row, int n,
                                      int c0, int di, int ds) {
  const auto zero = to_raw(T(0.f));
#pragma unroll
  for (int j = 0; j < Chunk<T>::NX; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / kChannels, ch = i % kChannels;
    const long long off = (row + t) * di + c0 + ch;
    const bool in = t < n && c0 + ch < di;
    c.dt[j] = in ? to_raw(dt[off]) : zero;
    c.x[j] = in ? to_raw(xc[off]) : zero;
    if (kAll) c.dy[j] = in ? dy[off] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < Chunk<T>::NS; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / kMaxState, s = i % kMaxState;
    const long long off = (row + t) * ds + s;
    const bool in = i < kChunk * kMaxState && t < n && s < ds;
    c.B[j] = in ? to_raw(Bm[off]) : zero;
    if (kAll) c.C[j] = in ? to_raw(Cm[off]) : zero;
  }
}

template <bool kAll, typename T>
__device__ __forceinline__ void put(InSmem<T>& sm, const Chunk<T>& c) {
#pragma unroll
  for (int j = 0; j < Chunk<T>::NX; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / kChannels, ch = i % kChannels;
    sm.dt[t][ch] = c.dt[j];
    sm.x[t][ch] = c.x[j];
    if (kAll) sm.dy[t][ch] = c.dy[j];
  }
#pragma unroll
  for (int j = 0; j < Chunk<T>::NS; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < kChunk * kMaxState) {
      const int t = i / kMaxState, s = i % kMaxState;
      sm.Bf[t][s] = to_f32(c.B[j]);
      sm.Bd[t][s] = dup_bits(c.B[j]);
      if (kAll) sm.Cf[t][s] = to_f32(c.C[j]);
    }
  }
}

// the sum over the warp's 16 channel-pair lanes (lane bits 1-4) of the
// thread's partials of its 8 states: the lane keeps state 4 b4 + 2 b3 +
// b2 of them (lanes differing in bit 1 hold the same sum)
__device__ __forceinline__ float channel_sum(const float (&p)[kHalf],
                                             int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float q4[4], q2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? p[i] : p[i + 4];
    q4[i] = (b4 ? p[i + 4] : p[i]) + __shfl_xor_sync(kAll, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? q4[i] : q4[i + 2];
    q2[i] = (b3 ? q4[i + 2] : q4[i]) + __shfl_xor_sync(kAll, send, 8);
  }
  const float send = b2 ? q2[0] : q2[1];
  const float q = (b2 ? q2[1] : q2[0]) + __shfl_xor_sync(kAll, send, 4);
  return q + __shfl_xor_sync(kAll, q, 2);
}

// the checkpoints: the state at every kChunk-th token from h0 (pass 1),
// ckpt [B][chunks][gridDim.x * kChannels][kMaxState]
template <typename T>
__global__ void __launch_bounds__(kThreads, kCkptBlocks)
selective_scan_bwd_ckpt_kernel(const T* __restrict__ dt,
                               const T* __restrict__ xc,
                               const float* __restrict__ A,
                               const T* __restrict__ Bm,
                               const float* __restrict__ h0,
                               float* __restrict__ ckpt, int S, int di,
                               int ds) {
  __shared__ InSmem<T> sm;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  const int sh = lane & 1;                      // states 8 sh .. 8 sh + 7
  const int lc = wp * 32 + (lane & ~1);         // channels lc, lc + 1
  const int b = blockIdx.y, c0 = blockIdx.x * kChannels;
  const int c = c0 + lc, n0 = sh * kHalf;
  const long long row = static_cast<long long>(b) * S;
  const int chunks = (S + kChunk - 1) / kChunk;
  const long long width = static_cast<long long>(gridDim.x) * kChannels;

  float h[2][kHalf], a2[2][kHalf];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const bool in = c + e < di && n0 + i < ds;
      a2[e][i] = (in ? A[static_cast<long long>(c + e) * ds + n0 + i] : 0.f) *
                 kLog2e;
      h[e][i] = in ? h0[(static_cast<long long>(b) * di + c + e) * ds + n0 + i]
                   : 0.f;
    }
  }

  Chunk<T> in;
  // pass 1 stages dt, x and B only: no C, no dy
  fetch<false, T>(in, dt, xc, Bm, nullptr, nullptr, row, min(kChunk, S), c0,
                  di, ds);
  for (int j = 0; j < chunks; ++j) {
    const int t0 = j * kChunk, n = min(kChunk, S - t0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* p = ckpt + ((static_cast<long long>(b) * chunks + j) * width +
                         c + e) * kMaxState + n0;
      *reinterpret_cast<float4*>(p) =
          make_float4(h[e][0], h[e][1], h[e][2], h[e][3]);
      *reinterpret_cast<float4*>(p + 4) =
          make_float4(h[e][4], h[e][5], h[e][6], h[e][7]);
    }
    __syncthreads();
    put<false>(sm, in);
    __syncthreads();
    if (j + 1 < chunks) {
      fetch<false, T>(in, dt, xc, Bm, nullptr, nullptr, row + t0 + kChunk,
                      min(kChunk, S - t0 - kChunk), c0, di, ds);
    }
#pragma unroll 1
    for (int t = 0; t < n; ++t) {
      float d0, d1, x0, x1;
      const unsigned dw = load_pair(&sm.dt[t][lc], d0, d1);
      const unsigned xw = load_pair(&sm.x[t][lc], x0, x1);
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const Pair db = db_pair(sm, t, n0 + i, dw, xw, d0, d1, x0, x1);
        h[0][i] = __fmaf_rn(ex2(d0 * a2[0][i]), h[0][i], db.c0);
        h[1][i] = __fmaf_rn(ex2(d1 * a2[1][i]), h[1][i], db.c1);
      }
    }
  }
}

// partials: dB, dC [gridDim.x][B][S][ds]; dA [B][di][ds]; dD [B][di].
// ckpt [B][chunks][gridDim.x * kChannels][kMaxState], from the checkpoint
// kernel
template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ xc,
                          const float* __restrict__ A,
                          const T* __restrict__ Bm, const T* __restrict__ Cm,
                          const float* __restrict__ Dskip,
                          const float* __restrict__ dy,
                          const float* __restrict__ ckpt,
                          float* __restrict__ db_part,
                          float* __restrict__ dc_part,
                          float* __restrict__ da_part,
                          float* __restrict__ dd_part,
                          float* __restrict__ ddt, float* __restrict__ dx,
                          float* __restrict__ dh0, int S, int di, int ds) {
  __shared__ Smem<T> sm;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  const int sh = lane & 1;                      // states 8 sh .. 8 sh + 7
  const int lc = wp * 32 + (lane & ~1);         // channels lc, lc + 1
  const int b = blockIdx.y, B = gridDim.y, c0 = blockIdx.x * kChannels;
  const int c = c0 + lc, n0 = sh * kHalf;
  const int own = c + sh;                       // the channel the lane keeps
  const long long row = static_cast<long long>(b) * S;
  const int chunks = (S + kChunk - 1) / kChunk;
  const long long width = static_cast<long long>(gridDim.x) * kChannels;
  const int keep = (lane >> 2) & 7;             // the state channel_sum keeps

  float h[2][kHalf], a2[2][kHalf], Av[2][kHalf];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const bool in = c + e < di && n0 + i < ds;
      const long long at = static_cast<long long>(c + e) * ds + n0 + i;
      Av[e][i] = in ? A[at] : 0.f;
      a2[e][i] = Av[e][i] * kLog2e;
    }
  }
  const float Dv = own < di ? Dskip[own] : 0.f;

  Chunk<T> in;
  // pass 2: the chunks from the last, each recomputed, then walked back
  float g[2][kHalf], an[2][kHalf], dA[2][kHalf], dD = 0.f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      g[e][i] = 0.f;
      an[e][i] = 1.f;
      dA[e][i] = 0.f;
    }
  }
  float nxt[2][kHalf];   // the next chunk's checkpoint
  const auto ckpt_at = [&](int j, int e) {
    return ckpt + ((static_cast<long long>(b) * chunks + j) * width + c + e) *
                      kMaxState + n0;
  };
  if (chunks > 0) {
    const int j = chunks - 1;
    fetch<true>(in, dt, xc, Bm, Cm, dy, row + j * kChunk, S - j * kChunk, c0,
                di, ds);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int i = 0; i < kHalf; ++i) nxt[e][i] = ckpt_at(j, e)[i];
    }
  }
  for (int j = chunks - 1; j >= 0; --j) {
    const int t0 = j * kChunk, n = min(kChunk, S - t0);
    __syncthreads();   // the last chunk's reads are done
    put<true>(sm, in);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int i = 0; i < kHalf; ++i) h[e][i] = nxt[e][i];
    }
    __syncthreads();
    if (j > 0) {
      fetch<true>(in, dt, xc, Bm, Cm, dy, row + t0 - kChunk, kChunk, c0, di,
                  ds);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int i = 0; i < kHalf; ++i) nxt[e][i] = ckpt_at(j - 1, e)[i];
      }
    }

    // recompute h_{t-1} of the chunk's tokens, and dC
    for (int t = 0; t < n; ++t) {
      float d0, d1, x0, x1;
      const unsigned dw = load_pair(&sm.dt[t][lc], d0, d1);
      const unsigned xw = load_pair(&sm.x[t][lc], x0, x1);
      const float y0 = sm.dy[t][lc], y1 = sm.dy[t][lc + 1];
      float p[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        sm.states[t][i][tid] = h[0][i];
        sm.states[t][kHalf + i][tid] = h[1][i];
        const Pair db = db_pair(sm, t, n0 + i, dw, xw, d0, d1, x0, x1);
        h[0][i] = __fmaf_rn(ex2(d0 * a2[0][i]), h[0][i], db.c0);
        h[1][i] = __fmaf_rn(ex2(d1 * a2[1][i]), h[1][i], db.c1);
        p[i] = __fmaf_rn(y1, h[1][i], y0 * h[0][i]);
      }
      const float q = channel_sum(p, lane);
      if ((lane & 2) == 0) sm.part_c[t][wp][n0 + keep] = q;
    }

    // walk the chunk back: g, ddt, dx, dB's partials, dA, dD
    for (int t = n - 1; t >= 0; --t) {
      float d0, d1, x0, x1;
      load_pair(&sm.dt[t][lc], d0, d1);
      load_pair(&sm.x[t][lc], x0, x1);
      const float y0 = sm.dy[t][lc], y1 = sm.dy[t][lc + 1];
      const float dx0 = d0 * x0, dx1 = d1 * x1;
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, p[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float Bs = sm.Bf[t][n0 + i], Cs = sm.Cf[t][n0 + i];
        const float a0 = ex2(d0 * a2[0][i]), a1 = ex2(d1 * a2[1][i]);
        g[0][i] = __fmaf_rn(an[0][i], g[0][i], y0 * Cs);
        g[1][i] = __fmaf_rn(an[1][i], g[1][i], y1 * Cs);
        const float l0 = g[0][i] * a0 * sm.states[t][i][tid];
        const float l1 = g[1][i] * a1 * sm.states[t][kHalf + i][tid];
        s1[0] = __fmaf_rn(l0, Av[0][i], s1[0]);
        s1[1] = __fmaf_rn(l1, Av[1][i], s1[1]);
        s2[0] = __fmaf_rn(g[0][i], Bs, s2[0]);
        s2[1] = __fmaf_rn(g[1][i], Bs, s2[1]);
        dA[0][i] = __fmaf_rn(l0, d0, dA[0][i]);
        dA[1][i] = __fmaf_rn(l1, d1, dA[1][i]);
        p[i] = __fmaf_rn(g[1][i], dx1, g[0][i] * dx0);
        an[0][i] = a0;
        an[1][i] = a1;
      }
      const float q = channel_sum(p, lane);
      if ((lane & 2) == 0) sm.part_b[t][wp][n0 + keep] = q;
      // the lane pair's sums over the 16 states, lane sh keeping channel sh
      float S1 = sh ? s1[1] : s1[0], S2 = sh ? s2[1] : s2[0];
      S1 += __shfl_xor_sync(kAll, sh ? s1[0] : s1[1], 1);
      S2 += __shfl_xor_sync(kAll, sh ? s2[0] : s2[1], 1);
      const float xo = sh ? x1 : x0, dto = sh ? d1 : d0, yo = sh ? y1 : y0;
      if (own < di) {
        const long long off = (row + t0 + t) * di + own;
        ddt[off] = __fmaf_rn(xo, S2, S1);
        dx[off] = __fmaf_rn(dto, S2, yo * Dv);
      }
      dD = __fmaf_rn(yo, xo, dD);
    }
    __syncthreads();
    for (int i = tid; i < n * ds; i += kThreads) {
      const int t = i / ds, s = i % ds;
      const long long off =
          ((static_cast<long long>(blockIdx.x) * B + b) * S + t0 + t) * ds + s;
      db_part[off] = sm.part_b[t][0][s] + sm.part_b[t][1][s];
      dc_part[off] = sm.part_c[t][0][s] + sm.part_c[t][1][s];
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      if (c + e < di && n0 + i < ds) {
        const long long at = (static_cast<long long>(b) * di + c + e) * ds +
                             n0 + i;
        dh0[at] = an[e][i] * g[e][i];
        da_part[at] = dA[e][i];
      }
    }
  }
  if (own < di) dd_part[static_cast<long long>(b) * di + own] = dD;
}

struct Job {
  const float* part;
  float* out;
  long long n;
  int parts;
};
struct Jobs {
  Job job[4];
};

// out[i] = sum over p of part[p][i], in order of p, in f64, rounded once
__global__ void selective_scan_bwd_reduce_kernel(Jobs jobs) {
  const Job jb = jobs.job[blockIdx.y];
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < jb.n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    double acc = 0.0;
    for (int p = 0; p < jb.parts; ++p) acc += jb.part[p * jb.n + i];
    jb.out[i] = static_cast<float>(acc);
  }
}

template <typename T>
int launch(const void* dt, const void* xc, const void* A, const void* Bm,
           const void* Cm, const void* Dskip, const void* h0, const void* dy,
           void* ckpt, void* db_part, void* dc_part, void* da_part,
           void* dd_part, void* ddt, void* dx, void* dA, void* dB, void* dC,
           void* dD, void* dh0, int batch, int S, int di, int ds,
           cudaStream_t st) {
  const int blocks = (di + kChannels - 1) / kChannels;
  selective_scan_bwd_ckpt_kernel<T><<<dim3(blocks, batch), kThreads, 0,
                                      st>>>(
      static_cast<const T*>(dt), static_cast<const T*>(xc),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const float*>(h0), static_cast<float*>(ckpt), S, di, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  selective_scan_bwd_kernel<T><<<dim3(blocks, batch), kThreads, 0, st>>>(
      static_cast<const T*>(dt), static_cast<const T*>(xc),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dskip),
      static_cast<const float*>(dy), static_cast<const float*>(ckpt),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(da_part), static_cast<float*>(dd_part),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(dh0), S, di, ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nbc = static_cast<long long>(batch) * S * ds;
  Jobs jobs{};
  jobs.job[0] = {static_cast<const float*>(db_part), static_cast<float*>(dB),
                 nbc, blocks};
  jobs.job[1] = {static_cast<const float*>(dc_part), static_cast<float*>(dC),
                 nbc, blocks};
  jobs.job[2] = {static_cast<const float*>(da_part), static_cast<float*>(dA),
                 static_cast<long long>(di) * ds, batch};
  jobs.job[3] = {static_cast<const float*>(dd_part), static_cast<float*>(dD),
                 di, batch};
  const long long most = nbc > static_cast<long long>(di) * ds
                             ? nbc : static_cast<long long>(di) * ds;
  const long long want = (most + 255) / 256;
  const int gx = static_cast<int>(want < 1056 ? (want > 0 ? want : 1)
                                              : 1056);
  selective_scan_bwd_reduce_kernel<<<dim3(gx, 4), 256, 0, st>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

// resident CTAs an SM of the backward (ckpt = 0) or checkpoint kernel
template <typename T>
int resident(int ckpt) {
  int n = 0;
  const cudaError_t err =
      ckpt ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, selective_scan_bwd_ckpt_kernel<T>, kThreads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, selective_scan_bwd_kernel<T>, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// The checkpoint interval and the channels a CTA (the wrapper sizes the
// scratch with them).
extern "C" int selective_scan_bwd_chunk() { return kChunk; }
extern "C" int selective_scan_bwd_channels() { return kChannels; }

// The backward kernel's (ckpt = 0) or the checkpoint kernel's (ckpt = 1)
// resident CTAs an SM for dtype (0 f32, 1 bf16), by the occupancy
// calculator; a negative cudaError_t on failure.
extern "C" int selective_scan_bwd_resident(int dtype, int ckpt) {
  if (dtype == 0) return resident<float>(ckpt);
  if (dtype == 1) return resident<__nv_bfloat16>(ckpt);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// dt, xc: (batch, S, di) and Bm, Cm: (batch, S, ds) in the activation type
// (dtype 0 f32, 1 bf16); A: (di, ds), Dskip: (di,), h0: (batch, di, ds)
// and dy: (batch, S, di), the gradient of y, f32. Scratch, f32 (nb =
// ceil(di / 64)): ckpt (batch, ceil(S / kChunk), nb * 64, 16); db_part,
// dc_part (nb, batch, S, ds); da_part (batch, di, ds); dd_part (batch,
// di). Outputs, f32: ddt, dx (batch, S, di), dA (di, ds), dB, dC (batch,
// S, ds), dD (di,), dh0 (batch, di, ds). All contiguous, each base
// 16-byte aligned; ds <= 16. Three launches on `stream` (the checkpoints,
// the backward, the partials' reduction); returns the first failing
// cudaError_t, or 0.
extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* xc, const void* A, const void* Bm,
    const void* Cm, const void* Dskip, const void* h0, const void* dy,
    void* ckpt, void* db_part, void* dc_part, void* da_part, void* dd_part,
    void* ddt, void* dx, void* dA, void* dB, void* dC, void* dD, void* dh0,
    int dtype, int batch, int S, int di, int ds, void* stream) {
  if (batch <= 0 || di <= 0 || S < 0 || ds <= 0 || ds > kMaxState ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(dt, xc, A, Bm, Cm, Dskip, h0, dy, ckpt, db_part,
                         dc_part, da_part, dd_part, ddt, dx, dA, dB, dC, dD,
                         dh0, batch, S, di, ds, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(dt, xc, A, Bm, Cm, Dskip, h0, dy, ckpt,
                                 db_part, dc_part, da_part, dd_part, ddt, dx,
                                 dA, dB, dC, dD, dh0, batch, S, di, ds, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
