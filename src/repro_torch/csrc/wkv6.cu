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
// reference's step one token at a time; kernels/wkv/ref.py:
// wkv6_split_plain mirrors this kernel's decomposition.
//
// What bounds it on an H100: FP32 instruction slots, then latency. At
// rwkv6-3b's prefill (8 x 2,048 tokens, 40 heads of 64) there are 2.68e9
// (token, key, value) triples a layer. With the bonus factored out,
// out[v] = sum_k r[k] s[k][v] + v[v] sum_k r[k] u[k] k[k], a triple is
// three instructions: an FMA into the output, the product k v and the FMA
// s = w s + k v. That is 8.05e9 FP32 instructions, ~0.24 ms at 128 lanes
// a clock on 132 SMs at 1.98 GHz; the bytes (r, k, v in bf16, w and y in
// f32) take ~0.18 ms at 3.35 TB/s. The design:
//  - A CTA takes a (batch, head) and 32 of its hd state columns: 640 CTAs
//    at rwkv6-3b's shape, 4.85 an SM, all resident at 5 an SM (<= 102
//    registers). Each of its 4 warps (2 at hd 32) holds two key groups of
//    8 keys (lanes 0-15, 16-31); a thread holds a register tile of 8 keys
//    by 2 columns, like a GEMM micro-tile.
//  - A token's step is 48 FP32 instructions a thread (the triples' three)
//    and 9 shared-memory loads; the loop is 64 instructions a token. Its
//    partial of out[v] (r_k s_kv in key order by FMAs, the first a
//    product) meets the other key group's by one shuffle (lane ^ 16, which
//    keeps register 0: a lane's column j sits in register j ^ (lane / 16),
//    so no select); the 4 warps' sums go to shared memory and a pass after
//    the stage adds them ((W0 + W2) + (W1 + W3)) and v[v] times the bonus
//    (an FMA), writing 128 consecutive bytes a (token, CTA).
//  - Tokens come in stages of 16: cp.async copies stage n + 1 (r, k, v in
//    the activation type, w straight into its permuted f32 layout) while
//    stage n runs. A pass casts stage n's r and k (permuted: the key groups'
//    float4 chunks interleave, so a warp's loads of a chunk are 32
//    consecutive bytes) and v to f32 and forms the bonus: (r u) k over a
//    chunk of 4 keys by FMAs, the chunks by a butterfly.
//  - The products are written as __fmaf_rn: build.py compiles every source
//    with -fmad=false, which the kNN kernels' bit-equality needs; this
//    kernel is held to its plain version by a tolerance (2e-5 of the
//    largest value), not bit for bit.
//  - Decode (S = 1) takes wkv6_kernel_decode in the same launch: a CTA of
//    hd threads a (batch, head), thread j holding column j (a warp reads
//    128 consecutive bytes of a state row), no staging, the sums in the
//    staged kernel's order, so a decode step gives a prefill's bits.
// What the card shows (chip_smoke's wkv6 row): the loop runs at about
// half the SMSPs' instruction rate. A lone warp takes several times its
// 64 instruction slots a token (the row's grid sweep: a quarter of the
// heads takes far more than a quarter of the time), and 5 warps an SMSP
// do not cover it.
// A chunked form on the tensor cores is not the route: at hd 64 it does
// as many operations, needs 3xTF32 or bf16 hi + lo to stay inside 2e-5,
// and RWKV6's per-channel decays overflow exp(-cumsum) within a chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTokens = 16;   // tokens a stage
constexpr int kTK = 8;        // keys a thread
constexpr int kTV = 2;        // values a thread
constexpr int kVB = 32;       // values (state columns) a CTA

template <int HD>
struct Shape {
  static constexpr int KG = HD / kTK;     // key groups of 8 keys
  static constexpr int NW = KG / 2;       // warps: two key groups each
  static constexpr int kThreads = 32 * NW;  // 128 at hd 64, 64 at hd 32
  static constexpr int NVB = HD / kVB;    // CTAs a head
};

// the position of key `key` in a staged row of r, k or w: chunk c (keys
// 4c .. 4c + 3 of a group) of key group g sits at float4 c * KG + g
template <int HD>
__host__ __device__ constexpr int perm(int key) {
  return ((key % kTK) / 4 * Shape<HD>::KG + key / kTK) * 4 + key % 4;
}

// how a staged element of type T is stored: bf16 as its bits
template <typename T>
struct RawOf {
  using type = float;
};
template <>
struct RawOf<__nv_bfloat16> {
  using type = unsigned short;
};

template <typename T, int HD>
struct __align__(16) Smem {
  using Raw = typename RawOf<T>::type;
  Raw raw_r[2][kTokens][HD], raw_k[2][kTokens][HD], raw_v[2][kTokens][kVB];
  float w[2][kTokens][HD];                      // permuted
  float r[kTokens][HD], k[kTokens][HD];         // permuted, f32
  float v[kTokens][kVB];                        // the CTA's columns, f32
  float bonus[kTokens];                         // sum_k r u k
  float u[HD];
  float part[kTokens][Shape<HD>::NW][kVB];      // the warps' partials of y
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
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

// the sum over N lanes of a butterfly, from the highest lane bit down:
// ((P0 + P4) + (P2 + P6)) + ((P1 + P5) + (P3 + P7)) at N = 8
template <int N>
__device__ __forceinline__ float group_sum(float p) {
#pragma unroll
  for (int m = N / 2; m >= 1; m /= 2) p += __shfl_xor_sync(0xffffffffu, p, m);
  return p;
}

// the same sum of N values held in order (the butterfly's value: every
// lane ends with it, float addition being commutative)
template <int N>
__device__ __forceinline__ float tree_sum(const float* c) {
  float a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = c[i];
#pragma unroll
  for (int m = N / 2; m >= 1; m /= 2) {
#pragma unroll
    for (int i = 0; i < m; ++i) a[i] = a[i] + a[i + m];
  }
  return a[0];
}

// copy tokens [t0, t0 + n) of (b, h) into stage buffer `buf`; `row` is
// the element offset of (b, t0, h, 0), `pitch` = H * HD, `vb` the CTA's
// first column
template <typename T, int HD>
__device__ __forceinline__ void stage(Smem<T, HD>& sm, int buf,
                                      const T* r, const T* k, const T* v,
                                      const float* w, long long row,
                                      long long pitch, int vb, int n) {
  constexpr int kThreads = Shape<HD>::kThreads;
  constexpr int CT = 16 / sizeof(T);   // elements a 16-byte chunk
  constexpr int RC = HD / CT, VC = kVB / CT, WC = HD / 4;
  for (int i = threadIdx.x; i < n * RC; i += kThreads) {
    const int t = i / RC, c = (i % RC) * CT;
    const long long off = row + t * pitch + c;
    cp_async16(&sm.raw_r[buf][t][c], r + off);
    cp_async16(&sm.raw_k[buf][t][c], k + off);
  }
  for (int i = threadIdx.x; i < n * VC; i += kThreads) {
    const int t = i / VC, c = (i % VC) * CT;
    cp_async16(&sm.raw_v[buf][t][c], v + row + t * pitch + vb + c);
  }
  for (int i = threadIdx.x; i < n * WC; i += kThreads) {
    const int t = i / WC, c = (i % WC) * 4;
    cp_async16(&sm.w[buf][t][perm<HD>(c)], w + row + t * pitch + c);
  }
}

// stage `buf`'s r and k to f32 (permuted), v's columns to f32, and each
// token's bonus sum_k (r_k u_k) k_k: a chunk of 4 keys a thread, by FMAs
// in key order, then the token's HD / 4 chunks by a butterfly over their
// lanes (highest bit first)
template <typename T, int HD>
__device__ __forceinline__ void convert(Smem<T, HD>& sm, int buf, int n) {
  constexpr int kThreads = Shape<HD>::kThreads, C4 = HD / 4;
  static_assert(kTokens * C4 % kThreads == 0, "a uniform trip count");
  for (int i = threadIdx.x; i < kTokens * C4; i += kThreads) {
    const int t = i / C4, c = (i % C4) * 4;
    float part = 0.f;
    if (t < n) {
      const int p = perm<HD>(c);
      const auto* rr = &sm.raw_r[buf][t][c];
      const auto* kk = &sm.raw_k[buf][t][c];
      const float4 a = make_float4(to_f32(rr[0]), to_f32(rr[1]),
                                   to_f32(rr[2]), to_f32(rr[3]));
      const float4 bb = make_float4(to_f32(kk[0]), to_f32(kk[1]),
                                    to_f32(kk[2]), to_f32(kk[3]));
      *reinterpret_cast<float4*>(&sm.r[t][p]) = a;
      *reinterpret_cast<float4*>(&sm.k[t][p]) = bb;
      const float4 uu = *reinterpret_cast<const float4*>(&sm.u[c]);
      part = __fmaf_rn(a.x * uu.x, bb.x, part);
      part = __fmaf_rn(a.y * uu.y, bb.y, part);
      part = __fmaf_rn(a.z * uu.z, bb.z, part);
      part = __fmaf_rn(a.w * uu.w, bb.w, part);
    }
    part = group_sum<C4>(part);
    if (t < n && c == 0) sm.bonus[t] = part;
  }
  for (int i = threadIdx.x; i < n * kVB; i += kThreads) {
    sm.v[i / kVB][i % kVB] = to_f32(sm.raw_v[buf][i / kVB][i % kVB]);
  }
}

// one thread's operands of a token: r, k, w of its 8 keys, v of its two
// columns (register j: column v0 + (j ^ hi))
struct Ops {
  float r[kTK], k[kTK], w[kTK], v[kTV];
};

// a token's step on the thread's tile: its keys' share of out[v] for its
// two columns (r_k s_kv in key order, by FMAs; the first a product) and
// the state update s = fma(w, s, k v)
__device__ __forceinline__ void step(float (&s)[kTK][kTV], const Ops& o,
                                     float (&acc)[kTV]) {
#pragma unroll
  for (int j = 0; j < kTV; ++j) acc[j] = o.r[0] * s[0][j];
#pragma unroll
  for (int q = 1; q < kTK; ++q) {
#pragma unroll
    for (int j = 0; j < kTV; ++j) acc[j] = __fmaf_rn(o.r[q], s[q][j], acc[j]);
  }
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
#pragma unroll
    for (int j = 0; j < kTV; ++j) {
      s[q][j] = __fmaf_rn(o.w[q], s[q][j], o.k[q] * o.v[j]);
    }
  }
}

__device__ __forceinline__ void put4(float* d, const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  d[0] = a.x;
  d[1] = a.y;
  d[2] = a.z;
  d[3] = a.w;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// y of a stage's n tokens from the warps' partials (summed (W0 + W2) +
// (W1 + W3) at hd 64), plus v times the bonus; a CTA's 32 columns of a
// token are 128 consecutive bytes
template <typename T, int HD>
__device__ __forceinline__ void write_y(const Smem<T, HD>& sm, float* y,
                                        long long row, long long pitch,
                                        int n) {
  constexpr int NW = Shape<HD>::NW;
  for (int i = threadIdx.x; i < n * kVB; i += Shape<HD>::kThreads) {
    const int t = i / kVB, c = i % kVB;
    float p[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) p[w] = sm.part[t][w][c];
    y[row + t * pitch + c] = __fmaf_rn(sm.v[t][c], sm.bonus[t],
                                       tree_sum<NW>(p));
  }
}

// decode (S = 1): one token, no staging. A CTA of HD threads a (batch,
// head), thread j holding state column j (a warp
// reads 128 consecutive bytes of a state row). The sums run in the staged
// kernel's order, so a decode step gives a prefill's bits: a key group's
// partial r_k s_kv by FMAs in key order, the pairs of groups, their tree;
// the bonus by chunks of 4 keys and their tree; y = fma(v, bonus, sum).
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel_decode(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* s0,
                   float* __restrict__ y, float* sout, int H) {
  constexpr int KG = Shape<HD>::KG, NW = Shape<HD>::NW;
  __shared__ __align__(16) float sr[HD], sk[HD], sw[HD], su[HD];
  __shared__ float chunk[HD / 4];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long long head = static_cast<long long>(b) * H + h;
  const long long row = head * HD;   // (b, 0, h, 0) of a one-token input
  sr[j] = load1(r + row + j);
  sk[j] = load1(k + row + j);
  sw[j] = w[row + j];
  su[j] = u[h * HD + j];
  const float vj = load1(v + row + j);
  float s[HD];
#pragma unroll
  for (int q = 0; q < HD; ++q) s[q] = s0[(head * HD + q) * HD + j];
  __syncthreads();
  if (j < HD / 4) {
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p = __fmaf_rn(sr[4 * j + e] * su[4 * j + e], sk[4 * j + e], p);
    }
    chunk[j] = p;
  }
  float pair[NW];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    float p = sr[g * kTK] * s[g * kTK];
#pragma unroll
    for (int q = g * kTK + 1; q < (g + 1) * kTK; ++q) {
      p = __fmaf_rn(sr[q], s[q], p);
    }
    pair[g / 2] = g % 2 ? pair[g / 2] + p : p;
  }
  __syncthreads();
  y[row + j] = __fmaf_rn(vj, tree_sum<HD / 4>(chunk), tree_sum<NW>(pair));
#pragma unroll
  for (int q = 0; q < HD; ++q) {
    sout[(head * HD + q) * HD + j] = __fmaf_rn(sw[q], s[q], sk[q] * vj);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads, 5)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* sout, int S, int H) {
  using Sh = Shape<HD>;
  constexpr int kThreads = Sh::kThreads;
  __shared__ Smem<T, HD> sm;
  const int h = blockIdx.x / Sh::NVB, vb = (blockIdx.x % Sh::NVB) * kVB;
  const int b = blockIdx.y;
  // warp wp holds key groups 2 wp (lanes 0-15) and 2 wp + 1 (lanes 16-31);
  // lane l's columns are 2 (l % 16) and + 1, register j holding column v0
  // + (j ^ hi): after the exchange with lane l ^ 16 it keeps register 0
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hi = lane >> 4;
  const int kg = 2 * wp + hi, k0 = kg * kTK, v0 = 2 * (lane & 15);
  const long long head = static_cast<long long>(b) * H + h;
  const long long pitch = static_cast<long long>(H) * HD;
  const long long row0 = static_cast<long long>(b) * S * pitch +
                         static_cast<long long>(h) * HD;

  float s[kTK][kTV];
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    const float2 a = *reinterpret_cast<const float2*>(
        s0 + (head * HD + k0 + q) * HD + vb + v0);
    s[q][0] = hi ? a.y : a.x;
    s[q][1] = hi ? a.x : a.y;
  }
  for (int i = threadIdx.x; i < HD; i += kThreads) sm.u[i] = u[h * HD + i];
  if (S > 0) stage(sm, 0, r, k, v, w, row0, pitch, vb, min(kTokens, S));
  cp_async_commit();
  for (int t0 = 0, buf = 0; t0 < S; t0 += kTokens, buf ^= 1) {
    const int n = min(kTokens, S - t0);
    cp_async_wait_all();
    __syncthreads();   // stage t0 landed; the last stage is written out
    if (t0 + kTokens < S) {
      stage(sm, buf ^ 1, r, k, v, w, row0 + (t0 + kTokens) * pitch, pitch,
            vb, min(kTokens, S - t0 - kTokens));
    }
    cp_async_commit();
    convert(sm, buf, n);
    __syncthreads();

    const float* pr = &sm.r[0][kg * 4];
    const float* pk = &sm.k[0][kg * 4];
    const float* pw = &sm.w[buf][0][kg * 4];
    const float* pv = &sm.v[0][v0];
    float* pp = &sm.part[0][wp][v0 + hi];
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      Ops o;
#pragma unroll
      for (int c = 0; c < kTK / 4; ++c) {   // a key group's chunk c
        put4(o.r + 4 * c, pr + c * Sh::KG * 4);
        put4(o.k + 4 * c, pk + c * Sh::KG * 4);
        put4(o.w + 4 * c, pw + c * Sh::KG * 4);
      }
      o.v[0] = pv[hi];
      o.v[1] = pv[hi ^ 1];
      float acc[kTV];
      step(s, o, acc);
      *pp = acc[0] + __shfl_xor_sync(0xffffffffu, acc[1], 16);
      pr += HD; pk += HD; pw += HD; pv += kVB;
      pp += Sh::NW * kVB;
    }
    __syncthreads();
    write_y(sm, y, row0 + static_cast<long long>(t0) * pitch + vb, pitch,
            n);
  }
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    *reinterpret_cast<float2*>(sout + (head * HD + k0 + q) * HD + vb + v0) =
        hi ? make_float2(s[q][1], s[q][0]) : make_float2(s[q][0], s[q][1]);
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sout, int batch,
           int S, int H, cudaStream_t st) {
  using Sh = Shape<HD>;
  if (S == 1) {
    wkv6_kernel_decode<T, HD><<<dim3(H, batch), HD, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(y), static_cast<float*>(sout), H);
    return static_cast<int>(cudaGetLastError());
  }
  wkv6_kernel<T, HD><<<dim3(H * Sh::NVB, batch), Sh::kThreads, 0, st>>>(
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
// may be s0 itself (each thread reads and writes only its own tile). All
// contiguous, each base 16-byte aligned (cp.async; the wrapper sees to
// it); hd is 32 or 64. Launches on `stream` and returns the launch's
// cudaError_t.
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
