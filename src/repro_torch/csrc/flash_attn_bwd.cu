// The backward of flash attention (FlashAttention-2's, deterministic) for
// the training form of the call: q, k, v of one sequence (Sq == Skv, query
// i and kv slot i both at position i), causal or not, with a sliding
// window, grouped-query heads, f32 or bf16 in and out, f32 arithmetic.
// Three kernels, each behind its own C entry
// (src/repro_torch/kernels/flash_attn/kernel.py:attention_bwd):
//
//   delta: D_i = rowsum(dO_i * O_i), f32, one warp a row;
//   dkdv:  one CTA per (kv block of 32 slots, kv head, batch). It loops
//          over the query blocks of every q head of the kv head's group
//          that see the block, so the group's sum stays in the CTA (no
//          atomics: a run is bit-reproducible). For each query block it
//          recomputes P = exp(S - lse) from the forward's saved
//          log-sum-exp, dP = dO V^T, dS = P (dP - D), and accumulates
//          dV += P^T dO and dK += dS^T (Q * scale) in registers;
//   dq:    one CTA per (query block, q head, batch); it loops over the
//          kv blocks the rows see: dQ += dS K, times the scale at the end.
//
// dkdv and dq come in two variants, picked by the wrapper from dtype,
// head width and alignment before any launch: simt (f32, and anything
// else) and tc (bf16 with d a multiple of 16 up to 128 and 16-byte
// aligned rows: the tensor cores).
//
// Replaces: the gradient of src/repro/models/layers.py:_chunk_attention,
// which the reference takes by XLA's autodiff (src/repro has no
// custom_vjp); the forward it differentiates is the TPU kernel
// src/repro/kernels/flash_attn/kernel.py:flash_attention, ported as
// csrc/flash_attn.cu, whose simt and tc variants write the row
// log-sum-exp (lse) this backward reads. Its plain version is
// src/repro_torch/kernels/flash_attn/ref.py:attention_bwd_plain.
//
// Masks: a kv slot t is visible to query i when (not causal or t <= i)
// and (no window or t > i - window), as in the forward (ref.py:_visible).
// Blocks that no pair of theirs can see are skipped by the loop bounds;
// inside a block each pair is tested.
//
// What bounds it on an H100: the products. The function needs 10 d
// operations a visible (query, slot) pair (S, dP, dV, dK, dQ at 2 d
// apiece), about 2.5 times the forward's 4 d; the two kernels recompute S
// and dP each, 14 d. In bf16 that is tensor-core work (989 TFLOP/s), in
// f32 CUDA-core work (67 TFLOP/s).
//
// simt: blocks of 32 rows on 8 warps. Each warp owns 4 rows of the block
// and holds their 4 x ceil(d / 32) accumulators a lane in registers; the
// block of the other side is staged in shared memory as f32 at a pitch of
// d + 1, so the 32 lanes that each take one row of it (the score phase)
// hit 32 banks, and the 32 lanes that stride over d in the accumulation
// read consecutive words. Scores and dP of a warp's 4 rows share each
// staged element the lane loads; p and dS reach the accumulation by
// shuffles from the lane that computed them.
//
// tc: blocks of 64 rows on 4 warps, each owning 16 (the forward's tc
// shape); the other side streams 32 rows a step through a 2-stage
// cp.async ring at a pitch padded by 16 bytes (conflict-free ldmatrix).
// All five products run on mma.sync m16n8k16 (bf16 in, f32 accumulate).
// In dkdv a warp's kv rows are the A operand, so S^T = K Q^T and dP^T = V
// dO^T come out with query rows as columns, and P^T and dS^T are already
// the A fragments of dV += P^T dO and dK += dS^T Q (the accumulator
// layout is the A layout); in dq the warp's Q and dO rows stay in
// registers as A fragments and dS is the A fragment of dQ += dS K. Like
// the forward, p and dS enter the value products as bf16 hi + lo (about
// 16 significant bits, 1.5x the minimal products), so the kernel keeps
// the f32 arithmetic's precision; exponentials are 2^x on the SFU of
// scores in log2 units. mma.sync is not the card's full rate (wgmma with
// TMA is).
//
// Built with -fmad=false like every source here; the products are written
// as fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlock = 32;                // rows of a block, either side
constexpr int kRows = kBlock / kWarps;    // rows a warp owns
constexpr unsigned kFull = 0xffffffffu;

// strides in elements, (batch, head, sequence), of the ten tensors
struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, S) contiguous
  float* delta;      // (B, Hq, S) contiguous
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int hq, hkv, s, d, causal, window;
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int t, int i, int causal,
                                        int window) {
  return (!causal || t <= i) && (window <= 0 || t > i - window);
}

__device__ __forceinline__ long long at(const Strides& st, int b, int h) {
  return b * st.b + h * st.h;
}

// rows [r0, r0 + 32) of a (S, d) matrix into shared memory at pitch d + 1,
// times `mul`; rows at or past S become zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int r0, int s, int d,
                                      float mul) {
  for (int e = threadIdx.x; e < kBlock * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    dst[r * (d + 1) + c] =
        r0 + r < s ? load(src, static_cast<long long>(r0 + r) * stride + c) *
                         mul
                   : 0.f;
  }
}

// D = rowsum(dO * O): a warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const Args a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  if (row >= a.s) return;
  const T* O = static_cast<const T*>(a.o) + at(a.so, b, h) + row * a.so.s;
  const T* dO =
      static_cast<const T*>(a.dout) + at(a.sdo, b, h) + row * a.sdo.s;
  float x = 0.f;
  for (int c = lane; c < a.d; c += 32) x = fmaf(load(dO, c), load(O, c), x);
  x = warp_sum(x);
  if (lane == 0) {
    a.delta[(static_cast<long long>(b) * a.hq + h) * a.s + row] = x;
  }
}

// kChunks = ceil(d / 32): the columns each lane holds of an accumulator row
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  const int P = d + 1;
  float* ks = smem;               // [32][P] this CTA's kv rows
  float* vs = ks + kBlock * P;    // [32][P]
  float* qs = vs + kBlock * P;    // [32][P] a query block, scaled
  float* dos = qs + kBlock * P;   // [32][P]
  float* lse_s = dos + kBlock * P;  // [32]
  float* dl_s = lse_s + kBlock;     // [32]

  const int k0 = blockIdx.x * kBlock;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.hq / a.hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRows;  // this warp's rows of the kv block

  stage(ks, static_cast<const T*>(a.k) + at(a.sk, b, hk), a.sk.s, k0, a.s, d,
        1.f);
  stage(vs, static_cast<const T*>(a.v) + at(a.sv, b, hk), a.sv.s, k0, a.s, d,
        1.f);

  // the query rows that see some slot of [k0, k1)
  const int k1 = min(k0 + kBlock, a.s);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.s, k1 - 1 + a.window) : a.s;

  float dk[kRows][kChunks], dv[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) dk[r][i] = dv[r][i] = 0.f;
  }

  for (int hg = 0; hg < G; ++hg) {
    const int h = hk * G + hg;
    const T* Q = static_cast<const T*>(a.q) + at(a.sq, b, h);
    const T* dO = static_cast<const T*>(a.dout) + at(a.sdo, b, h);
    const long long row_base = (static_cast<long long>(b) * a.hq + h) * a.s;
    for (int q0 = (q_lo / kBlock) * kBlock; q0 < q_hi; q0 += kBlock) {
      __syncthreads();  // the previous query block is consumed
      stage(qs, Q, a.sq.s, q0, a.s, d, a.scale);
      stage(dos, dO, a.sdo.s, q0, a.s, d, 1.f);
      if (threadIdx.x < kBlock) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < a.s ? a.lse[row_base + i] : 0.f;
        dl_s[threadIdx.x] = i < a.s ? a.delta[row_base + i] : 0.f;
      }
      __syncthreads();

      // lane = query row q0 + lane against this warp's kRows kv rows
      float s[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
      const float* qrow = qs + lane * P;
      const float* dorow = dos + lane * P;
      for (int c = 0; c < d; ++c) {
        const float qx = qrow[c];
        const float gx = dorow[c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r] = fmaf(qx, ks[(r0 + r) * P + c], s[r]);
          dp[r] = fmaf(gx, vs[(r0 + r) * P + c], dp[r]);
        }
      }
      const int i = q0 + lane;
      const float lse_i = lse_s[lane];
      const float d_i = dl_s[lane];
      float p[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int t = k0 + r0 + r;
        const bool ok = i < a.s && t < a.s && visible(t, i, a.causal,
                                                      a.window);
        p[r] = ok ? expf(s[r] - lse_i) : 0.f;
        ds[r] = p[r] * (dp[r] - d_i);
      }

      // dV += P^T dO, dK += dS^T (Q * scale): lanes stride over d
#pragma unroll 4
      for (int j = 0; j < kBlock; ++j) {
        float pj[kRows], dsj[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          pj[r] = __shfl_sync(kFull, p[r], j);
          dsj[r] = __shfl_sync(kFull, ds[r], j);
        }
        const float* qr = qs + j * P;
        const float* gr = dos + j * P;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const int c = lane + 32 * ch;
          if (c < d) {
            const float gx = gr[c];
            const float qx = qr[c];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              dv[r][ch] = fmaf(pj[r], gx, dv[r][ch]);
              dk[r][ch] = fmaf(dsj[r], qx, dk[r][ch]);
            }
          }
        }
      }
    }
  }

  T* dK = static_cast<T*>(a.dk) + at(a.sdk, b, hk);
  T* dV = static_cast<T*>(a.dv) + at(a.sdv, b, hk);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = k0 + r0 + r;
    if (t >= a.s) continue;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = lane + 32 * ch;
      if (c < d) {
        store(dK, t * a.sdk.s + c, dk[r][ch]);
        store(dV, t * a.sdv.s + c, dv[r][ch]);
      }
    }
  }
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  const int P = d + 1;
  float* qs = smem;               // [32][P] this CTA's query rows, scaled
  float* dos = qs + kBlock * P;   // [32][P]
  float* ks = dos + kBlock * P;   // [32][P] a kv block
  float* vs = ks + kBlock * P;    // [32][P]

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRows;

  stage(qs, static_cast<const T*>(a.q) + at(a.sq, b, h), a.sq.s, q0, a.s, d,
        a.scale);
  stage(dos, static_cast<const T*>(a.dout) + at(a.sdo, b, h), a.sdo.s, q0,
        a.s, d, 1.f);
  const long long row_base = (static_cast<long long>(b) * a.hq + h) * a.s;
  float lse_r[kRows], d_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + r0 + r;
    lse_r[r] = i < a.s ? a.lse[row_base + i] : 0.f;
    d_r[r] = i < a.s ? a.delta[row_base + i] : 0.f;
  }

  // the kv slots that some row of [q0, q1) sees
  const int q1 = min(q0 + kBlock, a.s);
  const int hi = a.causal ? q1 : a.s;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float dq[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) dq[r][i] = 0.f;
  }
  const T* K = static_cast<const T*>(a.k) + at(a.sk, b, hk);
  const T* V = static_cast<const T*>(a.v) + at(a.sv, b, hk);

  for (int t0 = (lo / kBlock) * kBlock; t0 < hi; t0 += kBlock) {
    __syncthreads();  // the previous kv block is consumed (q is staged)
    stage(ks, K, a.sk.s, t0, a.s, d, 1.f);
    stage(vs, V, a.sv.s, t0, a.s, d, 1.f);
    __syncthreads();

    // lane = kv slot t0 + lane against this warp's kRows query rows
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* krow = ks + lane * P;
    const float* vrow = vs + lane * P;
    for (int c = 0; c < d; ++c) {
      const float kx = krow[c];
      const float vx = vrow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = fmaf(qs[(r0 + r) * P + c], kx, s[r]);
        dp[r] = fmaf(dos[(r0 + r) * P + c], vx, dp[r]);
      }
    }
    const int t = t0 + lane;
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + r0 + r;
      const bool ok = i < a.s && t < a.s && visible(t, i, a.causal,
                                                    a.window);
      const float p = ok ? expf(s[r] - lse_r[r]) : 0.f;
      ds[r] = p * (dp[r] - d_r[r]);
    }

    // dQ += dS K: lanes stride over d
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float dsj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dsj[r] = __shfl_sync(kFull, ds[r], j);
      const float* kr = ks + j * P;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int c = lane + 32 * ch;
        if (c < d) {
          const float kx = kr[c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            dq[r][ch] = fmaf(dsj[r], kx, dq[r][ch]);
          }
        }
      }
    }
  }

  T* dQ = static_cast<T*>(a.dq) + at(a.sdq, b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + r0 + r;
    if (i >= a.s) continue;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = lane + 32 * ch;
      if (c < d) store(dQ, i * a.sdq.s + c, dq[r][ch] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// tc: the tensor-core variant (bf16, d % 16 == 0, d <= 128, rows 16-byte
// aligned), mma.sync m16n8k16 as the forward's tc variant uses it
// ---------------------------------------------------------------------------

namespace tcb {

using bf16 = __nv_bfloat16;
constexpr int kBlockM = 64;  // rows a CTA owns (kv rows in dkdv, q in dq)
constexpr int kTile = 32;    // rows of the other side a step
constexpr int kWarps = 4;    // each owns 16 of the CTA's rows
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 8;  // 16 bytes of padding: conflict-free ldmatrix phases
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16 of what hi left out
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// 2^x by the SFU (2 ulp; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + R) of a (rows, D) bf16 matrix with row stride
// `stride` into shared memory at pitch<D>(); rows at or past `nrows` zero
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g,
                                          long long stride, int row0,
                                          int nrows, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < (R * kChunks + kThreads - 1) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    if (e < R * kChunks) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 8;
      const bool ok = row0 + r < nrows;
      const bf16* src =
          ok ? g + static_cast<long long>(row0 + r) * stride + c : g;
      cp_async16(smem_u32(s + r * pitch<D>() + c), src, ok);
    }
  }
}

// this warp's 16 rows [row0, row0 + 16) of a [rows][pitch] tile as A
// fragments, one per 16 columns
template <int D>
__device__ __forceinline__ void a_frags(const bf16* s, int row0, int lane,
                                        uint32_t (&f)[D / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int row = row0 + (lane & 15);
    const int col = kk * 16 + (lane >> 4) * 8;
    ldsm_x4(smem_u32(s + row * pitch<D>() + col), f[kk][0], f[kk][1],
            f[kk][2], f[kk][3]);
  }
}

// acc[n][..] (16 x 32: rows of A, the tile's 32 rows) += A B^T with A the
// warp's fragments and B the tile [32][pitch] (its rows the n index)
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[4][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* tile, int lane) {
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      uint32_t b0, b1, b2, b3;
      const int row = nn * 16 + mr + 8 * (mi >> 1);
      const int col = kk * 16 + 8 * (mi & 1);
      ldsm_x4(smem_u32(tile + row * pitch<D>() + col), b0, b1, b2, b3);
      mma(acc[2 * nn], a[kk], b0, b1);
      mma(acc[2 * nn + 1], a[kk], b2, b3);
    }
  }
}

// out[n][..] (16 x D) += W T with W (16 x 32) the accumulator fragments
// w (hi + lo bf16 halves as A) and T the tile [32][pitch] (k index = its
// rows) through ldmatrix.trans
template <int D>
__device__ __forceinline__ void mma_wt(float (&out)[D / 8][4],
                                       const float (&w)[4][4],
                                       const bf16* tile, int lane) {
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t hi[4], lo[4];
    split(w[2 * kk][0], w[2 * kk][1], hi[0], lo[0]);
    split(w[2 * kk][2], w[2 * kk][3], hi[1], lo[1]);
    split(w[2 * kk + 1][0], w[2 * kk + 1][1], hi[2], lo[2]);
    split(w[2 * kk + 1][2], w[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b0, b1, b2, b3;
      const int row = kk * 16 + mr + 8 * (mi & 1);
      const int col = nn * 16 + 8 * (mi >> 1);
      ldsm_x4_t(smem_u32(tile + row * pitch<D>() + col), b0, b1, b2, b3);
      mma(out[2 * nn], hi, b0, b1);
      mma(out[2 * nn], lo, b0, b1);
      mma(out[2 * nn + 1], hi, b2, b3);
      mma(out[2 * nn + 1], lo, b2, b3);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * static_cast<size_t>(pitch<D>()) *
             (2 * kBlockM + 4 * kTile) +
         sizeof(float) * 4 * kTile;
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(bf16) * static_cast<size_t>(pitch<D>()) *
         (2 * kBlockM + 4 * kTile);
}

// dK, dV for 64 kv rows of one kv head: every query block of every q
// head of the group that sees them, 32 query rows a step through a
// 2-stage cp.async ring. The warp's 16 kv rows are the A side: S^T = K
// Q^T and dP^T = V dO^T land in accumulator fragments whose columns are
// query rows, so P^T and dS^T feed dV += P^T dO and dK += dS^T Q as A
// fragments without leaving registers.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char tcb_smem[];
  constexpr int P = pitch<D>();
  bf16* ks = reinterpret_cast<bf16*>(tcb_smem);  // [64][P]
  bf16* vs = ks + kBlockM * P;                   // [64][P]
  bf16* qs = vs + kBlockM * P;                   // [2][32][P]
  bf16* gs = qs + 2 * kTile * P;                 // [2][32][P] dO
  float* ls = reinterpret_cast<float*>(gs + 2 * kTile * P);  // [2][32] lse
  float* ds = ls + 2 * kTile;                                // [2][32] D

  const int k0 = blockIdx.x * kBlockM;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.hq / a.hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const float sl2 = a.scale * kLog2e;

  const bf16* K = static_cast<const bf16*>(a.k) + at(a.sk, b, hk);
  const bf16* V = static_cast<const bf16*>(a.v) + at(a.sv, b, hk);
  load_rows<D, kBlockM>(ks, K, a.sk.s, k0, a.s, tid);
  load_rows<D, kBlockM>(vs, V, a.sv.s, k0, a.s, tid);
  cp_commit();

  const int k1 = min(k0 + kBlockM, a.s);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.s, k1 - 1 + a.window) : a.s;
  const int t_begin = (q_lo / kTile) * kTile;
  const int n_tiles = q_hi > t_begin ? (q_hi - t_begin + kTile - 1) / kTile
                                     : 0;
  const int total = G * n_tiles;  // (head, query tile) steps

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;
  }
  const int kr0 = k0 + warp * 16 + g;  // this lane's kv rows kr0, kr0 + 8

  auto issue = [&](int it, int st) {
    const int h = hk * G + it / n_tiles;
    const int q0 = t_begin + (it % n_tiles) * kTile;
    const bf16* Q = static_cast<const bf16*>(a.q) + at(a.sq, b, h);
    const bf16* dO = static_cast<const bf16*>(a.dout) + at(a.sdo, b, h);
    load_rows<D, kTile>(qs + st * kTile * P, Q, a.sq.s, q0, a.s, tid);
    load_rows<D, kTile>(gs + st * kTile * P, dO, a.sdo.s, q0, a.s, tid);
    if (tid < kTile) {
      const long long rb = (static_cast<long long>(b) * a.hq + h) * a.s;
      const int i = q0 + tid;
      ls[st * kTile + tid] = i < a.s ? a.lse[rb + i] * kLog2e : 0.f;
      ds[st * kTile + tid] = i < a.s ? a.delta[rb + i] : 0.f;
    }
  };
  if (total > 0) issue(0, 0);
  cp_commit();

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    const int q0 = t_begin + (it % n_tiles) * kTile;
    if (it + 1 < total) issue(it + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* qt = qs + st * kTile * P;
    const bf16* gt = gs + st * kTile * P;

    float sT[4][4], pT[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sT[j][c] = pT[j][c] = 0.f;
    }
    {
      uint32_t kf[D / 16][4];
      a_frags<D>(ks, warp * 16, lane, kf);
      mma_abt<D>(sT, kf, qt, lane);  // S^T = K Q^T
    }
    {
      uint32_t vf[D / 16][4];
      a_frags<D>(vs, warp * 16, lane, vf);
      mma_abt<D>(pT, vf, gt, lane);  // dP^T = V dO^T (in pT for now)
    }
    // P^T and dS^T; column j's query row is q0 + 8 jn + 2 tig + (c & 1)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = 8 * jn + 2 * tig + (c & 1);
        const int i = q0 + qc;
        const int t = kr0 + (c >> 1) * 8;
        const bool ok = i < a.s && t < a.s &&
                        visible(t, i, a.causal, a.window);
        const float p = ok ? ex2(sT[jn][c] * sl2 - ls[st * kTile + qc])
                           : 0.f;
        const float dsv = p * (pT[jn][c] - ds[st * kTile + qc]);
        sT[jn][c] = p;
        pT[jn][c] = dsv;
      }
    }
    mma_wt<D>(dv, sT, gt, lane);  // dV += P^T dO
    mma_wt<D>(dk, pT, qt, lane);  // dK += dS^T Q
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_wait<0>();

  bf16* dK = static_cast<bf16*>(a.dk) + at(a.sdk, b, hk);
  bf16* dV = static_cast<bf16*>(a.dv) + at(a.sdv, b, hk);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (kr0 < a.s) {
      *reinterpret_cast<__nv_bfloat162*>(dK + kr0 * a.sdk.s + c) =
          __floats2bfloat162_rn(dk[n][0] * a.scale, dk[n][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dV + kr0 * a.sdv.s + c) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (kr0 + 8 < a.s) {
      *reinterpret_cast<__nv_bfloat162*>(dK + (kr0 + 8) * a.sdk.s + c) =
          __floats2bfloat162_rn(dk[n][2] * a.scale, dk[n][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dV + (kr0 + 8) * a.sdv.s + c) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

// dQ for 64 query rows of one q head: the kv blocks they see, 32 slots a
// step through a 2-stage ring. The warp's Q and dO rows stay in registers
// as A fragments; S = Q K^T and dP = dO V^T are the forward's product, dS
// feeds dQ += dS K as an A fragment.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char tcb_smem[];
  constexpr int P = pitch<D>();
  bf16* qs = reinterpret_cast<bf16*>(tcb_smem);  // [64][P]
  bf16* gs = qs + kBlockM * P;                   // [64][P] dO
  bf16* ks = gs + kBlockM * P;                   // [2][32][P]
  bf16* vs = ks + 2 * kTile * P;                 // [2][32][P]

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const float sl2 = a.scale * kLog2e;

  const bf16* Q = static_cast<const bf16*>(a.q) + at(a.sq, b, h);
  const bf16* dO = static_cast<const bf16*>(a.dout) + at(a.sdo, b, h);
  const bf16* K = static_cast<const bf16*>(a.k) + at(a.sk, b, hk);
  const bf16* V = static_cast<const bf16*>(a.v) + at(a.sv, b, hk);
  load_rows<D, kBlockM>(qs, Q, a.sq.s, q0, a.s, tid);
  load_rows<D, kBlockM>(gs, dO, a.sdo.s, q0, a.s, tid);

  const int q1 = min(q0 + kBlockM, a.s);
  const int hi = a.causal ? q1 : a.s;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = (lo / kTile) * kTile;
  const int n_tiles = hi > t_begin ? (hi - t_begin + kTile - 1) / kTile : 0;
  if (n_tiles > 0) {
    load_rows<D, kTile>(ks, K, a.sk.s, t_begin, a.s, tid);
    load_rows<D, kTile>(vs, V, a.sv.s, t_begin, a.s, tid);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  uint32_t qf[D / 16][4], gf[D / 16][4];
  a_frags<D>(qs, warp * 16, lane, qf);
  a_frags<D>(gs, warp * 16, lane, gf);
  const int r0 = q0 + warp * 16 + g;  // this lane's rows r0, r0 + 8
  const long long rb = (static_cast<long long>(b) * a.hq + h) * a.s;
  float lse2[2], dl[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = r0 + 8 * u;
    lse2[u] = i < a.s ? a.lse[rb + i] * kLog2e : 0.f;
    dl[u] = i < a.s ? a.delta[rb + i] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[n][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kTile;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_rows<D, kTile>(ks + (st ^ 1) * kTile * P, K, a.sk.s, t0 + kTile,
                          a.s, tid);
      load_rows<D, kTile>(vs + (st ^ 1) * kTile * P, V, a.sv.s, t0 + kTile,
                          a.s, tid);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* kt = ks + st * kTile * P;
    const bf16* vt = vs + st * kTile * P;

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = dp[j][c] = 0.f;
    }
    mma_abt<D>(sc, qf, kt, lane);  // S = Q K^T
    mma_abt<D>(dp, gf, vt, lane);  // dP = dO V^T
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = t0 + 8 * jn + 2 * tig + (c & 1);
        const int u = c >> 1;
        const int i = r0 + 8 * u;
        const bool ok = i < a.s && t < a.s &&
                        visible(t, i, a.causal, a.window);
        const float p = ok ? ex2(sc[jn][c] * sl2 - lse2[u]) : 0.f;
        sc[jn][c] = p * (dp[jn][c] - dl[u]);  // dS
      }
    }
    mma_wt<D>(dq, sc, kt, lane);  // dQ += dS K
    __syncthreads();  // this stage is consumed before it is refilled
  }

  bf16* dQ = static_cast<bf16*>(a.dq) + at(a.sdq, b, h);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (r0 < a.s) {
      *reinterpret_cast<__nv_bfloat162*>(dQ + r0 * a.sdq.s + c) =
          __floats2bfloat162_rn(dq[n][0] * a.scale, dq[n][1] * a.scale);
    }
    if (r0 + 8 < a.s) {
      *reinterpret_cast<__nv_bfloat162*>(dQ + (r0 + 8) * a.sdq.s + c) =
          __floats2bfloat162_rn(dq[n][2] * a.scale, dq[n][3] * a.scale);
    }
  }
}

template <int D>
int launch_as(int which, const Args& a, int batch, cudaStream_t s) {
  const int nb = (a.s + kBlockM - 1) / kBlockM;
  if (which == 1) {
    auto kernel = flash_bwd_dkdv_tc_kernel<D>;
    constexpr size_t smem = dkdv_smem<D>();
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(nb, a.hkv, batch), kThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = flash_bwd_dq_tc_kernel<D>;
  constexpr size_t smem = dq_smem<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(nb, a.hq, batch), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(int which, const Args& a, int batch, cudaStream_t s) {
  switch (a.d) {
    case 16: return launch_as<16>(which, a, batch, s);
    case 32: return launch_as<32>(which, a, batch, s);
    case 48: return launch_as<48>(which, a, batch, s);
    case 64: return launch_as<64>(which, a, batch, s);
    case 80: return launch_as<80>(which, a, batch, s);
    case 96: return launch_as<96>(which, a, batch, s);
    case 112: return launch_as<112>(which, a, batch, s);
    case 128: return launch_as<128>(which, a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tcb

size_t block_smem(const Args& a) {
  return sizeof(float) * (4 * static_cast<size_t>(kBlock) * (a.d + 1) +
                          2 * kBlock);
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Args& a,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kChunks>
int launch_blocks(int which, const Args& a, int batch, cudaStream_t s) {
  const int nb = (a.s + kBlock - 1) / kBlock;
  if (which == 1) {
    return launch(flash_bwd_dkdv_kernel<T, kChunks>, dim3(nb, a.hkv, batch),
                  block_smem(a), a, s);
  }
  return launch(flash_bwd_dq_kernel<T, kChunks>, dim3(nb, a.hq, batch),
                block_smem(a), a, s);
}

template <typename T>
int launch_typed(int which, const Args& a, int batch, cudaStream_t s) {
  if (which == 0) {
    const dim3 grid((a.s + kWarps - 1) / kWarps, a.hq, batch);
    flash_bwd_delta_kernel<T><<<grid, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.d <= 32) return launch_blocks<T, 1>(which, a, batch, s);
  if (a.d <= 64) return launch_blocks<T, 2>(which, a, batch, s);
  if (a.d <= 96) return launch_blocks<T, 3>(which, a, batch, s);
  return launch_blocks<T, 4>(which, a, batch, s);
}

int launch_bwd(int which, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const void* lse, void* delta,
               void* dq, void* dk, void* dv, const long long* strides,
               int dtype, int batch, int hq, int hkv, int s, int d,
               int causal, int window, float scale, int tc, void* stream) {
  if (batch <= 0 || hq <= 0 || s <= 0) return 0;
  if (d <= 0 || d > 128 || hkv <= 0 || hq % hkv != 0 || strides == nullptr ||
      lse == nullptr || delta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Strides* st[] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i) {
    st[i]->b = strides[3 * i];
    st[i]->h = strides[3 * i + 1];
    st[i]->s = strides[3 * i + 2];
  }
  a.hq = hq;
  a.hkv = hkv;
  a.s = s;
  a.d = d;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (which != 0) return tcb::launch(which, a, batch, cs);
  }
  if (dtype == 0) return launch_typed<float>(which, a, batch, cs);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(which, a, batch, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dq: (B, Hq, S, d); k, v, dk, dv: (B, Hkv, S, d); o, dout: (B, Hq, S,
// d); each with its own (batch, head, sequence) strides in elements, 24 of
// them in `strides` in the order q, k, v, o, dout, dq, dk, dv, and a
// contiguous last dimension. lse, delta: (B, Hq, S) f32 contiguous. dtype
// 0 = f32, 1 = bf16, for all of q, k, v, o, dout, dq, dk, dv. window <= 0
// means none. d <= 128, Hq % Hkv == 0. tc = 1 takes the tensor-core
// variant of dkdv and dq (bf16, d a multiple of 16, the five inputs' base
// pointers and (batch, head, sequence) strides 16-byte aligned, as
// cp.async needs; the wrapper checks), tc = 0 the SIMT one (delta is the
// same for both). Each entry launches one kernel on `stream` and returns
// the launch's cudaError_t (0 on success); delta must run before the
// other two, which read it.

// delta = rowsum(dout * o)
extern "C" int flash_attn_bwd_delta_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int dtype, int batch, int hq,
    int hkv, int s, int d, int causal, int window, float scale, int tc,
    void* stream) {
  return launch_bwd(0, q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                    dtype, batch, hq, hkv, s, d, causal, window, scale, tc,
                    stream);
}

// dk and dv
extern "C" int flash_attn_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int dtype, int batch, int hq,
    int hkv, int s, int d, int causal, int window, float scale, int tc,
    void* stream) {
  return launch_bwd(1, q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                    dtype, batch, hq, hkv, s, d, causal, window, scale, tc,
                    stream);
}

// dq
extern "C" int flash_attn_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int dtype, int batch, int hq,
    int hkv, int s, int d, int causal, int window, float scale, int tc,
    void* stream) {
  return launch_bwd(2, q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                    dtype, batch, hq, hkv, s, d, causal, window, scale, tc,
                    stream);
}
