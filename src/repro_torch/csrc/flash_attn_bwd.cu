// The backward of flash attention (FlashAttention-2's, deterministic) for
// the training forms of the call: self attention, q, k, v of one sequence
// (Sq == Skv, query i and kv slot i both at position i), causal or not,
// with a sliding window; and cross attention, Sq queries over the Skv slots
// of another sequence (any Sq and Skv, non-causal, no window: every query
// sees every slot). Grouped-query heads, f32 or bf16 in and out, f32
// arithmetic.
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
// Lengths: q, o, dO, dq, lse and D have Sq rows, k, v, dk and dv Skv.
// Masks: a kv slot t < Skv is visible to query i < Sq when (not causal or
// t <= i) and (no window or t > i - window), as in the forward
// (ref.py:_visible; causal and window come only with Sq == Skv). Blocks
// that no pair of theirs can see are skipped by the loop bounds; inside a
// block each pair is tested.
//
// What bounds it on an H100: the products. The function needs 10 d
// operations a visible (query, slot) pair (S, dP, dV, dK, dQ at 2 d
// apiece), about 2.5 times the forward's 4 d; simt's two kernels
// recompute S and dP each, 14 d, tc's 20 d (below). In bf16 that is
// tensor-core work (989 TFLOP/s), in f32 CUDA-core work (67 TFLOP/s).
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
// tc (redesigned for Hopper; it replaced a first card version on
// mma.sync m16n8k16 fed by cp.async, 64 rows a CTA on 4 warps and 32
// rows of the other side a step, with a CTA barrier every step, at 3.1x
// the library's time). A CTA is two consumer warpgroups and a producer
// warpgroup of which one warp works. Its lane 0 brings 64-row tiles with TMA
// (cp.async.bulk.tensor, 128-byte swizzle, 64 columns a box, zero fill
// past the sequence and past d) into a ring of kStages stages on
// mbarriers (full: the tile landed; empty: both warpgroups are done with
// it), so the next tiles are in flight while the consumers compute; the
// consumers take the registers the producer gives up (setmaxnreg). All
// products are wgmma m64nNk16 (bf16 in, f32 accumulate):
//
//   dkdv: a CTA owns 128 kv rows of one kv head (64 a warpgroup), K and V
//         resident in shared memory; the ring brings each q head's (of
//         the group, in order: no atomics) query tiles of 64 rows, with
//         their dO, lse and D. S^T = K Q^T and dP^T = V dO^T with both
//         operands in shared memory (K-major); P^T and dS^T are built in
//         the accumulator registers, which are the register A operand's
//         layout, and feed dV += P^T dO and dK += dS^T Q with B the same
//         Q and dO tiles read MN-major (the transposed order bf16 allows);
//   dq:   a CTA owns 128 query rows of one q head (Q and dO resident);
//         the ring brings the K and V tiles the rows see. S = Q K^T, dP =
//         dO V^T, and dQ += dS K with K read MN-major; the scale at the
//         end. dq stays apart from dkdv: no atomics, so a run is
//         bit-reproducible.
//
// Widths: d a multiple of 16 up to 128. A row of a tile is 64 or 128
// columns (DP): S and dP run d / 16 steps of depth 16, the value
// products N = DP (TMA fills the columns past d with zeros; they are
// never stored). Masks: a tile whose pairs are all visible skips the
// per-pair test; a tile that crosses the causal diagonal, the window's
// edge or the sequence's end tests each pair; a warpgroup skips a tile
// none of its pairs sees. Like the forward, p and dS enter the value
// products as bf16 hi + lo (about 16 significant bits): a single bf16
// misses the bar by more than 10x (tests/test_torch_flash_attn_bwd.py),
// so the kernels do 20 d operations a visible pair against the
// function's 10 d (S and dP recomputed by dq, the value products
// doubled). Exponentials are 2^x on the SFU of scores in log2 units. The
// CPU mirror of this arithmetic is ref.py:attention_bwd_tc_plain.
//
// Built with -fmad=false like every source here; the products are written
// as fmaf.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <atomic>
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
  const float* lse;  // (B, Hq, Sq) contiguous
  float* delta;      // (B, Hq, Sq) contiguous
  void* dq;
  void* dk;
  void* dv;
  Strides q_st, k_st, v_st, o_st, do_st, dq_st, dk_st, dv_st;
  int hq, hkv, sq, skv, d, causal, window;
  float scale;
  unsigned perm_q, perm_k, perm_v, perm_g;  // tc's tensor maps' dimensions
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
  if (row >= a.sq) return;
  const T* O = static_cast<const T*>(a.o) + at(a.o_st, b, h) + row * a.o_st.s;
  const T* dO =
      static_cast<const T*>(a.dout) + at(a.do_st, b, h) + row * a.do_st.s;
  float x = 0.f;
  for (int c = lane; c < a.d; c += 32) x = fmaf(load(dO, c), load(O, c), x);
  x = warp_sum(x);
  if (lane == 0) {
    a.delta[(static_cast<long long>(b) * a.hq + h) * a.sq + row] = x;
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

  stage(ks, static_cast<const T*>(a.k) + at(a.k_st, b, hk), a.k_st.s, k0,
        a.skv, d, 1.f);
  stage(vs, static_cast<const T*>(a.v) + at(a.v_st, b, hk), a.v_st.s, k0,
        a.skv, d, 1.f);

  // the query rows that see some slot of [k0, k1)
  const int k1 = min(k0 + kBlock, a.skv);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.sq, k1 - 1 + a.window) : a.sq;

  float dk[kRows][kChunks], dv[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) dk[r][i] = dv[r][i] = 0.f;
  }

  for (int hg = 0; hg < G; ++hg) {
    const int h = hk * G + hg;
    const T* Q = static_cast<const T*>(a.q) + at(a.q_st, b, h);
    const T* dO = static_cast<const T*>(a.dout) + at(a.do_st, b, h);
    const long long row_base = (static_cast<long long>(b) * a.hq + h) * a.sq;
    for (int q0 = (q_lo / kBlock) * kBlock; q0 < q_hi; q0 += kBlock) {
      __syncthreads();  // the previous query block is consumed
      stage(qs, Q, a.q_st.s, q0, a.sq, d, a.scale);
      stage(dos, dO, a.do_st.s, q0, a.sq, d, 1.f);
      if (threadIdx.x < kBlock) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < a.sq ? a.lse[row_base + i] : 0.f;
        dl_s[threadIdx.x] = i < a.sq ? a.delta[row_base + i] : 0.f;
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
        const bool ok = i < a.sq && t < a.skv && visible(t, i, a.causal,
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

  T* dK = static_cast<T*>(a.dk) + at(a.dk_st, b, hk);
  T* dV = static_cast<T*>(a.dv) + at(a.dv_st, b, hk);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = k0 + r0 + r;
    if (t >= a.skv) continue;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = lane + 32 * ch;
      if (c < d) {
        store(dK, t * a.dk_st.s + c, dk[r][ch]);
        store(dV, t * a.dv_st.s + c, dv[r][ch]);
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

  stage(qs, static_cast<const T*>(a.q) + at(a.q_st, b, h), a.q_st.s, q0,
        a.sq, d, a.scale);
  stage(dos, static_cast<const T*>(a.dout) + at(a.do_st, b, h), a.do_st.s, q0,
        a.sq, d, 1.f);
  const long long row_base = (static_cast<long long>(b) * a.hq + h) * a.sq;
  float lse_r[kRows], d_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + r0 + r;
    lse_r[r] = i < a.sq ? a.lse[row_base + i] : 0.f;
    d_r[r] = i < a.sq ? a.delta[row_base + i] : 0.f;
  }

  // the kv slots that some row of [q0, q1) sees
  const int q1 = min(q0 + kBlock, a.sq);
  const int hi = a.causal ? q1 : a.skv;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float dq[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) dq[r][i] = 0.f;
  }
  const T* K = static_cast<const T*>(a.k) + at(a.k_st, b, hk);
  const T* V = static_cast<const T*>(a.v) + at(a.v_st, b, hk);

  for (int t0 = (lo / kBlock) * kBlock; t0 < hi; t0 += kBlock) {
    __syncthreads();  // the previous kv block is consumed (q is staged)
    stage(ks, K, a.k_st.s, t0, a.skv, d, 1.f);
    stage(vs, V, a.v_st.s, t0, a.skv, d, 1.f);
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
      const bool ok = i < a.sq && t < a.skv && visible(t, i, a.causal,
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

  T* dQ = static_cast<T*>(a.dq) + at(a.dq_st, b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + r0 + r;
    if (i >= a.sq) continue;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = lane + 32 * ch;
      if (c < d) store(dQ, i * a.dq_st.s + c, dq[r][ch] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// tc: Hopper's tensor cores (bf16, d % 16 == 0, d <= 128, rows 16-byte
// aligned): wgmma on tiles that TMA brings into a shared-memory ring
// ---------------------------------------------------------------------------

namespace tcb {

using bf16 = __nv_bfloat16;
constexpr int kTileRows = 64;   // rows of a tile: a warpgroup's, a stage's
constexpr int kAtom = 64;       // columns of a 128-byte swizzle atom
constexpr int kAtomBytes = kTileRows * kAtom * 2;  // one TMA box, 8 KB
constexpr int kConsumers = 2;   // warpgroups that compute
constexpr int kBlockRows = kConsumers * kTileRows;  // a CTA's own rows
// + the producer warpgroup (setmaxnreg moves registers between whole
// warpgroups), whose first warp issues the loads
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStages = 3;
// registers a thread at launch (__launch_bounds__(kThreads, 1): 65,536 /
// 384, in steps of 8), the producer's after it gives some up, the
// consumers' after they take them: (240 - 168) x 256 = (168 - 24) x 128
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert((kConsumerRegs - kLaunchRegs) * kConsumers <=
                  kLaunchRegs - kProducerRegs,
              "setmaxnreg: the consumers take more than the producer frees");
constexpr float kLog2e = 1.4426950408889634f;
// a barrier wait that has not seen its phase after this many polls
// traps (a launch error) rather than hangs the card
constexpr long long kSpinLimit = 1ll << 26;

// the four inputs TMA reads, each (d, then its sequence, head and batch
// dimensions in the order of their strides)
struct Maps {
  CUtensorMap q, k, v, g;  // g: dO
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive, and add `bytes` to the transfers the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > kSpinLimit) __trap();
  }
}

// one box (64 columns from `col`, 64 rows from `row`) of `map` into
// shared memory at `dst`, counted on `bar`; `perm` places (row, head,
// batch) in the map's dimensions 1..3 (2 bits each: 0 row, 1 head, 2
// batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch, unsigned perm) {
  int c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const unsigned code = (perm >> (2 * i)) & 3u;
    c[i] = code == 0 ? row : code == 1 ? head : batch;
  }
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(c[0]),
      "r"(c[1]), "r"(c[2])
      : "memory");
}

// a wgmma shared-memory descriptor of the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// A tile is kTileRows rows of atoms of 64 columns, atom a at a x 8 KB; a
// row of an atom is 128 bytes (TMA's 128-byte swizzle), 8 rows 1 KB.
// As a K-major operand (rows = M or N, columns = K): step kk's 16
// columns start 32 bytes into atom kk / 4; the next 8 rows are 1 KB on
// (LBO unused by this swizzle).
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return smem_desc(tile + (kk >> 2) * kAtomBytes + (kk & 3) * 32, 16, 1024);
}

// As an MN-major operand (rows = K, columns = N): step kk's 16 rows start
// kk x 2 KB in; the next 8 rows of K are 1 KB on (SBO), the next 64
// columns of N the next atom (LBO)
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, kAtomBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the compiler must not read or reuse these registers across an
// asynchronous wgmma: each is redefined here, after its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// d (64 x 64 f32) (+)= A B^T, A (64 x 16) and B (64 x 16) bf16 in shared
// memory, both K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A B, A (64 x 16 bf16) in registers (the
// accumulator layout's fragments), B (16 x 64 bf16) in shared memory,
// MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A B, A (64 x 16 bf16) in registers (the
// accumulator layout's fragments), B (16 x 128 bf16) in shared memory,
// MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// a 64 x 64 accumulator (the registers of S^T, dS or the like) as the A
// operands of four steps of depth 16 along its columns, hi and lo halves
__device__ __forceinline__ void a_frags(const float (&w)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(w[8 * kk + 2 * i], w[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
    }
  }
}

// acc (64 x N) += W B over depth 64, W's hi and lo A fragments
// (a_frags) against the tile `b` read MN-major: eight wgmma, issued after
// the fences that pin their registers (committed by the caller)
template <int N>
__device__ __forceinline__ void value_products(float (&acc)[N],
                                               uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4],
                                               uint32_t b) {
  fence_regs(hi);
  fence_regs(lo);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(acc, hi[kk], mn_major(b, kk));
    wgmma_rs(acc, lo[kk], mn_major(b, kk));
  }
}

// which pairs of kv rows [t0, t0 + 64) and query rows [i0, i0 + 64) are
// visible: 0 none, 1 some (test each pair), 2 all
__device__ __forceinline__ int tile_kind(int t0, int i0, const Args& a) {
  const int t1 = min(t0 + kTileRows, a.skv) - 1;
  const int i1 = min(i0 + kTileRows, a.sq) - 1;
  if (t1 < t0 || i1 < i0) return 0;
  const int lo = i0 - t1;  // i - t over the tile's valid pairs
  const int hi = i1 - t0;
  if ((a.causal && hi < 0) || (a.window > 0 && lo >= a.window)) return 0;
  const bool all = t0 + kTileRows <= a.skv && i0 + kTileRows <= a.sq &&
                   (!a.causal || lo >= 0) && (a.window <= 0 ||
                                              hi < a.window);
  return all ? 2 : 1;
}

// kv slot t visible to query i, both inside the sequence (no branch)
__device__ __forceinline__ bool seen(int t, int i, const Args& a) {
  return (t < a.skv) & (i < a.sq) & ((a.causal == 0) | (t <= i)) &
         ((a.window <= 0) | (t > i - a.window));
}

// a tile row's columns: d rounded up to whole atoms
__host__ __device__ constexpr int padded(int d) {
  return (d + kAtom - 1) / kAtom * kAtom;
}

template <int DP>
__host__ __device__ constexpr int tile_bytes() {
  return DP / kAtom * kAtomBytes;
}

// shared memory: 1 KB to align the 128-byte swizzle's atoms, two
// resident tiles a consumer, two tiles a stage, the dkdv stages' lse and
// D (64 floats each), barriers
template <int DP>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(tile_bytes<DP>()) *
                    (2 * kConsumers + 2 * kStages) +
         sizeof(float) * 2 * kStages * kTileRows +
         sizeof(uint64_t) * (1 + 2 * kStages);
}

// the kernels' shared-memory regions
struct Smem {
  uint32_t own;    // kConsumers tiles (K in dkdv, Q in dq)
  uint32_t own2;   // kConsumers tiles (V in dkdv, dO in dq)
  uint32_t ring;   // kStages x 2 tiles
  float* lse;      // [kStages][64], lse * log2 e (dkdv)
  float* dl;       // [kStages][64], D (dkdv)
  uint32_t bars;   // resident, full[kStages], empty[kStages]
};

template <int DP>
__device__ __forceinline__ Smem carve(unsigned char* raw) {
  constexpr int T = tile_bytes<DP>();
  const uint32_t raw_s = smem_u32(raw);
  const uint32_t base = (raw_s + 1023) & ~1023u;
  Smem m;
  m.own = base;
  m.own2 = m.own + kConsumers * T;
  m.ring = m.own2 + kConsumers * T;
  const uint32_t fl = m.ring + kStages * 2 * T;
  m.lse = reinterpret_cast<float*>(raw + (fl - raw_s));
  m.dl = m.lse + kStages * kTileRows;
  m.bars = fl + sizeof(float) * 2 * kStages * kTileRows;
  return m;
}

__device__ __forceinline__ uint32_t full_bar(const Smem& m, int st) {
  return m.bars + 8 * (1 + st);
}

__device__ __forceinline__ uint32_t empty_bar(const Smem& m, int st) {
  return m.bars + 8 * (1 + kStages + st);
}

// barriers: the resident tiles' (one arrival: the producer's), each
// stage's full (`full_count` arrivals) and empty (every consumer thread)
__device__ __forceinline__ void init_bars(const Smem& m, int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(m.bars, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(m, st), full_count);
      mbar_init(empty_bar(m, st), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// two resident 64-row tiles a consumer from `map` (rows from `row0`, a
// tile a consumer) at `dst`, counted on the resident barrier
template <int DP>
__device__ __forceinline__ void load_own(const Smem& m, uint32_t dst,
                                         const CUtensorMap* map, int row0,
                                         int head, int batch,
                                         unsigned perm) {
  constexpr int T = tile_bytes<DP>();
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) {
#pragma unroll
    for (int at = 0; at < DP / kAtom; ++at) {
      tma_load(dst + w * T + at * kAtomBytes, map, m.bars, at * kAtom,
               row0 + w * kTileRows, head, batch, perm);
    }
  }
}

// one 64-row tile of `map` at `dst`, counted on `bar`
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row, int head,
                                          int batch, unsigned perm) {
#pragma unroll
  for (int at = 0; at < DP / kAtom; ++at) {
    tma_load(dst + at * kAtomBytes, map, bar, at * kAtom, row, head, batch,
             perm);
  }
}

// this thread's warpgroup, warp-uniform as the compiler can see (a
// shuffle from lane 0), so that setmaxnreg's branches are whole warps'
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// a 64 x padded(D) accumulator (rows `row0` + its 64, columns < D) times
// `mul` into the bf16 rows below `rows` of `out` (row stride `stride`)
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long stride,
                                           const float (&acc)[padded(D) / 2],
                                           int row0, float mul, int rows) {
  constexpr int DP = padded(D);
  const int tid = threadIdx.x & 127;
  const int r = row0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + c0;
    if (c >= D) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (r + 8 * u < rows) {
        *reinterpret_cast<__nv_bfloat162*>(out + (r + 8 * u) * stride + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * u] * mul,
                                  acc[4 * j + 2 * u + 1] * mul);
      }
    }
  }
}

// dK, dV for 128 kv rows of one kv head (64 a consumer warpgroup, K and V
// resident): every query tile of 64 rows of every q head of the group
// that sees them, through the ring with its lse and D
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ Maps maps,
                                const Args a) {
  extern __shared__ unsigned char tcb_smem[];
  constexpr int DP = padded(D);
  constexpr int T = tile_bytes<DP>();
  const Smem m = carve<DP>(tcb_smem);
  const int k0 = blockIdx.x * kBlockRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.hq / a.hkv;
  const int k1 = min(k0 + kBlockRows, a.skv);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.sq, k1 - 1 + a.window) : a.sq;
  const int t_begin = (q_lo / kTileRows) * kTileRows;
  const int n_tiles = q_hi > t_begin
                          ? (q_hi - t_begin + kTileRows - 1) / kTileRows
                          : 0;
  const int total = G * n_tiles;  // (head, query tile) steps
  init_bars(m, 32);
  const int wg = warpgroup();

  if (wg == kConsumers) {  // the producer warpgroup: its first warp
    producer_regs();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    if (lane == 0) {
      mbar_arrive_tx(m.bars, 2 * kConsumers * T);
      load_own<DP>(m, m.own, &maps.k, k0, hk, b, a.perm_k);
      load_own<DP>(m, m.own2, &maps.v, k0, hk, b, a.perm_v);
    }
    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      mbar_wait(empty_bar(m, st), ((it / kStages) & 1) ^ 1);
      const int h = hk * G + it / n_tiles;
      const int q0 = t_begin + (it % n_tiles) * kTileRows;
      const long long rb = (static_cast<long long>(b) * a.hq + h) * a.sq;
      for (int r = lane; r < kTileRows; r += 32) {
        const int i = q0 + r;
        m.lse[st * kTileRows + r] =
            i < a.sq ? a.lse[rb + i] * kLog2e : __int_as_float(0x7f800000);
        m.dl[st * kTileRows + r] = i < a.sq ? a.delta[rb + i] : 0.f;
      }
      const uint32_t full = full_bar(m, st);
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * T);
        const uint32_t qt = m.ring + st * 2 * T;
        load_tile<DP>(qt, &maps.q, full, q0, h, b, a.perm_q);
        load_tile<DP>(qt + T, &maps.g, full, q0, h, b, a.perm_g);
      } else {
        mbar_arrive(full);
      }
    }
  } else {  // a consumer warpgroup: kv rows kw0 .. kw0 + 63
    consumer_regs();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int kw0 = k0 + wg * kTileRows;
    const int kr = kw0 + 16 * warp + (lane >> 2);  // rows kr, kr + 8
    const float sl2 = a.scale * kLog2e;
    const uint32_t kt = m.own + wg * T;
    const uint32_t vt = m.own2 + wg * T;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(m.bars, 0);
    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      mbar_wait(full_bar(m, st), (it / kStages) & 1);
      const int q0 = t_begin + (it % n_tiles) * kTileRows;
      const int kind = tile_kind(kw0, q0, a);
      if (kind != 0) {
        const uint32_t qt = m.ring + st * 2 * T;
        const uint32_t gt = qt + T;
        // S^T = K Q^T and dP^T = V dO^T (kv rows x query columns), two
        // groups: the exponentials run while dP^T's products do
        float sT[32], pT[32];
        fence_regs(sT);
        fence_regs(pT);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(sT, k_major(kt, kk), k_major(qt, kk), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(pT, k_major(vt, kk), k_major(gt, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sT);
        // P^T; register 4 j + c is kv row kr + 8 (c >> 1), query column
        // 8 j + 2 t4 + (c & 1). A tile that crosses a mask's edge tests
        // each pair (a select, no branch); a full one does not
        const float* ls = m.lse + st * kTileRows;
        const float* ds = m.dl + st * kTileRows;
        if (kind == 2) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              sT[4 * j + c] =
                  ex2(fmaf(sT[4 * j + c], sl2, -((c & 1) ? l2.y : l2.x)));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * t4;
            const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float p =
                  ex2(fmaf(sT[4 * j + c], sl2, -((c & 1) ? l2.y : l2.x)));
              sT[4 * j + c] = seen(kr + 8 * (c >> 1), q0 + col + (c & 1), a)
                                  ? p
                                  : 0.f;
            }
          }
        }
        wgmma_wait<0>();
        fence_regs(pT);
        // dS^T = P^T (dP^T - D); then dV += P^T dO and dK += dS^T Q
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t4);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = 4 * j + c;
            pT[r] = sT[r] * (pT[r] - ((c & 1) ? d2.y : d2.x));
          }
        }
        uint32_t ph[4][4], pl[4][4], dh[4][4], dlo[4][4];
        a_frags(sT, ph, pl);
        if constexpr (DP == kAtom) {  // one group: 16 value products
          a_frags(pT, dh, dlo);
          fence_regs(dh);
          fence_regs(dlo);
          fence_regs(dk);
          value_products(dv, ph, pl, gt);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs(dk, dh[kk], mn_major(qt, kk));
            wgmma_rs(dk, dlo[kk], mn_major(qt, kk));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(ph);
          fence_regs(pl);
          fence_regs(dh);
          fence_regs(dlo);
        } else {  // 128 accumulators: dV's group ends before dS^T is split
          value_products(dv, ph, pl, gt);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(ph);
          fence_regs(pl);
          a_frags(pT, dh, dlo);
          value_products(dk, dh, dlo, qt);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dh);
          fence_regs(dlo);
        }
      }
      mbar_arrive(empty_bar(m, st));
    }
    store_rows<D>(static_cast<bf16*>(a.dk) + at(a.dk_st, b, hk), a.dk_st.s,
                  dk, kw0, a.scale, a.skv);
    store_rows<D>(static_cast<bf16*>(a.dv) + at(a.dv_st, b, hk), a.dv_st.s,
                  dv, kw0, 1.f, a.skv);
  }
}

// dQ for 128 query rows of one q head (64 a consumer warpgroup, Q and dO
// resident): the kv tiles of 64 slots the rows see, through the ring
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ Maps maps,
                              const Args a) {
  extern __shared__ unsigned char tcb_smem[];
  constexpr int DP = padded(D);
  constexpr int T = tile_bytes<DP>();
  const Smem m = carve<DP>(tcb_smem);
  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int q1 = min(q0 + kBlockRows, a.sq);
  const int hi = a.causal ? q1 : a.skv;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = (lo / kTileRows) * kTileRows;
  const int n_tiles =
      hi > t_begin ? (hi - t_begin + kTileRows - 1) / kTileRows : 0;
  init_bars(m, 1);
  const int wg = warpgroup();

  if (wg == kConsumers) {  // the producer warpgroup: one thread
    producer_regs();
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_tx(m.bars, 2 * kConsumers * T);
      load_own<DP>(m, m.own, &maps.q, q0, h, b, a.perm_q);
      load_own<DP>(m, m.own2, &maps.g, q0, h, b, a.perm_g);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(empty_bar(m, st), ((it / kStages) & 1) ^ 1);
        const uint32_t full = full_bar(m, st);
        const uint32_t kt = m.ring + st * 2 * T;
        const int t0 = t_begin + it * kTileRows;
        mbar_arrive_tx(full, 2 * T);
        load_tile<DP>(kt, &maps.k, full, t0, hk, b, a.perm_k);
        load_tile<DP>(kt + T, &maps.v, full, t0, hk, b, a.perm_v);
      }
    }
  } else {  // a consumer warpgroup: query rows qw0 .. qw0 + 63
    consumer_regs();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int qw0 = q0 + wg * kTileRows;
    const int r0 = qw0 + 16 * warp + (lane >> 2);  // rows r0, r0 + 8
    const float sl2 = a.scale * kLog2e;
    const uint32_t qt = m.own + wg * T;
    const uint32_t gt = m.own2 + wg * T;
    const long long rb = (static_cast<long long>(b) * a.hq + h) * a.sq;
    float lse2[2], dl[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = r0 + 8 * u;
      lse2[u] = i < a.sq ? a.lse[rb + i] * kLog2e : __int_as_float(0x7f800000);
      dl[u] = i < a.sq ? a.delta[rb + i] : 0.f;
    }
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    mbar_wait(m.bars, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      mbar_wait(full_bar(m, st), (it / kStages) & 1);
      const int t0 = t_begin + it * kTileRows;
      const int kind = tile_kind(t0, qw0, a);
      if (kind != 0) {
        const uint32_t kt = m.ring + st * 2 * T;
        const uint32_t vt = kt + T;
        // S = Q K^T and dP = dO V^T (query rows x kv columns), two groups:
        // the exponentials run while dP's products do
        float sc[32], dp[32];
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(sc, k_major(qt, kk), k_major(kt, kk), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(dp, k_major(gt, kk), k_major(vt, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        // P; register 4 j + c is query row r0 + 8 (c >> 1), kv column
        // 8 j + 2 t4 + (c & 1); masks as in dkdv
        if (kind == 2) {
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            sc[r] = ex2(fmaf(sc[r], sl2, -lse2[(r >> 1) & 1]));
          }
        } else {
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const int u = (r >> 1) & 1;
            const float p = ex2(fmaf(sc[r], sl2, -lse2[u]));
            sc[r] = seen(t0 + 8 * (r >> 2) + 2 * t4 + (r & 1), r0 + 8 * u, a)
                        ? p
                        : 0.f;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int r = 0; r < 32; ++r) sc[r] = sc[r] * (dp[r] - dl[(r >> 1) & 1]);
        uint32_t sh[4][4], sl[4][4];
        a_frags(sc, sh, sl);
        value_products(dq, sh, sl, kt);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(sh);
        fence_regs(sl);
      }
      mbar_arrive(empty_bar(m, st));
    }
    store_rows<D>(static_cast<bf16*>(a.dq) + at(a.dq_st, b, h), a.dq_st.s,
                  dq, qw0, a.scale, a.sq);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (this library links no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// error codes of the tc launch beyond cudaError_t's: the tensor map was
// refused (kErrEncode + CUresult), or ptxas gave the kernel another
// register count than setmaxnreg's sums assume (kErrRegs + its count)
constexpr int kErrEncode = 10000;
constexpr int kErrRegs = 20000;

// a bf16 (B, H, S, d) view as a 4-dimensional tensor map: d, then the
// sequence (boxes of 64 rows), head and batch dimensions by increasing
// stride; `perm` gets where (row, head, batch) went
int encode(CUtensorMap* map, const void* ptr, const Strides& st, int s,
           int h, int batch, int d, unsigned* perm) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrEncode + CUDA_ERROR_NOT_FOUND;
  struct Dim {
    cuuint64_t n, stride;
    cuuint32_t box;
    unsigned code;
  } dims[3] = {{static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(st.s),
                kTileRows, 0},
               {static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(st.h), 1,
                1},
               {static_cast<cuuint64_t>(batch),
                static_cast<cuuint64_t>(st.b), 1, 2}};
  for (Dim& x : dims) {
    x.stride *= sizeof(bf16);
    if (x.n == 1) x.stride = 16;  // never stepped over
  }
  for (int i = 1; i < 3; ++i) {  // by increasing stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim x = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = x;
    }
  }
  const cuuint64_t gdim[4] = {static_cast<cuuint64_t>(d), dims[0].n,
                              dims[1].n, dims[2].n};
  const cuuint64_t gstride[3] = {dims[0].stride, dims[1].stride,
                                 dims[2].stride};
  const cuuint32_t box[4] = {kAtom, dims[0].box, dims[1].box, dims[2].box};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  *perm = dims[0].code | dims[1].code << 2 | dims[2].code << 4;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

constexpr int kMaxDevices = 64;

// Sets the kernel's shared-memory limit and checks its register count on
// the current device, once per kernel and device (a template instance
// per kernel, so each has its own flags): later launches there skip both
// calls.
template <auto kKernel>
int prepare(size_t smem) {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (ready[dev].load(std::memory_order_acquire)) return 0;
  err = cudaFuncSetAttribute(kKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kKernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != kLaunchRegs) return kErrRegs + attr.numRegs;
  ready[dev].store(true, std::memory_order_release);
  return 0;
}

template <auto kKernel>
int launch_kernel(size_t smem, dim3 grid, const Maps& maps, const Args& a,
                  cudaStream_t s) {
  const int err = prepare<kKernel>(smem);
  if (err != 0) return err;
  kKernel<<<grid, kThreads, smem, s>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_as(int which, const Maps& maps, const Args& a, int batch,
              cudaStream_t s) {
  const int rows = which == 1 ? a.skv : a.sq;  // the CTAs' own rows
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows,
                  which == 1 ? a.hkv : a.hq, batch);
  constexpr size_t smem = smem_bytes<padded(D)>();
  if (which == 1) {
    return launch_kernel<flash_bwd_dkdv_wgmma_kernel<D>>(smem, grid, maps, a,
                                                         s);
  }
  return launch_kernel<flash_bwd_dq_wgmma_kernel<D>>(smem, grid, maps, a, s);
}

int launch(int which, Args a, int batch, cudaStream_t s) {
  Maps maps;
  int err = encode(&maps.q, a.q, a.q_st, a.sq, a.hq, batch, a.d, &a.perm_q);
  if (err == 0) {
    err = encode(&maps.k, a.k, a.k_st, a.skv, a.hkv, batch, a.d, &a.perm_k);
  }
  if (err == 0) {
    err = encode(&maps.v, a.v, a.v_st, a.skv, a.hkv, batch, a.d, &a.perm_v);
  }
  if (err == 0) {
    err = encode(&maps.g, a.dout, a.do_st, a.sq, a.hq, batch, a.d, &a.perm_g);
  }
  if (err != 0) return err;
  switch (a.d) {
    case 16: return launch_as<16>(which, maps, a, batch, s);
    case 32: return launch_as<32>(which, maps, a, batch, s);
    case 48: return launch_as<48>(which, maps, a, batch, s);
    case 64: return launch_as<64>(which, maps, a, batch, s);
    case 80: return launch_as<80>(which, maps, a, batch, s);
    case 96: return launch_as<96>(which, maps, a, batch, s);
    case 112: return launch_as<112>(which, maps, a, batch, s);
    case 128: return launch_as<128>(which, maps, a, batch, s);
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
  const int nb = ((which == 1 ? a.skv : a.sq) + kBlock - 1) / kBlock;
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
    const dim3 grid((a.sq + kWarps - 1) / kWarps, a.hq, batch);
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
               int dtype, int batch, int hq, int hkv, int sq, int skv,
               int d, int causal, int window, float scale, int tc,
               void* stream) {
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > 128 || hkv <= 0 || hq % hkv != 0 || skv <= 0 ||
      strides == nullptr || lse == nullptr || delta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // at Sq != Skv only cross attention: non-causal, no window
  if (sq != skv && (causal || window > 0)) {
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
  Strides* st[] = {&a.q_st,  &a.k_st,  &a.v_st,  &a.o_st,
                   &a.do_st, &a.dq_st, &a.dk_st, &a.dv_st};
  for (int i = 0; i < 8; ++i) {
    st[i]->b = strides[3 * i];
    st[i]->h = strides[3 * i + 1];
    st[i]->s = strides[3 * i + 2];
  }
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.skv = skv;
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

// q, o, dout, dq: (B, Hq, Sq, d); k, v, dk, dv: (B, Hkv, Skv, d); each
// with its own (batch, head, sequence) strides in elements, 24 of them in
// `strides` in the order q, k, v, o, dout, dq, dk, dv, and a contiguous
// last dimension. lse, delta: (B, Hq, Sq) f32 contiguous. dtype 0 = f32,
// 1 = bf16, for all of q, k, v, o, dout, dq, dk, dv. window <= 0 means
// none. d <= 128, Hq % Hkv == 0; Sq != Skv only non-causal without a
// window (cross attention: every query sees every slot). tc = 1 takes the tensor-core
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
    int hkv, int sq, int skv, int d, int causal, int window, float scale,
    int tc, void* stream) {
  return launch_bwd(0, q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                    dtype, batch, hq, hkv, sq, skv, d, causal, window, scale,
                    tc, stream);
}

// dk and dv
extern "C" int flash_attn_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int dtype, int batch, int hq,
    int hkv, int sq, int skv, int d, int causal, int window, float scale,
    int tc, void* stream) {
  return launch_bwd(1, q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                    dtype, batch, hq, hkv, sq, skv, d, causal, window, scale,
                    tc, stream);
}

// dq
extern "C" int flash_attn_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int dtype, int batch, int hq,
    int hkv, int sq, int skv, int d, int causal, int window, float scale,
    int tc, void* stream) {
  return launch_bwd(2, q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                    dtype, batch, hq, hkv, sq, skv, d, causal, window, scale,
                    tc, stream);
}
