// Online-softmax (flash) attention over (B, H, S, d) tensors, with causal
// and sliding-window masks, grouped-query heads and explicit kv positions,
// in three variants behind one wrapper
// (src/repro_torch/kernels/flash_attn/kernel.py:flash_attention, whose
// variant_for picks one from dtype, shapes and strides before any launch).
//
// Replaces: src/repro/kernels/flash_attn/kernel.py:flash_attention (body
// _attn_kernel), the TPU kernel whose grid (B, Hq, nq, nk) walks kv blocks
// in order and carries (m, l, acc) in VMEM scratch from one grid step to
// the next. Every variant computes the function of the reference models'
// jnp twin, src/repro/models/layers.py:_chunk_attention: query row i sits
// at absolute position q_offset + i; kv slot t sits at k_pos[t] (-1 =
// empty) or, without k_pos, at t. A kv slot is masked when its position is
// < 0, above the query's (causal), or at or below the query's minus the
// window. flash_attention is the case q_offset = Skv - Sq with no k_pos. A
// row whose every slot is masked gives 0, as the TPU kernel's masked p and
// clamped l give it. Arithmetic is f32; the output is written in the
// input's type. Only the last dimension of q, k, v and out needs to be
// contiguous: a cache's valid prefix and the transposed projections come
// in as strided views.
//
// What bounds it on an H100: the prefill's score and value products
// (4 * Sq * Skv * d operations a head, halved by the causal mask) are a
// bf16 tensor-core product at heart (989 TFLOP/s); in decode one query row
// reads the whole cache, and the bytes (3.35 TB/s) bound it.
//
// tc (bf16, d % 16 == 0, d <= 128, Sq >= 2; 16-byte aligned rows): the
// prefill on the tensor cores, in FlashAttention-2's shape. One CTA of 4
// warps per (64 query rows, q head, batch), each warp owning 16 rows; the
// heaviest causal q blocks are launched first. Q is staged once and held
// as mma A fragments; K and V tiles of 64 slots go through a 2-stage ring
// in shared memory with 16-byte cp.async, so tile t+1 is in flight while
// tile t is scored. Rows are padded by 16 bytes, so the 8 rows an ldmatrix
// phase reads fall on 8 distinct 16-byte bank groups. S = Q K^T runs on
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the scale multiplies the
// f32 scores. Masks are applied to the accumulator fragment only on tiles
// that straddle a mask edge (or under explicit positions); the online
// (m, l) update runs in registers, row maxima through the 4 lanes that
// share a row. The value product keeps p's precision as the TPU kernel's
// f32 p does: p is split in registers into hi = bf16(p) and lo = bf16(p -
// hi), and two mma.sync against V (through ldmatrix.trans) keep about 16
// significant bits for 1.5x the minimal products. The S accumulator's
// fragment is the A operand's layout, so p never goes through shared
// memory. Softmax exponentials are 2^x on the SFU (ex2.approx) of scores
// kept in log2 units. Registers are capped where that buys a CTA an SM
// (4 at d <= 64, 3 at d = 80): the grid is bound by latency, not by
// instruction throughput.
// mma.sync is not the card's full rate (wgmma with TMA is); that is the
// next redesign if this variant stays under half its bound.
//
// decode (Sq == 1, either dtype, d <= 256): split-kv, bound by the bytes
// of the cache. The grid is (splits, Hkv, B); each CTA takes one
// contiguous chunk of the kv span for one kv head and scores it against
// all Hq / Hkv q heads that share it, so each K/V byte is read once for
// the whole group, 16 bytes a lane where rows are aligned. In one pass,
// each group of lanes that shares a row keeps an online softmax over 4
// rows at a time, with their K and V loads in flight together; the CTA
// writes its partial (m, l, acc[d]) in f32 to a scratch the wrapper
// allocates, and a second launch merges the splits of each (b, h) in
// split order (no atomics: a run is bit-reproducible). The wrapper sizes
// the chunks from host ints so that the grid covers the 132 SMs at least
// twice, and the step reads nothing back.
//
// simt (f32, or d not a multiple of 16, or d > 128, or rows tc cannot
// load with cp.async): the first port of the kernel, on the f32 CUDA
// cores (67 TFLOP/s), bound by shared-memory traffic. The kv axis is a
// loop inside one block per (q block of 16 rows, head, batch), so the
// running (m, l, acc) stay in registers; each kv tile of 32 slots is
// staged once into shared memory as f32 and read by all 8 warps; a warp
// owns two query rows, so each K and V value it loads serves both rows;
// lane j scores slot j of the tile (K is stored transposed and padded so
// the 32 lanes hit 32 banks), and in the value product lanes stride over
// d. Causal and window masks cut the kv loop to the tiles a block can see
// (when kv positions are slot indices).
//
// lse: the simt and tc entries take an optional (B, Hq, Sq) f32 output of
// each row's log-sum-exp (m + log l, in natural units of the scaled
// scores; +inf on a row that sees no slot), which the training forward
// saves for the backward kernels of flash_attn_bwd.cu. A null lse (every
// serving call) writes nothing more, and the outputs are the same.
//
// Built with -fmad=false (the kNN kernels' bit-equality needs it): where
// tc and decode want a fused multiply-add they write __fmaf_rn.

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
  float* lse;  // (B, Hq, Sq) f32 row log-sum-exp, or null (simt, tc)
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
  if (a.lse != nullptr && lane == 0) {
    float* L = a.lse + (static_cast<long long>(b) * a.hq + h) * a.sq;
    if (q0 + r0 < a.sq) L[q0 + r0] = l0 > 0.f ? m0 + logf(l0) : INFINITY;
    if (q0 + r0 + 1 < a.sq) {
      L[q0 + r0 + 1] = l1 > 0.f ? m1 + logf(l1) : INFINITY;
    }
  }
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

// ---------------------------------------------------------------------------
// tc: the tensor-core variant (bf16)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBlockM = 64;  // query rows a CTA
constexpr int kBlockN = 64;  // kv slots a tile
constexpr int kWarps = 4;    // each owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// padded row pitch in elements: 16 bytes more than a row, so the 8 row
// addresses of an ldmatrix phase fall on 8 distinct 16-byte bank groups
template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 8;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(pitch<D>()) *
         (kBlockM + 4 * kBlockN);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes = 0 fills the destination with zeros
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

// rows [row0, row0 + 64) of a (rows, D) matrix with row stride `stride`
// into shared memory at pitch<D>(); rows at or past `nrows` become zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long stride, int row0,
                                          int nrows, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kBlockN * kChunks / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    const bool ok = row0 + r < nrows;
    const bf16* src = ok ? g + static_cast<long long>(row0 + r) * stride + c
                         : g;
    cp_async16(smem_u32(s + r * pitch<D>() + c), src, ok);
  }
}

// 2^x by the SFU (2 ulp; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// CTAs an SM should hold, as a register cap: at d <= 80 another CTA hides
// the latency between the products better than registers left free
template <int D>
__host__ __device__ constexpr int min_ctas() {
  return D <= 64 ? 4 : (D <= 80 ? 3 : 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, min_ctas<D>())
    flash_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int P = pitch<D>();
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [64][P]
  bf16* ks = qs + kBlockM * P;                  // [2][64][P]
  bf16* vs = ks + 2 * kBlockN * P;              // [2][64][P]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // heavy first
  const int hk = h / (a.hq / a.hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the fragment's row (and row + 8)
  const int tig = lane & 3;  // its column pair

  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.skb + hk * a.skh;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.svb + hk * a.svh;
  bf16* O = static_cast<bf16*>(a.o) + b * a.sob + h * a.soh;

  // the kv slots this block can see (every slot under explicit positions)
  int lo = 0, hi = a.skv;
  if (a.kpos == nullptr) {
    const int q_first = a.q_offset + q0;
    const int q_last = a.q_offset + min(q0 + kBlockM, a.sq) - 1;
    if (a.causal) hi = min(hi, q_last + 1);
    if (a.window > 0) lo = max(0, q_first - a.window + 1);
  }
  const int t_begin = (lo / kBlockN) * kBlockN;
  const int n_tiles = hi > t_begin ? (hi - t_begin + kBlockN - 1) / kBlockN
                                   : 0;

  load_tile<D>(qs, Q, a.sqs, q0, a.sq, tid);
  if (n_tiles > 0) {
    load_tile<D>(ks, K, a.sks, t_begin, a.skv, tid);
    load_tile<D>(vs, V, a.svs, t_begin, a.skv, tid);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 columns of d
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int row = warp * 16 + (lane & 15);
    const int col = kk * 16 + (lane >> 4) * 8;
    ldsm_x4(smem_u32(qs + row * P + col), qf[kk][0], qf[kk][1], qf[kk][2],
            qf[kk][3]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running row maxima (rows g, g + 8)
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the row sums
  const int qp0 = a.q_offset + q0 + warp * 16 + g;
  const int qp1 = qp0 + 8;
  const int qw_first = a.q_offset + q0 + warp * 16;
  const int qw_last = qw_first + 15;
  const float sl2 = a.scale * kLog2e;  // scores in log2 units
  const int mi = lane >> 3;  // the ldmatrix.x4 matrix this lane addresses
  const int mr = lane & 7;   // and its row there

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kBlockN;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(ks + (st ^ 1) * kBlockN * P, K, a.sks, t0 + kBlockN,
                   a.skv, tid);
      load_tile<D>(vs + (st ^ 1) * kBlockN * P, V, a.svs, t0 + kBlockN,
                   a.skv, tid);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* kt = ks + st * kBlockN * P;
    const bf16* vt = vs + st * kBlockN * P;

    // S = Q K^T: 8 fragments of 16 rows x 8 slots
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        const int slot = nn * 16 + mr + 8 * (mi >> 1);
        const int col = kk * 16 + 8 * (mi & 1);
        ldsm_x4(smem_u32(kt + slot * P + col), b0, b1, b2, b3);
        mma(s[2 * nn], qf[kk], b0, b1);
        mma(s[2 * nn + 1], qf[kk], b2, b3);
      }
    }

    // scale; mask only a tile that straddles a mask edge for this warp
    const bool edge = a.kpos != nullptr || t0 + kBlockN > a.skv ||
                      (a.causal && t0 + kBlockN - 1 > qw_first) ||
                      (a.window > 0 && t0 <= qw_last - a.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x0 = s[j][c] * sl2;
        float x1 = s[j][c + 2] * sl2;
        if (edge) {
          const int t = t0 + 8 * j + 2 * tig + c;
          int kp = -1;
          if (t < a.skv) kp = a.kpos == nullptr ? t : a.kpos[t];
          if (!visible(kp, qp0, a.causal, a.window)) x0 = -INFINITY;
          if (!visible(kp, qp1, a.causal, a.window)) x1 = -INFINITY;
        }
        s[j][c] = x0;
        s[j][c + 2] = x1;
      }
    }

    // online softmax: row maxima over the 4 lanes that share a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float al0 = ex2(m0 - mx0);
    const float al1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = ex2(s[j][0] - mx0);
      s[j][1] = ex2(s[j][1] - mx0);
      s[j][2] = ex2(s[j][2] - mx1);
      s[j][3] = ex2(s[j][3] - mx1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = __fmaf_rn(l0, al0, rs0);
    l1 = __fmaf_rn(l1, al1, rs1);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P V, p as bf16 hi + lo; the S fragments are P's A fragments
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t b0, b1, b2, b3;
        const int slot = kk * 16 + mr + 8 * (mi & 1);
        const int col = nn * 16 + 8 * (mi >> 1);
        ldsm_x4_t(smem_u32(vt + slot * P + col), b0, b1, b2, b3);
        mma(o[2 * nn], ph, b0, b1);
        mma(o[2 * nn], pl, b0, b1);
        mma(o[2 * nn + 1], ph, b2, b3);
        mma(o[2 * nn + 1], pl, b2, b3);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g;
  if (a.lse != nullptr && tig == 0) {
    // m and the exponentials are in log2 units of the scaled scores
    constexpr float kLn2 = 0.6931471805599453f;
    float* L = a.lse + (static_cast<long long>(b) * a.hq + h) * a.sq;
    if (r0 < a.sq) L[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : INFINITY;
    if (r0 + 8 < a.sq) {
      L[r0 + 8] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : INFINITY;
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (r0 < a.sq) {
      *reinterpret_cast<__nv_bfloat162*>(O + r0 * a.sos + c) =
          __floats2bfloat162_rn(o[n][0] / den0, o[n][1] / den0);
    }
    if (r0 + 8 < a.sq) {
      *reinterpret_cast<__nv_bfloat162*>(O + (r0 + 8) * a.sos + c) =
          __floats2bfloat162_rn(o[n][2] / den1, o[n][3] / den1);
    }
  }
}

template <int D>
int launch_as(const Args& a, int batch, cudaStream_t s) {
  auto kernel = flash_tc_kernel<D>;
  constexpr size_t smem = smem_bytes<D>();
  static bool sized = false;
  if (smem > 48 * 1024 && !sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(a.hq, batch, (a.sq + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args& a, int batch, cudaStream_t s) {
  switch (a.d) {
    case 16: return launch_as<16>(a, batch, s);
    case 32: return launch_as<32>(a, batch, s);
    case 48: return launch_as<48>(a, batch, s);
    case 64: return launch_as<64>(a, batch, s);
    case 80: return launch_as<80>(a, batch, s);
    case 96: return launch_as<96>(a, batch, s);
    case 112: return launch_as<112>(a, batch, s);
    case 128: return launch_as<128>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// decode: split-kv for one query row
// ---------------------------------------------------------------------------

namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kHeadTile = 8;  // most q heads whose accumulators a lane holds
constexpr int kUnroll = 4;    // K and V rows a lane has in flight
constexpr int kMaxSplits = 4096;

struct Split {
  float* part;  // acc [B][Hq][splits][d], then m and l [B][Hq][splits]
  int lo, hi, chunk, splits;
};

// V consecutive elements of a row as loaded (16 bytes, or one element);
// [e] gives element e in f32 where it is used
template <typename T, int V>
struct Raw;

template <>
struct Raw<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float operator[](int e) const {
    return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
  }
};

template <>
struct Raw<float, 1> {
  float r;
  __device__ __forceinline__ void load(const float* p) { r = __ldg(p); }
  __device__ __forceinline__ void zero() { r = 0.f; }
  __device__ __forceinline__ float operator[](int) const { return r; }
};

template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float operator[](int e) const {
    const uint32_t w = e < 2 ? r.x : e < 4 ? r.y : e < 6 ? r.z : r.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Raw<__nv_bfloat16, 1> {
  __nv_bfloat16 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { r = p[0]; }
  __device__ __forceinline__ void zero() { r = __float2bfloat16_rn(0.f); }
  __device__ __forceinline__ float operator[](int) const {
    return __bfloat162float(r);
  }
};

// vectors a lane holds of one row (d <= 256 in vectors of V elements)
template <int V>
__host__ __device__ constexpr int max_vpl() {
  return (256 / V + 31) / 32;
}

// The (V-vectors of) rows [s0, s0 + n) of `base` at row stride `stride`:
// each row is taken by `lpr` lanes (a power of two), so a warp takes
// 32 / lpr rows at a time and a lane holds up to max_vpl<V>() vectors.
struct Layout {
  int nvec, lpr, vpl, li, row_id, rows_pass;
};

template <typename T, int V>
__device__ __forceinline__ void load_rows(
    const T* base, long long stride, int s0, int n, int r0, const Layout& L,
    Raw<T, V> (&x)[kUnroll][max_vpl<V>()]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int r = r0 + u * L.rows_pass + L.row_id;
#pragma unroll
    for (int w = 0; w < max_vpl<V>(); ++w) {
      const int vi = L.li + w * L.lpr;
      if (r < n && w < L.vpl && vi < L.nvec) {
        x[u][w].load(base + static_cast<long long>(s0 + r) * stride + vi * V);
      } else {
        x[u][w].zero();
      }
    }
  }
}

// (m, l, acc) of a partial softmax merged with another's: both scaled to
// the larger maximum. The sum is written so that it does not depend on
// which of the two is "ours", so both partners of a shuffle get the same
// bits.
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[E],
                                      float mo, float lo,
                                      const float (&acco)[E]) {
  const float mn = fmaxf(m, mo);
  const float a1 = expf(m - mn);
  const float a2 = expf(mo - mn);
  l = l * a1 + lo * a2;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] * a1 + acco[e] * a2;
  m = mn;
}

// One chunk of the kv span for one kv head against the HT q heads of its
// group that a pass holds (all G in ceil(G / HT) passes). A row of K and
// V is taken by L.lpr lanes; each lane row group keeps an online softmax
// (m, l, acc) per q head over the rows it takes, kUnroll rows at a time
// (their K and V in flight together, one rescale for the batch); the row
// groups of a warp merge by shuffles, the 4 warps through shared memory
// in warp order.
template <typename T, int V, int HT>
__global__ void __launch_bounds__(kThreads)
    flash_decode_split_kernel(const Args a, const Split sp) {
  extern __shared__ float dsm[];
  constexpr int W = max_vpl<V>();  // vectors a lane holds of a row
  constexpr int E = W * V;         // elements
  const int G = a.hq / a.hkv;
  const int d = a.d;
  float* qsm = dsm;                       // [G][d], scaled q
  float* red = qsm + G * d;               // [kWarps][HT][d] acc
  float* red_ml = red + kWarps * HT * d;  // [kWarps][HT][2] (m, l)

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = sp.lo + split * sp.chunk;
  const int n = max(0, min(sp.chunk, sp.hi - s0));
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* Q = static_cast<const T*>(a.q) + b * a.sqb + hk * G * a.sqh;
  const T* K = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* Vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  for (int e = tid; e < G * d; e += kThreads) {
    const int gq = e / d;
    const int c = e - gq * d;
    qsm[e] = load(Q, gq * a.sqh + c) * a.scale;
  }

  Layout L;
  L.nvec = (d + V - 1) / V;
  L.lpr = 1;
  while (L.lpr < L.nvec && L.lpr < 32) L.lpr <<= 1;
  L.vpl = (L.nvec + L.lpr - 1) / L.lpr;
  L.li = lane & (L.lpr - 1);
  const int rg = lane / L.lpr;
  L.row_id = warp * (32 / L.lpr) + rg;
  L.rows_pass = kWarps * (32 / L.lpr);
  __syncthreads();

  const long long nsplit = static_cast<long long>(sp.splits);
  const long long row0 = (static_cast<long long>(b) * a.hq + hk * G) *
                         nsplit + split;
  const long long total = static_cast<long long>(gridDim.z) * a.hq * nsplit;
  for (int g0 = 0; g0 < G; g0 += HT) {
    float m[HT], l[HT], acc[HT][E];
#pragma unroll
    for (int gi = 0; gi < HT; ++gi) {
      m[gi] = kNegInf;
      l[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
    }
    for (int r0 = 0; r0 < n; r0 += L.rows_pass * kUnroll) {
      Raw<T, V> xk[kUnroll][W], xv[kUnroll][W];
      load_rows<T, V>(K, a.sks, s0, n, r0, L, xk);
      load_rows<T, V>(Vp, a.svs, s0, n, r0, L, xv);
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * L.rows_pass + L.row_id;
        int kp = -1;
        if (r < n) kp = a.kpos == nullptr ? s0 + r : a.kpos[s0 + r];
        ok[u] = visible(kp, a.q_offset, a.causal, a.window);
      }
#pragma unroll
      for (int gi = 0; gi < HT; ++gi) {
        if (g0 + gi >= G) continue;  // uniform across the CTA
        const float* qr = qsm + (g0 + gi) * d;
        float sc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const int vi = L.li + w * L.lpr;
            if (w < L.vpl && vi < L.nvec) {
#pragma unroll
              for (int e = 0; e < V; ++e) {
                dot = __fmaf_rn(xk[u][w][e], qr[vi * V + e], dot);
              }
            }
          }
          sc[u] = dot;
        }
        for (int off = L.lpr >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            sc[u] += __shfl_xor_sync(kFull, sc[u], off);
          }
        }
        float mx = m[gi];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          sc[u] = ok[u] ? sc[u] : -INFINITY;
          mx = fmaxf(mx, sc[u]);
        }
        const float al = expf(m[gi] - mx);
        float p[kUnroll];
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = expf(sc[u] - mx);
          ps += p[u];
        }
        l[gi] = __fmaf_rn(l[gi], al, ps);
#pragma unroll
        for (int w = 0; w < W; ++w) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            float x = acc[gi][w * V + e] * al;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              x = __fmaf_rn(p[u], xv[u][w][e], x);
            }
            acc[gi][w * V + e] = x;
          }
        }
        m[gi] = mx;
      }
    }
    // the row groups of a warp, by shuffles
#pragma unroll
    for (int gi = 0; gi < HT; ++gi) {
      if (g0 + gi >= G) continue;
      for (int off = L.lpr; off < 32; off <<= 1) {
        float acco[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acco[e] = __shfl_xor_sync(kFull, acc[gi][e], off);
        }
        const float mo = __shfl_xor_sync(kFull, m[gi], off);
        const float lo = __shfl_xor_sync(kFull, l[gi], off);
        merge<E>(m[gi], l[gi], acc[gi], mo, lo, acco);
      }
    }
    if (rg == 0) {
#pragma unroll
      for (int gi = 0; gi < HT; ++gi) {
        if (g0 + gi >= G) continue;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int vi = L.li + w * L.lpr;
          if (w < L.vpl && vi < L.nvec) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
              red[(warp * HT + gi) * d + vi * V + e] = acc[gi][w * V + e];
            }
          }
        }
        if (L.li == 0) {
          red_ml[2 * (warp * HT + gi)] = m[gi];
          red_ml[2 * (warp * HT + gi) + 1] = l[gi];
        }
      }
    }
    __syncthreads();
    // the 4 warps in order: each thread one (q head, column)
    const int heads = min(HT, G - g0);
    for (int e = tid; e < heads * d; e += kThreads) {
      const int gi = e / d;
      const int c = e - gi * d;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        mx = fmaxf(mx, red_ml[2 * (w * HT + gi)]);
      }
      float sum = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(red_ml[2 * (w * HT + gi)] - mx);
        sum += red[(w * HT + gi) * d + c] * wt;
        den += red_ml[2 * (w * HT + gi) + 1] * wt;
      }
      const long long row = row0 + (g0 + gi) * nsplit;
      sp.part[row * d + c] = sum;
      if (c == 0) {
        sp.part[total * d + row] = mx;
        sp.part[total * (d + 1) + row] = den;
      }
    }
    __syncthreads();
  }
}

// Merges the splits of one (q head, batch): the weights exp(m_i - max m)
// once in shared memory, then `ng` thread groups each sum a contiguous run
// of splits in order, and the groups are added in order (no atomics: the
// same bits every run).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_combine_kernel(const Args a, const Split sp) {
  extern __shared__ float csm[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = a.d;
  const int tid = threadIdx.x;
  const int ns = sp.splits;
  const int ng = d < kThreads ? kThreads / d : 1;
  float* wt = csm;          // [splits]
  float* red = wt + ns;     // [ng][d + 1]
  float* wmax = red + ng * (d + 1);  // [kWarps]
  const long long nsplit = static_cast<long long>(ns);
  const long long total = static_cast<long long>(gridDim.y) * a.hq * nsplit;
  const long long row0 = (static_cast<long long>(b) * a.hq + h) * nsplit;
  const float* pm = sp.part + total * d + row0;
  const float* pl = sp.part + total * (d + 1) + row0;
  const float* pa = sp.part + row0 * d;

  float mx = kNegInf;
  for (int i = tid; i < ns; i += kThreads) mx = fmaxf(mx, pm[i]);
  mx = warp_max(mx);
  if ((tid & 31) == 0) wmax[tid >> 5] = mx;
  __syncthreads();
  mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wmax[w]);
  for (int i = tid; i < ns; i += kThreads) wt[i] = expf(pm[i] - mx);
  __syncthreads();

  const int per = (ns + ng - 1) / ng;
  for (int c0 = 0; c0 < d; c0 += kThreads) {
    const int grp = tid / d;
    const int c = c0 + tid - grp * d;
    if (grp < ng && c < d) {
      const int i0 = grp * per;
      const int i1 = min(ns, i0 + per);
      float acc = 0.f, den = 0.f;
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        acc = __fmaf_rn(pa[static_cast<long long>(i) * d + c], wt[i], acc);
        den = __fmaf_rn(pl[i], wt[i], den);
      }
      red[grp * (d + 1) + c - c0] = acc;
      if (c == c0) red[grp * (d + 1) + d] = den;
    }
    __syncthreads();
    if (tid < min(kThreads, d - c0)) {
      float acc = 0.f, den = 0.f;
      for (int g = 0; g < ng; ++g) {
        acc += red[g * (d + 1) + tid];
        den += red[g * (d + 1) + d];
      }
      T* O = static_cast<T*>(a.o) + b * a.sob + h * a.soh;
      store(O, c0 + tid, acc / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

inline size_t smem_bytes(const Args& a) {
  const size_t G = static_cast<size_t>(a.hq / a.hkv);
  return sizeof(float) * (G * a.d + kWarps * kHeadTile * (a.d + 2));
}

inline size_t combine_smem_bytes(const Args& a, const Split& sp) {
  const int ng = a.d < kThreads ? kThreads / a.d : 1;
  return sizeof(float) * (sp.splits + ng * (a.d + 1) + kWarps);
}

template <typename T, int V, int HT>
int launch_as(const Args& a, const Split& sp, int batch, cudaStream_t s) {
  auto kernel = flash_decode_split_kernel<T, V, HT>;
  const size_t smem = smem_bytes(a);
  static bool sized = false;
  if (smem > 48 * 1024 && !sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  kernel<<<dim3(sp.splits, a.hkv, batch), kThreads, smem, s>>>(a, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<T><<<dim3(a.hq, batch), kThreads,
                                   combine_smem_bytes(a, sp), s>>>(a, sp);
  return static_cast<int>(cudaGetLastError());
}

// the q heads a pass holds: the group itself up to kHeadTile
template <typename T, int V>
int launch_typed(const Args& a, const Split& sp, int batch, cudaStream_t s) {
  const int G = a.hq / a.hkv;
  if (G == 1) return launch_as<T, V, 1>(a, sp, batch, s);
  if (G == 2) return launch_as<T, V, 2>(a, sp, batch, s);
  if (G <= 4) return launch_as<T, V, 4>(a, sp, batch, s);
  return launch_as<T, V, kHeadTile>(a, sp, batch, s);
}

}  // namespace dec

}  // namespace

// q: (B, Hq, Sq, d), k/v: (B, Hkv, Skv, d), out: (B, Hq, Sq, d), each with
// its own (batch, head, sequence) strides in elements and a contiguous last
// dimension; kpos: (Skv,) int32 or null; lse: (B, Hq, Sq) f32 contiguous or
// null, each row's log-sum-exp of its scaled visible scores (+inf on a row
// that sees no slot) for the backward (simt and tc; decode takes null).
// dtype 0 = f32, 1 = bf16, for all four. window <= 0 means none. Each
// entry launches on `stream` and returns the launch's cudaError_t (0 on
// success); the wrapper checks d <= 256, Hq % Hkv == 0 and which variant
// the inputs fit.

// simt: any d <= 256, either dtype.
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* kpos, void* lse, int dtype, int batch, int hq, int hkv,
    int sq, int skv, int d, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long soh, long long sos,
    int q_offset, int causal, int window, float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q,   k,   v,   out, static_cast<const int32_t*>(kpos),
         static_cast<float*>(lse),
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

// tc: bf16 only, d in {16, 32, ..., 128}; the base pointers and the
// (batch, head, sequence) strides of q, k and v 16-byte aligned.
extern "C" int flash_attn_tc_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* kpos, void* lse, int dtype, int batch, int hq, int hkv,
    int sq, int skv, int d, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long soh, long long sos,
    int q_offset, int causal, int window, float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  if (dtype != 1 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q,   k,   v,   out, static_cast<const int32_t*>(kpos),
         static_cast<float*>(lse),
         sqb, sqh, sqs,
         skb, skh, sks,
         svb, svh, svs,
         sob, soh, sos,
         hq,  hkv, sq,  skv, d, q_offset, causal, window,
         scale};
  return tc::launch(a, batch, static_cast<cudaStream_t>(stream));
}

// decode: sq == 1, either dtype, d <= 256. part: f32 scratch of
// B * Hq * splits * (d + 2) entries; the kv span [lo, hi) is cut into
// `splits` chunks of `chunk` slots. vec = 1: k and v rows are 16-byte
// aligned (base, strides and d), loaded 16 bytes a lane.
extern "C" int flash_attn_decode_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* kpos, void* lse, int dtype, int batch, int hq, int hkv,
    int sq, int skv, int d, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long soh, long long sos,
    int q_offset, int causal, int window, float scale, void* part, int lo,
    int hi, int chunk, int splits, int vec, void* stream) {
  if (batch <= 0 || hq <= 0) return 0;
  if (sq != 1 || d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0 ||
      lse != nullptr || chunk <= 0 || splits <= 0 || splits > dec::kMaxSplits ||
      part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q,   k,   v,   out, static_cast<const int32_t*>(kpos),
         static_cast<float*>(lse),
         sqb, sqh, sqs,
         skb, skh, sks,
         svb, svh, svs,
         sob, soh, sos,
         hq,  hkv, sq,  skv, d, q_offset, causal, window,
         scale};
  const dec::Split sp{static_cast<float*>(part), lo, hi, chunk, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? dec::launch_typed<float, 4>(a, sp, batch, s)
               : dec::launch_typed<float, 1>(a, sp, batch, s);
  }
  if (dtype == 1) {
    return vec ? dec::launch_typed<__nv_bfloat16, 8>(a, sp, batch, s)
               : dec::launch_typed<__nv_bfloat16, 1>(a, sp, batch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
