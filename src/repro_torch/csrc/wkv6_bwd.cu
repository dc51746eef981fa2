// The backward of RWKV6's wkv recurrence (csrc/wkv6.cu): for each (batch,
// head), with S_{t-1} the (hd x hd) f32 state before token t and G_t the
// gradient of the state after it (G of the last token 0, the last state
// taking no gradient), for t from the last token down:
//   dr_t[k] = sum_v dy_t[v] S_{t-1}[k][v] + u[k] k_t[k] (v_t . dy_t)
//   dk_t[k] = u[k] r_t[k] (v_t . dy_t) + sum_v G_t[k][v] v_t[v]
//   dv_t[v] = dy_t[v] sum_k r_t[k] u[k] k_t[k] + sum_k G_t[k][v] k_t[k]
//   dw_t[k] = sum_v G_t[k][v] S_{t-1}[k][v]
//   du[k]   = sum_{b,t} r_t[k] k_t[k] (v_t . dy_t)
//   G_{t-1} = w_t G_t + r_t dy_t^T, and dstate0 = G before the first token.
//
// Replaces no TPU kernel. The reference trains RWKV6 through XLA's
// autodiff of the lax.scan of src/repro/models/rwkv.py:time_mix (its
// `step`, rwkv.py:58-69); the port's forward is csrc/wkv6.cu, and this is
// its gradient, joined to it by kernels/wkv/kernel.py:Wkv6. The plain
// version is kernels/wkv/ref.py:wkv6_bwd_plain (the same formulas, one
// token at a time); kernels/wkv/ref.py:wkv6_bwd_segmented_plain mirrors
// this file's decomposition on the CPU.
//
// Time segments. Both recurrences are linear with a diagonal decay, so a
// segment of tokens [t0, t1) carries across through one per-key vector,
// its decay product D = prod w_t:
//   S_{t1-1} = D o S_{t0-1} + S_loc,   G_{t0-1} = D o G_{t1-1} + G_loc,
// with S_loc and G_loc the segment's own walks from zero. So the S tokens
// of a (batch, head) split into segments that separate CTAs take, in
// three launches:
//  (a) wkv6_bwd_local_kernel, a CTA a (batch, head, 32 columns, segment):
//      the state walk from zero, writing the local state at every
//      kChunk-th (8th) token and the keys' decay prefix there, then S_loc
//      and D; then the G walk back from zero (2 instructions a (token,
//      key, value)), writing G_loc and du's partial (r k (v . dy) over
//      the CTA's columns);
//  (b) wkv6_bwd_carry_kernel: the segments in order, a CTA a (batch,
//      head, 32 columns): S forward from state0 and G back from 0, each
//      segment's true S at its start and G at its end written over S_loc
//      and G_loc; G before the first segment is dstate0. An extra row of
//      CTAs adds du's partials (over batch, column block and segment) in
//      a fixed order, in f64, rounding once;
//  (c) wkv6_bwd_kernel, a CTA a (batch, head, 32 columns, segment), the
//      head's two column blocks one thread-block cluster: the 8-token
//      chunks from the segment's last, and in each its two 4-token
//      sub-chunks from the later: a sub-chunk starts from the chunk's
//      rebuilt checkpoint (local + prefix o S_start: one FMA an element;
//      decays that underflow to 0 are harmless, nothing divides by them),
//      the later one walked forward over the earlier's 4 tokens first (the
//      state update alone); its kSub states are recomputed into shared
//      memory (each thread its own tile, so no barrier between writer and
//      reader) while it forms dr, then walked back with G in registers
//      (dw, dk, dv). dv is complete in the CTA; dr, dk and dw are sums
//      over the head's two column blocks, which the cluster's CTAs add
//      through distributed shared memory (each writes the other's keys'
//      shares to its own shared memory, a split cluster barrier around
//      dv's stores, then each adds the two for its 32 keys): they reach
//      device memory only as outputs.
// No atomics: two calls on the same inputs give the same bits.
//
// The chunk loads: a chunk's inputs (r, k, w of all keys; v and dy of the
// CTA's columns) come in a 2-stage shared-memory ring by 16-byte
// cp.async with zero fill past the segment, a thread at most one piece of
// each array, chunk j - 1's in flight while chunk j computes. The copies
// complete with cp.async.wait_group before the chunk's first CTA barrier,
// which every chunk needs anyway (the warps' per-token sums), so the ring
// takes no mbarrier and no register. Checkpoints every 8 tokens rather
// than at every held sub-chunk halve the local states written and read
// (0.67 GB each way at rwkv6-3b's training shape) for 0.5 extra state
// updates a (token, key, value) in (c).
//
// Occupancy and segments: a thread holds 2 keys by 8 columns of S and G (a
// warp: 16 keys by 32 columns), 128 threads at hd 64. The main kernel's
// CTA takes ~50 KB of shared memory (bf16: the ring 11 KB, the
// sub-chunk's states 32 KB, the sums' exchange 6.5 KB) and at most 128
// registers (its launch bounds), so 4 fit an SM: 528 resident slots on
// 132 SMs. At rwkv6-3b's training shape (B = 4, H = 40, hd 64) a segment
// count n gives 320 n CTAs. The launcher (plan) takes the n that needs
// the fewest chunk steps a resident slot, ceil(320 n / 528) waves times
// ceil(256 / n) chunks a CTA, and of those the most segments up to 8
// waves: n = 13, 160-token segments, 4,160 CTAs (7.9 waves), where the
// first design's one kernel ran 320 CTAs, 2.4 an SM. Segments are at
// least 64 tokens (kMinSeg) but for a shorter sequence, so (b)'s walk
// stays short. Throwaway builds timed in one call on the card (random
// inputs of that shape, device-bound): the first design 3.63 ms;
// segments with 4-token checkpoints (5 CTAs an SM) 2.62; 8-token
// checkpoints 2.30 (local 0.51, carry 0.05, main 1.62 by the profiler);
// the same at 6 segments 2.39.
//
// Tensor cores are not the route: the bar is 2e-5 of each output's
// largest value, and a chunked matrix form of the walk would round
// decay-scaled keys and states to bf16 or TF32 (2^-9 to 2^-11 relative),
// so the walk keeps f32 FMAs.
//
// What bounds it on an H100: FP32 instruction slots. A (token, key,
// value) triple costs (a)'s state update and G update (4 instructions),
// (c)'s rebuild and advance (~1), recompute of the state, the FMA of dr,
// the walk's FMAs of dw, dk and dv and G's update (8): ~13 instructions,
// 14 operations of the function's least (an FMA counted as 2). At
// rwkv6-3b's training shape (4 x 2,048 tokens, 40 heads of 64) that is
// 1.34e9 triples, 1.7e10 instructions: ~0.5 ms at 128 lanes a clock on
// 132 SMs at 1.98 GHz; the main kernel issues ~26 instructions a triple
// in all (loads, shuffles, selects, addresses).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 8;     // tokens a stage and between checkpoints
constexpr int kSub = 4;       // tokens whose states the main kernel holds
constexpr int kVB = 32;       // state columns a CTA
constexpr int kTK = 2;        // keys a thread
constexpr int kTV = 8;        // columns a thread
constexpr int kTile = kTK * kTV;
constexpr int kMinSeg = 64;   // tokens a segment, at least (but one)
constexpr int kMaxWaves = 8;  // the main kernel's waves, at most (plan)
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

template <int HD>
struct Shape {
  static constexpr int kThreads = HD / kTK * (kVB / kTV);  // 128 at hd 64
  static constexpr int NW = kThreads / 32;                 // 16 keys each
  static constexpr int NVB = HD / kVB;   // CTAs a head: a cluster
};

// a chunk's inputs as they lie in memory (v and dy: the CTA's columns)
template <typename T, int HD>
struct Stage {
  T r[kChunk][HD], k[kChunk][HD];
  float w[kChunk][HD];
  T v[kChunk][kVB];
  float dy[kChunk][kVB];
};

template <typename T, int HD>
struct __align__(16) MainSmem {
  Stage<T, HD> st[2];
  // S_{t-1} of a sub-chunk's tokens, [token][tile element][thread]
  float states[kSub][kTile][Shape<HD>::kThreads];
  float dvpart[kSub][Shape<HD>::NW][kVB];
  float xown[3][kSub][kVB];       // dr, dk, dw: this CTA's share, its keys
  float xpeer[2][3][kSub][kVB];   // the same of the other CTA's keys, by
                                  // sub-chunk parity (it reads them)
  float u[HD];
  float bonus[kChunk];              // sum_k r u k
  float vdy[kChunk];                // the sum over the CTA's columns of v dy
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; ok = false fills the destination with zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// kChunk rows of ROW bytes from `src` at a pitch of `pitch` bytes; rows at
// or past n become zeros. A thread copies at most one 16-byte piece of
// each row set (kChunk ROW / 16 <= kThreads at every shape taken)
template <int ROW, int kThreads>
__device__ __forceinline__ void stage_rows(void* dst, const void* src,
                                           long long pitch, int n) {
  constexpr int P = ROW / 16;
  static_assert(kChunk * P <= kThreads, "one piece a thread");
  const int i = threadIdx.x;
  if (kChunk * P == kThreads || i < kChunk * P) {
    const int t = i / P, p = i % P;
    const bool ok = t < n;
    const char* s = static_cast<const char*>(src) + (ok ? t * pitch : 0) +
                    p * 16;
    cp16(static_cast<char*>(dst) + t * ROW + p * 16, s, ok);
  }
}

// the cluster's barrier in two halves: arrive (release: this thread's
// shared-memory writes are visible to the cluster) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// tokens [t0, t0 + n) of k and w (all keys) and v (the CTA's columns),
// with kAll r and dy as well, into `st`; `row` is the element offset of
// (b, t0, h, 0), `pitch` = H * HD
template <bool kAll, typename T, int HD>
__device__ __forceinline__ void stage(Stage<T, HD>& st, const T* r,
                                      const T* k, const T* v, const float* w,
                                      const float* dy, long long row,
                                      long long pitch, int vb, int n) {
  constexpr int kThreads = Shape<HD>::kThreads;
  constexpr int E = static_cast<int>(sizeof(T));
  stage_rows<HD * E, kThreads>(st.k, k + row, pitch * E, n);
  stage_rows<HD * 4, kThreads>(st.w, w + row, pitch * 4, n);
  stage_rows<kVB * E, kThreads>(st.v, v + row + vb, pitch * E, n);
  if (kAll) {
    stage_rows<HD * E, kThreads>(st.r, r + row, pitch * E, n);
    stage_rows<kVB * 4, kThreads>(st.dy, dy + row + vb, pitch * 4, n);
  }
}

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the values at p and p + 1 (p even) as f32
__device__ __forceinline__ void pair(const float* p, float& a, float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void pair(const __nv_bfloat16* p, float& a,
                                     float& b) {
  const unsigned x = *reinterpret_cast<const unsigned*>(p);
  a = __uint_as_float(x << 16);
  b = __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ void load8(float* d, const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}
__device__ __forceinline__ void load8(float* d, const __nv_bfloat16* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[2 * i] = __uint_as_float(x[i] << 16);
    d[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float* d) {
  *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(d[4], d[5], d[6], d[7]);
}

__device__ __forceinline__ float warp_sum(float p) {
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) p += __shfl_xor_sync(kAll, p, m);
  return p;
}

// the sum over a row's 4 column-group lanes (lane bits 0 and 1) of the
// thread's partials of its two keys: the lane keeps key (lane >> 1) & 1
__device__ __forceinline__ float key_sum(float p0, float p1, int lane) {
  const bool hi = lane & 2;
  float keep = hi ? p1 : p0;
  const float send = hi ? p0 : p1;
  keep += __shfl_xor_sync(kAll, send, 2);
  return keep + __shfl_xor_sync(kAll, keep, 1);
}

// the sum over the warp's 8 key-pair lanes (lane bits 2-4) of the
// thread's partials of its 8 columns: the lane keeps column 4 b4 + 2 b3 +
// b2 of them
__device__ __forceinline__ float column_sum(const float (&p)[kTV], int lane) {
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
  return (b2 ? q2[1] : q2[0]) + __shfl_xor_sync(kAll, send, 4);
}

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

// The scratch (f32), with nseg segments of cps chunks each and nch = nseg
// cps: ckpt [B][H][NVB][nch][HD][kVB] the local states at the chunks'
// first tokens; pre [B][H][nch][HD] the keys' decay products from the
// segment's first token to there; sloc, gloc [B][H][NVB][nseg][HD][kVB]
// S_loc and G_loc, then (after the carry) S at the segment's start and G
// at its end; dseg [B][H][nseg][HD] D; du_part [B][NVB][nseg][H][HD].
struct Scratch {
  float *ckpt, *pre, *sloc, *gloc, *dseg, *du_part;
};

// grid (H * NVB, segments, batch); L tokens a segment
template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
wkv6_bwd_local_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ dy, Scratch x, int S, int H,
                      int L) {
  using Sh = Shape<HD>;
  __shared__ __align__(16) Stage<T, HD> st[2];
  const int h = blockIdx.x / Sh::NVB, vbi = blockIdx.x % Sh::NVB;
  const int vb = vbi * kVB, seg = blockIdx.y, nseg = gridDim.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  // keys k0, k0 + 1 (a warp's 8 key pairs by lane bits 2-4), columns c0 ..
  // c0 + 7 of the CTA's 32 (lane bits 0-1)
  const int k0 = 2 * (wp * 8 + (lane >> 2)), c0 = (lane & 3) * kTV;
  const bool lead = vbi == 0 && (lane & 3) == 0;   // writes the decays
  const long long pitch = static_cast<long long>(H) * HD;
  const long long head = static_cast<long long>(b) * H + h;
  const int cps = L / kChunk, tb = seg * L, nt = min(L, S - tb);
  const int nch = (nt + kChunk - 1) / kChunk;
  const long long row0 = (static_cast<long long>(b) * S + tb) * pitch +
                         static_cast<long long>(h) * HD;
  const long long blk = (head * Sh::NVB + vbi) * nseg + seg;
  float* ck = x.ckpt + blk * cps * (HD * kVB);
  float* pr = x.pre + (head * nseg + seg) * cps * HD;
  float* tile = x.sloc + blk * (HD * kVB);

  // the state walk from zero
  float s[kTK][kTV], d[kTK];
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    d[q] = 1.f;
#pragma unroll
    for (int c = 0; c < kTV; ++c) s[q][c] = 0.f;
  }
  stage<false>(st[0], r, k, v, w, dy, row0, pitch, vb, min(kChunk, nt));
  cp_commit();
  for (int j = 0; j < nch; ++j) {
    const int n = min(kChunk, nt - j * kChunk);
#pragma unroll
    for (int q = 0; q < kTK; ++q) {
      store8(ck + (j * HD + k0 + q) * kVB + c0, s[q]);
    }
    if (lead) {
      *reinterpret_cast<float2*>(pr + j * HD + k0) = make_float2(d[0], d[1]);
    }
    cp_wait_all();
    __syncthreads();   // stage j landed; stage j - 1 is free
    if (j + 1 < nch) {
      stage<false>(st[(j + 1) & 1], r, k, v, w, dy,
                   row0 + (j + 1) * kChunk * pitch, pitch, vb,
                   min(kChunk, nt - (j + 1) * kChunk));
      cp_commit();
    }
    const Stage<T, HD>& in = st[j & 1];
#pragma unroll 1
    for (int t = 0; t < n; ++t) {
      float vv[kTV], kk[kTK], ww[kTK];
      load8(vv, &in.v[t][c0]);
      pair(&in.k[t][k0], kk[0], kk[1]);
      pair(&in.w[t][k0], ww[0], ww[1]);
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
#pragma unroll
        for (int c = 0; c < kTV; ++c) {
          s[q][c] = __fmaf_rn(ww[q], s[q][c], kk[q] * vv[c]);
        }
        d[q] = d[q] * ww[q];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kTK; ++q) store8(tile + (k0 + q) * kVB + c0, s[q]);
  if (lead) {
    *reinterpret_cast<float2*>(x.dseg + (head * nseg + seg) * HD + k0) =
        make_float2(d[0], d[1]);
  }

  // the G walk back from zero, and du's partial
  float G[kTK][kTV], du[kTK];
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    du[q] = 0.f;
#pragma unroll
    for (int c = 0; c < kTV; ++c) G[q][c] = 0.f;
  }
  __syncthreads();   // every thread is done with the stages
  stage<true>(st[(nch - 1) & 1], r, k, v, w, dy,
              row0 + (nch - 1) * kChunk * pitch, pitch, vb,
              nt - (nch - 1) * kChunk);
  cp_commit();
  for (int j = nch - 1; j >= 0; --j) {
    const int n = min(kChunk, nt - j * kChunk);
    cp_wait_all();
    __syncthreads();
    if (j > 0) {
      stage<true>(st[(j - 1) & 1], r, k, v, w, dy,
                  row0 + (j - 1) * kChunk * pitch, pitch, vb, kChunk);
      cp_commit();
    }
    const Stage<T, HD>& in = st[j & 1];
#pragma unroll 1
    for (int t = n - 1; t >= 0; --t) {
      float vv[kTV], dd[kTV], rr[kTK], kk[kTK], ww[kTK];
      load8(vv, &in.v[t][c0]);
      load8(dd, &in.dy[t][c0]);
      pair(&in.r[t][k0], rr[0], rr[1]);
      pair(&in.k[t][k0], kk[0], kk[1]);
      pair(&in.w[t][k0], ww[0], ww[1]);
      // v . dy over the CTA's 32 columns: the thread's 8, then its row's
      // 4 lanes (the same bits in each)
      float vdy = vv[0] * dd[0];
#pragma unroll
      for (int c = 1; c < kTV; ++c) vdy = __fmaf_rn(vv[c], dd[c], vdy);
      vdy += __shfl_xor_sync(kAll, vdy, 1);
      vdy += __shfl_xor_sync(kAll, vdy, 2);
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        du[q] = __fmaf_rn(rr[q] * kk[q], vdy, du[q]);
#pragma unroll
        for (int c = 0; c < kTV; ++c) {
          G[q][c] = __fmaf_rn(ww[q], G[q][c], rr[q] * dd[c]);
        }
      }
    }
  }
  float* gt = x.gloc + blk * (HD * kVB);
#pragma unroll
  for (int q = 0; q < kTK; ++q) store8(gt + (k0 + q) * kVB + c0, G[q]);
  if ((lane & 3) == 0) {
    *reinterpret_cast<float2*>(
        x.du_part +
        (((static_cast<long long>(b) * Sh::NVB + vbi) * nseg + seg) * H + h) *
            HD + k0) = make_float2(du[0], du[1]);
  }
}

// grid (H * NVB, batch + 1): row b < batch carries batch b's states and
// gradients across its nseg segments; the last row adds du's partials
template <int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
wkv6_bwd_carry_kernel(const float* __restrict__ s0, Scratch x,
                      float* __restrict__ du, float* __restrict__ ds0, int H,
                      int nseg) {
  using Sh = Shape<HD>;
  const int h = blockIdx.x / Sh::NVB, vbi = blockIdx.x % Sh::NVB;
  const int vb = vbi * kVB, batch = gridDim.y - 1, tid = threadIdx.x;
  if (blockIdx.y == batch) {
    if (tid < kVB) {
      const int key = vb + tid;
      double acc = 0.0;
      for (int b = 0; b < batch; ++b) {
        for (int p = 0; p < Sh::NVB; ++p) {
          for (int g = 0; g < nseg; ++g) {
            acc += x.du_part[(((static_cast<long long>(b) * Sh::NVB + p) *
                                   nseg + g) * H + h) * HD + key];
          }
        }
      }
      du[h * HD + key] = static_cast<float>(acc);
    }
    return;
  }
  const int b = blockIdx.y, wp = tid >> 5, lane = tid & 31;
  const int k0 = 2 * (wp * 8 + (lane >> 2)), c0 = (lane & 3) * kTV;
  const long long head = static_cast<long long>(b) * H + h;
  const long long blk0 = (head * Sh::NVB + vbi) * nseg;
  const float* dseg = x.dseg + head * nseg * HD + k0;
  float s[kTK][kTV];
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    load8(s[q], s0 + (head * HD + k0 + q) * HD + vb + c0);
  }
  // x = D x + loc over the segments in `order`, each tile's loc replaced
  // by the x it met; the next segment's loc and D fetched a step ahead
  const auto walk = [&](float* tiles, bool up) {
    float loc[kTK][kTV], d[kTK];
    const auto fetch = [&](int g) {
      const float* p = tiles + (blk0 + g) * (HD * kVB) + k0 * kVB + c0;
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        load8(loc[q], p + q * kVB);
        d[q] = dseg[g * HD + q];
      }
    };
    if (nseg > 0) fetch(up ? 0 : nseg - 1);
    for (int i = 0; i < nseg; ++i) {
      const int g = up ? i : nseg - 1 - i;
      float l[kTK][kTV], dd[kTK];
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        dd[q] = d[q];
#pragma unroll
        for (int c = 0; c < kTV; ++c) l[q][c] = loc[q][c];
      }
      if (i + 1 < nseg) fetch(up ? g + 1 : g - 1);
      float* p = tiles + (blk0 + g) * (HD * kVB) + k0 * kVB + c0;
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        store8(p + q * kVB, s[q]);
#pragma unroll
        for (int c = 0; c < kTV; ++c) s[q][c] = __fmaf_rn(dd[q], s[q][c], l[q][c]);
      }
    }
  };
  walk(x.sloc, true);
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
#pragma unroll
    for (int c = 0; c < kTV; ++c) s[q][c] = 0.f;   // now G
  }
  walk(x.gloc, false);
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    store8(ds0 + (head * HD + k0 + q) * HD + vb + c0, s[q]);
  }
}

// grid (H * NVB, segments, batch) in clusters of NVB CTAs along x (a
// head's column blocks; the rank is the block); L tokens a segment. dr,
// dk, dw, dv (B, S, H, HD) final
template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads, 4)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dy,
                Scratch x, float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw, int S, int H,
                int L) {
  using Sh = Shape<HD>;
  constexpr int kThreads = Sh::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MainSmem<T, HD>& sm = *reinterpret_cast<MainSmem<T, HD>*>(smem_raw);
  const int h = blockIdx.x / Sh::NVB, vbi = blockIdx.x % Sh::NVB;
  const int vb = vbi * kVB, seg = blockIdx.y, nseg = gridDim.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  const int k0 = 2 * (wp * 8 + (lane >> 2)), c0 = (lane & 3) * kTV;
  const int mine = (lane >> 1) & 1;          // the key key_sum keeps
  const int key = k0 + mine;
  const bool own = k0 / kVB == vbi;          // the warp's keys are this
  const int kc = key % kVB;                  // CTA's; the key's place there
  const long long pitch = static_cast<long long>(H) * HD;
  const long long head = static_cast<long long>(b) * H + h;
  const int cps = L / kChunk, tb = seg * L, nt = min(L, S - tb);
  const int nch = (nt + kChunk - 1) / kChunk;
  const long long row0 = (static_cast<long long>(b) * S + tb) * pitch +
                         static_cast<long long>(h) * HD;
  const long long blk = (head * Sh::NVB + vbi) * nseg + seg;
  const float* ck = x.ckpt + blk * cps * (HD * kVB) + k0 * kVB + c0;
  const float* pr = x.pre + (head * nseg + seg) * cps * HD + k0;
  const float* sst = x.sloc + blk * (HD * kVB) + k0 * kVB + c0;

  // dr, dk or dw (which 0, 1, 2) of key `key` at the sub-chunk's token t
  // (the sub-chunk's parity par, its first token's row srow)
  const auto put = [&](int which, int par, int t, float val,
                       long long srow) {
    if constexpr (Sh::NVB == 1) {
      float* out = which == 0 ? dr : (which == 1 ? dk : dw);
      out[srow + t * pitch + key] = val;
    } else if (own) {
      sm.xown[which][t][kc] = val;
    } else {
      sm.xpeer[par][which][t][kc] = val;
    }
  };

  // the other CTA's exchange buffers, by chunk parity
  const float *peer0 = nullptr, *peer1 = nullptr;
  if constexpr (Sh::NVB > 1) {
    const cg::cluster_group cluster = cg::this_cluster();
    const unsigned other = static_cast<unsigned>(vbi ^ 1);
    peer0 = cluster.map_shared_rank(&sm.xpeer[0][0][0][0], other);
    peer1 = cluster.map_shared_rank(&sm.xpeer[1][0][0][0], other);
  }
  for (int i = tid; i < HD; i += kThreads) sm.u[i] = u[h * HD + i];
  float G[kTK][kTV], loc[kTK][kTV], pf[kTK];
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    load8(G[q], x.gloc + blk * (HD * kVB) + (k0 + q) * kVB + c0);
  }
  {
    const int j = nch - 1;
    stage<true>(sm.st[j & 1], r, k, v, w, dy, row0 + j * kChunk * pitch,
                pitch, vb, nt - j * kChunk);
    cp_commit();
#pragma unroll
    for (int q = 0; q < kTK; ++q) {
      load8(loc[q], ck + (j * HD + q) * kVB);
      pf[q] = pr[j * HD + q];
    }
  }
  int par = 0;   // the sub-chunk's parity: which exchange buffer
  for (int j = nch - 1; j >= 0; --j) {
    const int n = min(kChunk, nt - j * kChunk);
    const long long row = row0 + j * kChunk * pitch;
    cp_wait_all();
    __syncthreads();   // stage j landed; the last chunk's reads are done
    if (j > 0) {
      stage<true>(sm.st[(j - 1) & 1], r, k, v, w, dy, row - kChunk * pitch,
                  pitch, vb, kChunk);
      cp_commit();
    }
    const Stage<T, HD>& in = sm.st[j & 1];
    for (int t = wp; t < n; t += Sh::NW) {   // a warp a token
      float pb = 0.f;
      for (int c = lane; c < HD; c += 32) {
        pb = __fmaf_rn(f32(in.r[t][c]) * sm.u[c], f32(in.k[t][c]), pb);
      }
      pb = warp_sum(pb);
      const float pv = warp_sum(f32(in.v[t][lane]) * in.dy[t][lane]);
      if (lane == 0) {
        sm.bonus[t] = pb;
        sm.vdy[t] = pv;
      }
    }
    __syncthreads();

    // the sub-chunks from the last, each from the chunk's checkpoint
    for (int t0 = (n - 1) / kSub * kSub; t0 >= 0; t0 -= kSub, par ^= 1) {
      const int m = min(kSub, n - t0);
      const long long srow = row + t0 * pitch;
      // the checkpoint: local + prefix o S_start, walked to token t0
      float s[kTK][kTV];
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        float ss[kTV];
        load8(ss, sst + q * kVB);
#pragma unroll
        for (int c = 0; c < kTV; ++c) {
          s[q][c] = __fmaf_rn(pf[q], ss[c], loc[q][c]);
        }
      }
#pragma unroll 1
      for (int t = 0; t < t0; ++t) {
        float vv[kTV], kk[kTK], ww[kTK];
        load8(vv, &in.v[t][c0]);
        pair(&in.k[t][k0], kk[0], kk[1]);
        pair(&in.w[t][k0], ww[0], ww[1]);
#pragma unroll
        for (int q = 0; q < kTK; ++q) {
#pragma unroll
          for (int c = 0; c < kTV; ++c) {
            s[q][c] = __fmaf_rn(ww[q], s[q][c], kk[q] * vv[c]);
          }
        }
      }
      if (t0 == 0 && j > 0) {   // the next chunk's checkpoint, a chunk ahead
#pragma unroll
        for (int q = 0; q < kTK; ++q) {
          load8(loc[q], ck + ((j - 1) * HD + q) * kVB);
          pf[q] = pr[(j - 1) * HD + q];
        }
      }
      if (t0 + kSub < n) __syncthreads();   // the last sub-chunk's outputs

      // recompute S_{t-1} of the sub-chunk's tokens, and dr
#pragma unroll 1
      for (int t = 0; t < m; ++t) {
        const int ti = t0 + t;
        float vv[kTV], dd[kTV], p[kTK], kk[kTK], ww[kTK];
        load8(vv, &in.v[ti][c0]);
        load8(dd, &in.dy[ti][c0]);
        pair(&in.k[ti][k0], kk[0], kk[1]);
        pair(&in.w[ti][k0], ww[0], ww[1]);
#pragma unroll
        for (int q = 0; q < kTK; ++q) {
          p[q] = dd[0] * s[q][0];
#pragma unroll
          for (int c = 0; c < kTV; ++c) {
            sm.states[t][q * kTV + c][tid] = s[q][c];
            if (c > 0) p[q] = __fmaf_rn(dd[c], s[q][c], p[q]);
          }
        }
        const float d = key_sum(p[0], p[1], lane);
        if ((lane & 1) == 0) {
          const float km = mine ? kk[1] : kk[0];
          put(0, par, t, __fmaf_rn(sm.u[key] * km, sm.vdy[ti], d), srow);
        }
#pragma unroll
        for (int q = 0; q < kTK; ++q) {
#pragma unroll
          for (int c = 0; c < kTV; ++c) {
            s[q][c] = __fmaf_rn(ww[q], s[q][c], kk[q] * vv[c]);
          }
        }
      }

      // walk the sub-chunk back: dw, dk, dv's partials; then G_{t-1}
#pragma unroll 1
      for (int t = m - 1; t >= 0; --t) {
        const int ti = t0 + t;
        float vv[kTV], dd[kTV], rr[kTK], kk[kTK], ww[kTK];
        load8(vv, &in.v[ti][c0]);
        load8(dd, &in.dy[ti][c0]);
        pair(&in.r[ti][k0], rr[0], rr[1]);
        pair(&in.k[ti][k0], kk[0], kk[1]);
        pair(&in.w[ti][k0], ww[0], ww[1]);
        const float vdy = sm.vdy[ti];
        float pw[kTK], pk[kTK], pv[kTV];
#pragma unroll
        for (int q = 0; q < kTK; ++q) {
          pw[q] = G[q][0] * sm.states[t][q * kTV][tid];
          pk[q] = G[q][0] * vv[0];
#pragma unroll
          for (int c = 1; c < kTV; ++c) {
            pw[q] = __fmaf_rn(G[q][c], sm.states[t][q * kTV + c][tid],
                              pw[q]);
            pk[q] = __fmaf_rn(G[q][c], vv[c], pk[q]);
          }
        }
#pragma unroll
        for (int c = 0; c < kTV; ++c) {
          pv[c] = __fmaf_rn(G[1][c], kk[1], G[0][c] * kk[0]);
        }
        const float dwv = key_sum(pw[0], pw[1], lane);
        const float dkv = key_sum(pk[0], pk[1], lane);
        const float col = column_sum(pv, lane);
        sm.dvpart[t][wp][c0 + ((lane >> 2) & 7)] = col;
        if ((lane & 1) == 0) {
          const float rm = mine ? rr[1] : rr[0];
          put(2, par, t, dwv, srow);
          put(1, par, t, __fmaf_rn(sm.u[key] * rm, vdy, dkv), srow);
        }
#pragma unroll
        for (int q = 0; q < kTK; ++q) {
#pragma unroll
          for (int c = 0; c < kTV; ++c) {
            G[q][c] = __fmaf_rn(ww[q], G[q][c], rr[q] * dd[c]);
          }
        }
      }
      __syncthreads();   // dv's partials
      if constexpr (Sh::NVB > 1) cluster_arrive();   // dr, dk, dw's shares
      // each thread a fixed (token, column) of the sub-chunk's outputs
#pragma unroll
      for (int i = tid; i < kSub * kVB; i += kThreads) {
        const int t = i / kVB, c = i % kVB;
        if (t < m) {
          float p[Sh::NW];
#pragma unroll
          for (int e = 0; e < Sh::NW; ++e) p[e] = sm.dvpart[t][e][c];
          dv[srow + t * pitch + vb + c] = __fmaf_rn(
              in.dy[t0 + t][c], sm.bonus[t0 + t], tree_sum<Sh::NW>(p));
        }
      }
      if constexpr (Sh::NVB > 1) {
        cluster_wait();
        const float* pe = par ? peer1 : peer0;
#pragma unroll
        for (int i = tid; i < kSub * kVB; i += kThreads) {
          const int t = i / kVB, c = i % kVB;
          if (t < m) {
            // one f32 add (it commutes: both CTAs' sums are the same bits)
            const long long o = srow + t * pitch + vb + c;
            dr[o] = sm.xown[0][t][c] + pe[i];
            dk[o] = sm.xown[1][t][c] + pe[kSub * kVB + i];
            dw[o] = sm.xown[2][t][c] + pe[2 * kSub * kVB + i];
          }
        }
      }
    }
  }
  if constexpr (Sh::NVB > 1) {   // the peer is done reading this CTA
    cluster_arrive();
    cluster_wait();
  }
}

template <typename T, int HD>
struct Kernels {
  static constexpr int kThreads = Shape<HD>::kThreads;
  static constexpr int kSmem = static_cast<int>(sizeof(MainSmem<T, HD>));
  // by device: resident CTAs an SM of the main, local and carry kernels,
  // and the card's SMs, from the occupancy calculator
  static int occ[kMaxDevices][4];
  static std::atomic<bool> ready[kMaxDevices];

  // Sets the main kernel's shared-memory limit and carveout on the current
  // device and fills its occ row, once per device (function attributes
  // are per device); `row` is then that device's occ row.
  static int prepare(const int*& row) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) {
      return static_cast<int>(cudaErrorInvalidDevice);
    }
    row = occ[dev];
    if (ready[dev].load(std::memory_order_acquire)) return 0;
    const auto kern = wkv6_bwd_kernel<T, HD>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    }
    int o[4] = {0, 0, 0, 0};
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kern,
                                                          kThreads, kSmem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o[1], wkv6_bwd_local_kernel<T, HD>, kThreads, 0);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o[2], wkv6_bwd_carry_kernel<HD>, kThreads, 0);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&o[3], cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (o[0] <= 0 || o[3] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < 4; ++i) occ[dev][i] = o[i];
    ready[dev].store(true, std::memory_order_release);
    return 0;
  }

  // out: L (tokens a segment), nseg, the three kernels' resident CTAs an
  // SM, the SMs. The segments: the count n that needs the fewest chunk
  // steps a resident slot (waves of the main kernel times chunks a CTA),
  // of those the most up to kMaxWaves waves, each at least kMinSeg tokens
  static int plan(int batch, int S, int H, int* out) {
    const int* res = nullptr;
    const int err = prepare(res);
    if (err != 0) return err;
    const int chunks = (S + kChunk - 1) / kChunk;
    int L = kChunk, nseg = 0;
    if (chunks > 0) {
      const long long slots = static_cast<long long>(res[0]) * res[3];
      const long long base = static_cast<long long>(batch) * H *
                             Shape<HD>::NVB;
      const int most = (S + kMinSeg - 1) / kMinSeg;
      int best = 1;
      long long best_cost = LLONG_MAX;
      for (int n = 1; n <= most; ++n) {
        const long long waves = (base * n + slots - 1) / slots;
        if (n > 1 && waves > kMaxWaves) break;
        const long long cost = waves * ((chunks + n - 1) / n);
        if (cost <= best_cost) {
          best_cost = cost;
          best = n;
        }
      }
      const int cps = (chunks + best - 1) / best;
      L = cps * kChunk;
      nseg = (chunks + cps - 1) / cps;
    }
    out[0] = L;
    out[1] = nseg;
    for (int i = 0; i < 4; ++i) out[2 + i] = res[i];
    return 0;
  }

  static int launch(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s0,
                    const void* dy, Scratch x, void* dr, void* dk, void* dv,
                    void* dw, void* du, void* ds0, int batch, int S, int H,
                    cudaStream_t st) {
    int p[6];
    int err = plan(batch, S, H, p);
    if (err != 0) return err;
    const int L = p[0], nseg = p[1];
    const dim3 grid(H * Shape<HD>::NVB, nseg, batch);
    if (nseg > 0) {
      wkv6_bwd_local_kernel<T, HD><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(w),
          static_cast<const float*>(dy), x, S, H, L);
      err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
    }
    wkv6_bwd_carry_kernel<HD><<<dim3(H * Shape<HD>::NVB, batch + 1),
                                kThreads, 0, st>>>(
        static_cast<const float*>(s0), x, static_cast<float*>(du),
        static_cast<float*>(ds0), H, nseg);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0 || nseg == 0) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Shape<HD>::NVB;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = Shape<HD>::NVB > 1 ? 1 : 0;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, wkv6_bwd_kernel<T, HD>, static_cast<const T*>(r),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(dy), x, static_cast<float*>(dr),
        static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<float*>(dw), S, H, L));
  }
};

template <typename T, int HD>
int Kernels<T, HD>::occ[kMaxDevices][4] = {};
template <typename T, int HD>
std::atomic<bool> Kernels<T, HD>::ready[kMaxDevices];

// Kernels<T, hd>::f(args...) for a runtime dtype and hd
template <typename F>
int dispatch(int dtype, int hd, F f) {
  if (dtype == 0 && hd == 32) return f(Kernels<float, 32>{});
  if (dtype == 0 && hd == 64) return f(Kernels<float, 64>{});
  if (dtype == 1 && hd == 32) return f(Kernels<__nv_bfloat16, 32>{});
  if (dtype == 1 && hd == 64) return f(Kernels<__nv_bfloat16, 64>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The checkpoint interval (the wrapper sizes the scratch with it).
extern "C" int wkv6_bwd_chunk() { return kChunk; }

// The launch's plan for a shape (dtype 0 f32, 1 bf16): out[0] the tokens
// a segment (a multiple of the chunk), out[1] the segments (0 when S is
// 0), out[2..4] the resident CTAs an SM of the main, local and carry
// kernels, out[5] the card's SMs. Returns a cudaError_t, or 0.
extern "C" int wkv6_bwd_plan(int dtype, int batch, int S, int H, int hd,
                             int* out) {
  if (batch <= 0 || H <= 0 || S < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(dtype, hd, [&](auto kern) {
    return decltype(kern)::plan(batch, S, H, out);
  });
}

// r, k, v: (batch, S, H, hd) in the activation type (dtype 0 f32, 1 bf16);
// w: (batch, S, H, hd) f32; u: (H, hd) f32; s0: (batch, H, hd, hd) f32;
// dy: (batch, S, H, hd) f32, the gradient of y. Scratch, f32, with the
// plan's nseg segments of L tokens, nch = nseg L / 8 chunks and NVB = hd /
// 32: ckpt (batch, H, NVB, nch, hd, 32); pre (batch, H, nch, hd); sloc,
// gloc (batch, H, NVB, nseg, hd, 32); dseg (batch, H, nseg, hd); du_part
// (batch, NVB, nseg, H, hd). Outputs, f32: dr, dk, dv, dw (batch, S, H,
// hd), du (H, hd), ds0 (batch, H, hd, hd). All contiguous, each base
// 16-byte aligned; hd is 32 or 64. Three launches on `stream` (local,
// carry, main; only the carry when S is 0); returns the first failing
// cudaError_t, or 0.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dy, void* ckpt, void* pre,
                               void* sloc, void* gloc, void* dseg,
                               void* du_part, void* dr, void* dk, void* dv,
                               void* dw, void* du, void* ds0, int dtype,
                               int batch, int S, int H, int hd,
                               void* stream) {
  if (batch <= 0 || H <= 0 || S < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scratch x{static_cast<float*>(ckpt), static_cast<float*>(pre),
                  static_cast<float*>(sloc), static_cast<float*>(gloc),
                  static_cast<float*>(dseg), static_cast<float*>(du_part)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, hd, [&](auto kern) {
    return decltype(kern)::launch(r, k, v, w, u, s0, dy, x, dr, dk, dv, dw,
                                  du, ds0, batch, S, H, st);
  });
}
