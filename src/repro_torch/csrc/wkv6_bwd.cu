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
// token at a time).
//
// The backward needs S_{t-1} while it walks G from the last token down.
// Dividing S_t - k_t v_t by w_t would rebuild it, but decays reach 0 in
// f32, so states are recomputed from checkpoints instead:
//  - pass 1 runs the state recurrence forward from state0 (k, v, w only)
//    and writes the state at every kChunk-th (4th) token to a scratch
//    buffer (the CTA's 32 columns: 8 KB at hd 64); the forward kernel
//    stays as it is and nothing is held between the forward and the
//    backward;
//  - pass 2 takes the chunks from the last: it reloads the chunk's
//    checkpoint, recomputes the chunk's kChunk states into shared memory
//    (each thread its own tile, so no barrier between writer and reader)
//    while it forms dr, then walks the chunk backwards with G in
//    registers.
// In both passes a chunk's inputs (and in pass 2 the next checkpoint)
// are fetched into registers while the last chunk computes, then put in
// shared memory, so the loads' latency hides behind a chunk's work.
// The state's columns evolve independently in S and in G, so a CTA takes
// a (batch, head) and 32 of its hd columns, as the forward does: dv and
// dstate0 are complete inside it; dr, dk and dw are sums over the head's
// column blocks and du over (batch, column block, token), so the CTA
// writes its partials and a second kernel (wkv6_bwd_reduce_kernel) adds
// them in a fixed order, in f64, rounding once. No atomics: two calls on
// the same inputs give the same bits.
//
// A thread holds 2 keys by 8 columns of S and of G (a warp: 16 keys by
// 32 columns). The sums over columns (dr, dk, dw) are the thread's 8
// FMAs and two shuffles over the row's 4 column-group lanes, each lane
// keeping one of its two keys; the sum over keys (dv) is the thread's 2
// FMAs and three shuffles over the warp's 8 key-pair lanes, each lane
// keeping one of its 8 columns, then the warps' sums through shared
// memory ((W0 + W1) + (W2 + W3) at hd 64).
//
// What bounds it on an H100: FP32 instruction slots. A (token, key,
// value) triple costs pass 1's state update (the product k v and an FMA),
// pass 2's recompute of it and the FMA of dr, then the walk's FMAs of dw,
// dk and dv and G's update (a product and an FMA): 10 instructions, 14
// operations of the function's least (an FMA counted as 2). At rwkv6-3b's
// training shape (4 x 2,048 tokens, 40 heads of 64) that is 1.34e9
// triples, 1.34e10 instructions: ~0.4 ms at 128 lanes a clock on 132 SMs
// at 1.98 GHz. The checkpoints add 1.34 GB of writes and as many reads.
// A CTA holds kChunk states of its tile in shared memory (32 KB at hd 64,
// ~38 KB in all) at 95 registers: 5 CTAs of 4 warps an SM, so the loop
// is latency-bound first. Throwaway builds timed in one call on the card
// (random inputs of that shape, device-bound): kChunk 8 with each chunk
// loaded between barriers 5.22 ms (2 CTAs an SM), kChunk 4 4.35, with the
// register prefetch 3.65.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 4;   // tokens between pass 1's checkpoints
constexpr int kVB = 32;     // state columns a CTA
constexpr int kTK = 2;      // keys a thread
constexpr int kTV = 8;      // columns a thread
constexpr int kTile = kTK * kTV;
constexpr unsigned kAll = 0xffffffffu;

template <int HD>
struct Shape {
  static constexpr int kThreads = HD / kTK * (kVB / kTV);  // 128 at hd 64
  static constexpr int NW = kThreads / 32;                 // 16 keys each
  static constexpr int NVB = HD / kVB;                     // CTAs a head
};

template <int HD>
struct __align__(16) Smem {
  float r[kChunk][HD], k[kChunk][HD], w[kChunk][HD];
  float v[kChunk][kVB], dy[kChunk][kVB];   // the CTA's columns
  float u[HD];
  float bonus[kChunk];                     // sum_k r u k
  float vdy[kChunk];     // the sum over the CTA's columns of v dy
  float dvpart[kChunk][Shape<HD>::NW][kVB];
  // S_{t-1} of the chunk's tokens, [token][tile element][thread]
  float states[kChunk][kTile][Shape<HD>::kThreads];
};

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// a thread's share of a chunk's inputs, fetched into registers while the
// last chunk computes, then put in shared memory
template <int HD>
struct Chunk {
  static constexpr int NK = kChunk * HD / Shape<HD>::kThreads;
  static constexpr int NV = kChunk * kVB / Shape<HD>::kThreads;
  float r[NK], k[NK], w[NK], v[NV], dy[NV];
};

// tokens [t0, t0 + n) of k and w (all keys) and v (the CTA's columns),
// with kAll r and dy as well (0 past token n); `row` is the element
// offset of (b, t0, h, 0), `pitch` = H * HD
template <bool kAll, typename T, int HD>
__device__ __forceinline__ void fetch(Chunk<HD>& c, const T* r, const T* k,
                                      const T* v, const float* w,
                                      const float* dy, long long row,
                                      long long pitch, int vb, int n) {
  constexpr int kThreads = Shape<HD>::kThreads;
#pragma unroll
  for (int j = 0; j < Chunk<HD>::NK; ++j) {
    const int i = threadIdx.x + j * kThreads, t = i / HD, col = i % HD;
    const long long off = row + t * pitch + col;
    const bool in = t < n;
    c.k[j] = in ? load1(k + off) : 0.f;
    c.w[j] = in ? w[off] : 0.f;
    if (kAll) c.r[j] = in ? load1(r + off) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < Chunk<HD>::NV; ++j) {
    const int i = threadIdx.x + j * kThreads, t = i / kVB, col = i % kVB;
    const long long off = row + t * pitch + vb + col;
    const bool in = t < n;
    c.v[j] = in ? load1(v + off) : 0.f;
    if (kAll) c.dy[j] = in ? dy[off] : 0.f;
  }
}

template <bool kAll, int HD>
__device__ __forceinline__ void put(Smem<HD>& sm, const Chunk<HD>& c) {
  constexpr int kThreads = Shape<HD>::kThreads;
#pragma unroll
  for (int j = 0; j < Chunk<HD>::NK; ++j) {
    const int i = threadIdx.x + j * kThreads, t = i / HD, col = i % HD;
    sm.k[t][col] = c.k[j];
    sm.w[t][col] = c.w[j];
    if (kAll) sm.r[t][col] = c.r[j];
  }
#pragma unroll
  for (int j = 0; j < Chunk<HD>::NV; ++j) {
    const int i = threadIdx.x + j * kThreads, t = i / kVB, col = i % kVB;
    sm.v[t][col] = c.v[j];
    if (kAll) sm.dy[t][col] = c.dy[j];
  }
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

__device__ __forceinline__ void load8(float* d, const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* d) {
  *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(d[4], d[5], d[6], d[7]);
}

// partials: dr, dk, dw [NVB][B][S][H][HD]; du [B][NVB][H][HD]; dv
// (B, S, H, HD) and ds0 (B, H, HD, HD) final; ckpt [B][H][NVB][chunks]
// [HD][kVB]
template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, float* __restrict__ ckpt,
                float* __restrict__ dr_part, float* __restrict__ dk_part,
                float* __restrict__ dw_part, float* __restrict__ du_part,
                float* __restrict__ dv, float* __restrict__ ds0, int S,
                int H) {
  using Sh = Shape<HD>;
  constexpr int kThreads = Sh::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int h = blockIdx.x / Sh::NVB, vbi = blockIdx.x % Sh::NVB;
  const int vb = vbi * kVB, b = blockIdx.y, B = gridDim.y;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  // keys k0, k0 + 1 (a warp's 8 key pairs by lane bits 2-4), columns c0 ..
  // c0 + 7 of the CTA's 32 (lane bits 0-1)
  const int k0 = 2 * (wp * 8 + (lane >> 2)), c0 = (lane & 3) * kTV;
  const int mine = (lane >> 1) & 1;          // the key key_sum keeps
  const long long pitch = static_cast<long long>(H) * HD;
  const long long head = static_cast<long long>(b) * H + h;
  const long long row0 = static_cast<long long>(b) * S * pitch +
                         static_cast<long long>(h) * HD;
  const long long part = static_cast<long long>(B) * S * pitch;  // a block
  const int chunks = (S + kChunk - 1) / kChunk;
  float* ck = ckpt + (head * Sh::NVB + vbi) * chunks * (HD * kVB);

  for (int i = tid; i < HD; i += kThreads) sm.u[i] = u[h * HD + i];
  float s[kTK][kTV];
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    load8(s[q], s0 + (head * HD + k0 + q) * HD + vb + c0);
  }

  // pass 1: the states at the chunks' first tokens
  Chunk<HD> in;
  fetch<false>(in, r, k, v, w, dy, row0, pitch, vb, min(kChunk, S));
  for (int j = 0; j < chunks; ++j) {
    const int t0 = j * kChunk, n = min(kChunk, S - t0);
#pragma unroll
    for (int q = 0; q < kTK; ++q) {
      store8(ck + (j * HD + k0 + q) * kVB + c0, s[q]);
    }
    __syncthreads();   // the last chunk's reads are done
    put<false>(sm, in);
    __syncthreads();
    if (j + 1 < chunks) {
      fetch<false>(in, r, k, v, w, dy, row0 + (t0 + kChunk) * pitch, pitch,
                   vb, min(kChunk, S - t0 - kChunk));
    }
    for (int t = 0; t < n; ++t) {
      float vv[kTV];
      load8(vv, &sm.v[t][c0]);
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        const float kk = sm.k[t][k0 + q], ww = sm.w[t][k0 + q];
#pragma unroll
        for (int c = 0; c < kTV; ++c) {
          s[q][c] = __fmaf_rn(ww, s[q][c], kk * vv[c]);
        }
      }
    }
  }

  // pass 2: the chunks from the last, each recomputed, then walked back
  float G[kTK][kTV], du_acc[kTK];
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    du_acc[q] = 0.f;
#pragma unroll
    for (int c = 0; c < kTV; ++c) G[q][c] = 0.f;
  }
  float nxt[kTK][kTV];   // the next chunk's checkpoint
  if (chunks > 0) {
    const int j = chunks - 1;
    fetch<true>(in, r, k, v, w, dy, row0 + j * kChunk * pitch, pitch, vb,
                S - j * kChunk);
#pragma unroll
    for (int q = 0; q < kTK; ++q) {
      load8(nxt[q], ck + (j * HD + k0 + q) * kVB + c0);
    }
  }
  for (int j = chunks - 1; j >= 0; --j) {
    const int t0 = j * kChunk, n = min(kChunk, S - t0);
    const long long row = row0 + t0 * pitch;
    __syncthreads();   // the last chunk's reads are done
    put<true>(sm, in);
#pragma unroll
    for (int q = 0; q < kTK; ++q) {
#pragma unroll
      for (int c = 0; c < kTV; ++c) s[q][c] = nxt[q][c];
    }
    __syncthreads();
    if (j > 0) {
      fetch<true>(in, r, k, v, w, dy, row - kChunk * pitch, pitch, vb,
                  kChunk);
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        load8(nxt[q], ck + ((j - 1) * HD + k0 + q) * kVB + c0);
      }
    }
    for (int t = wp; t < n; t += Sh::NW) {   // a warp a token
      float pb = 0.f;
      for (int c = lane; c < HD; c += 32) {
        pb = __fmaf_rn(sm.r[t][c] * sm.u[c], sm.k[t][c], pb);
      }
      pb = warp_sum(pb);
      const float pv = warp_sum(sm.v[t][lane] * sm.dy[t][lane]);
      if (lane == 0) {
        sm.bonus[t] = pb;
        sm.vdy[t] = pv;
      }
    }
    __syncthreads();

    // recompute S_{t-1} of the chunk's tokens, and dr
    for (int t = 0; t < n; ++t) {
      float vv[kTV], dd[kTV], p[kTK];
      load8(vv, &sm.v[t][c0]);
      load8(dd, &sm.dy[t][c0]);
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
        const int key = k0 + mine;
        dr_part[vbi * part + row + t * pitch + key] =
            __fmaf_rn(sm.u[key] * sm.k[t][key], sm.vdy[t], d);
      }
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        const float kk = sm.k[t][k0 + q], ww = sm.w[t][k0 + q];
#pragma unroll
        for (int c = 0; c < kTV; ++c) {
          s[q][c] = __fmaf_rn(ww, s[q][c], kk * vv[c]);
        }
      }
    }

    // walk the chunk back: dw, dk, dv's partials, du; then G_{t-1}
    for (int t = n - 1; t >= 0; --t) {
      float vv[kTV], dd[kTV], rr[kTK], kk[kTK], ww[kTK];
      load8(vv, &sm.v[t][c0]);
      load8(dd, &sm.dy[t][c0]);
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        rr[q] = sm.r[t][k0 + q];
        kk[q] = sm.k[t][k0 + q];
        ww[q] = sm.w[t][k0 + q];
      }
      const float vdy = sm.vdy[t];
      float pw[kTK], pk[kTK], pv[kTV];
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        pw[q] = G[q][0] * sm.states[t][q * kTV][tid];
        pk[q] = G[q][0] * vv[0];
#pragma unroll
        for (int c = 1; c < kTV; ++c) {
          pw[q] = __fmaf_rn(G[q][c], sm.states[t][q * kTV + c][tid], pw[q]);
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
        const long long off = row + t * pitch + k0 + mine;
        dw_part[vbi * part + off] = dwv;
        dk_part[vbi * part + off] =
            __fmaf_rn(sm.u[k0 + mine] * rr[mine], vdy, dkv);
      }
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        du_acc[q] = __fmaf_rn(rr[q] * kk[q], vdy, du_acc[q]);
#pragma unroll
        for (int c = 0; c < kTV; ++c) {
          G[q][c] = __fmaf_rn(ww[q], G[q][c], rr[q] * dd[c]);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < n * kVB; i += kThreads) {
      const int t = i / kVB, c = i % kVB;
      float p[Sh::NW];
#pragma unroll
      for (int x = 0; x < Sh::NW; ++x) p[x] = sm.dvpart[t][x][c];
      dv[row + t * pitch + vb + c] =
          __fmaf_rn(sm.dy[t][c], sm.bonus[t], tree_sum<Sh::NW>(p));
    }
  }
#pragma unroll
  for (int q = 0; q < kTK; ++q) {
    store8(ds0 + (head * HD + k0 + q) * HD + vb + c0, G[q]);
    if ((lane & 3) == 0) {
      du_part[((static_cast<long long>(b) * Sh::NVB + vbi) * H + h) * HD +
              k0 + q] = du_acc[q];
    }
  }
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
__global__ void wkv6_bwd_reduce_kernel(Jobs jobs) {
  const Job jb = jobs.job[blockIdx.y];
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < jb.n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    double acc = 0.0;
    for (int p = 0; p < jb.parts; ++p) acc += jb.part[p * jb.n + i];
    jb.out[i] = static_cast<float>(acc);
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dy, void* ckpt,
           void* dr_part, void* dk_part, void* dw_part, void* du_part,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
           int batch, int S, int H, cudaStream_t st) {
  using Sh = Shape<HD>;
  const auto kernel = wkv6_bwd_kernel<T, HD>;
  const int bytes = static_cast<int>(sizeof(Smem<HD>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H * Sh::NVB, batch), Sh::kThreads, bytes, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const float*>(dy), static_cast<float*>(ckpt),
      static_cast<float*>(dr_part), static_cast<float*>(dk_part),
      static_cast<float*>(dw_part), static_cast<float*>(du_part),
      static_cast<float*>(dv), static_cast<float*>(ds0), S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(batch) * S * H * HD;
  Jobs jobs{};
  jobs.job[0] = {static_cast<const float*>(dr_part), static_cast<float*>(dr),
                 n, Sh::NVB};
  jobs.job[1] = {static_cast<const float*>(dk_part), static_cast<float*>(dk),
                 n, Sh::NVB};
  jobs.job[2] = {static_cast<const float*>(dw_part), static_cast<float*>(dw),
                 n, Sh::NVB};
  jobs.job[3] = {static_cast<const float*>(du_part), static_cast<float*>(du),
                 static_cast<long long>(H) * HD, batch * Sh::NVB};
  const long long blocks = (n + 255) / 256;
  const int gx = static_cast<int>(blocks < 1056 ? (blocks > 0 ? blocks : 1)
                                                : 1056);
  wkv6_bwd_reduce_kernel<<<dim3(gx, 4), 256, 0, st>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* r, const void* k, const void* v,
              const void* w, const void* u, const void* s0, const void* dy,
              void* ckpt, void* dr_part, void* dk_part, void* dw_part,
              void* du_part, void* dr, void* dk, void* dv, void* dw,
              void* du, void* ds0, int batch, int S, int H, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, dy, ckpt, dr_part, dk_part,
                           dw_part, du_part, dr, dk, dv, dw, du, ds0, batch,
                           S, H, st);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, dy, ckpt, dr_part, dk_part,
                           dw_part, du_part, dr, dk, dv, dw, du, ds0, batch,
                           S, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The checkpoint interval (the wrapper sizes the scratch with it).
extern "C" int wkv6_bwd_chunk() { return kChunk; }

// r, k, v: (batch, S, H, hd) in the activation type (dtype 0 f32, 1 bf16);
// w: (batch, S, H, hd) f32; u: (H, hd) f32; s0: (batch, H, hd, hd) f32;
// dy: (batch, S, H, hd) f32, the gradient of y. Scratch, f32: ckpt
// (batch, H, ceil(S / kChunk), hd, hd); dr_part, dk_part, dw_part
// (hd / 32, batch, S, H, hd); du_part (batch, hd / 32, H, hd). Outputs,
// f32: dr, dk, dv, dw (batch, S, H, hd), du (H, hd), ds0 (batch, H, hd,
// hd). All contiguous, each base 16-byte aligned; hd is 32 or 64. Two
// launches on `stream` (the backward, then the partials' reduction);
// returns the first failing cudaError_t, or 0.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dy, void* ckpt, void* dr_part,
                               void* dk_part, void* dw_part, void* du_part,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du, void* ds0, int dtype, int batch,
                               int S, int H, int hd, void* stream) {
  if (batch <= 0 || H <= 0 || S < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_hd<float>(hd, r, k, v, w, u, s0, dy, ckpt, dr_part,
                            dk_part, dw_part, du_part, dr, dk, dv, dw, du,
                            ds0, batch, S, H, st);
  }
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s0, dy, ckpt, dr_part,
                                    dk_part, dw_part, du_part, dr, dk, dv,
                                    dw, du, ds0, batch, S, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
