// Flat (brute-force) exact kNN for the port's flat route.
//
// Replaces: src/repro/kernels/knn/kernel.py:knn_pallas (body _knn_kernel),
// the TPU kernel that tiles |q|^2 - 2 q.p + |p|^2 through the MXU and keeps
// a running top-k in VMEM scratch.
//
// What bounds it on an H100: with D <= 3 there is no matrix product worth
// a tensor core; each (query, point) pair costs D subtractions, D
// multiplies and D-1 adds in fp32 plus a compare, so the kernel is bound by
// fp32 issue on the CUDA cores (and, per point, by one shared-memory read
// per thread). The bytes it must move (Q*D + N*D floats, N flags, Q*k
// outputs) are tiny next to the Q*N pair work.
//
// What the design does about it: one thread per query keeps its query in
// registers and its running top-k in shared memory; a block stages tiles of
// points through shared memory once and every thread of the block scans
// them, so each point is read from device memory once per block. A
// candidate costs one compare against the thread's k-th best in a register
// and only the rare winner pays the insertion. Distances are the direct
// sum over d = 0..D-1 of (q_d - p_d)^2 with explicit round-to-nearest
// intrinsics (and -fmad=false), so the result equals the plain PyTorch
// version bit for bit. Ties keep the reference's lax.top_k order: a
// candidate enters only when strictly below the current k-th entry and is
// placed after entries of equal distance, and points are scanned in index
// order.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kTile = 256;

template <int D>
__device__ __forceinline__ float direct_d2(const float* q, const float* p) {
  float acc = __fmul_rn(__fsub_rn(q[0], p[0]), __fsub_rn(q[0], p[0]));
#pragma unroll
  for (int d = 1; d < D; ++d) {
    const float df = __fsub_rn(q[d], p[d]);
    acc = __fadd_rn(acc, __fmul_rn(df, df));
  }
  return acc;
}

// Insert (d, id) into the thread's ascending list (column t of [k][T]),
// after every entry <= d; the last entry falls off.
__device__ __forceinline__ void insert_sorted(float* bd, int* bi, int T,
                                              int t, int k, float d,
                                              int id) {
  int pos = k - 1;
  while (pos > 0) {
    const float prev = bd[(pos - 1) * T + t];
    if (prev <= d) break;
    bd[pos * T + t] = prev;
    bi[pos * T + t] = bi[(pos - 1) * T + t];
    --pos;
  }
  bd[pos * T + t] = d;
  bi[pos * T + t] = id;
}

template <int D>
__global__ void knn_flat_kernel(const float* __restrict__ q,
                                const float* __restrict__ p,
                                const unsigned char* __restrict__ ok,
                                int Q, int N, int k,
                                float* __restrict__ out_d,
                                int* __restrict__ out_i) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  float* bd = reinterpret_cast<float*>(smem);
  int* bi = reinterpret_cast<int*>(bd + k * T);
  float* tp = reinterpret_cast<float*>(bi + k * T);
  unsigned char* tok = reinterpret_cast<unsigned char*>(tp + kTile * D);

  const long long qi = static_cast<long long>(blockIdx.x) * T + t;
  const bool live = qi < Q;
  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = live ? q[qi * D + d] : 0.f;
  for (int j = 0; j < k; ++j) {
    bd[j * T + t] = kBig;
    bi[j * T + t] = -1;
  }
  float kth = kBig;

  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    __syncthreads();  // the previous tile is consumed
    for (int o = t; o < n; o += T) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        tp[o * D + d] = p[static_cast<long long>(base + o) * D + d];
      tok[o] = ok[base + o];
    }
    __syncthreads();
    if (!live) continue;
    for (int o = 0; o < n; ++o) {
      if (!tok[o]) continue;
      const float d2 = direct_d2<D>(qv, tp + o * D);
      if (d2 < kth) {
        insert_sorted(bd, bi, T, t, k, d2, base + o);
        kth = bd[(k - 1) * T + t];
      }
    }
  }
  if (!live) return;
  for (int j = 0; j < k; ++j) {
    const float d = bd[j * T + t];
    out_d[qi * k + j] = d;
    out_i[qi * k + j] = d >= kBig ? -1 : bi[j * T + t];
  }
}

template <int D>
int launch(const float* q, const float* p, const unsigned char* ok, int Q,
           int N, int k, float* out_d, int* out_i, cudaStream_t stream) {
  const int T = k <= 32 ? 128 : 32;
  const size_t smem = static_cast<size_t>(2) * k * T * 4 +
                      static_cast<size_t>(kTile) * D * 4 + kTile;
  const int blocks = (Q + T - 1) / T;
  if (blocks > 0)
    knn_flat_kernel<D><<<blocks, T, smem, stream>>>(q, p, ok, Q, N, k,
                                                    out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries (Q, D) f32, points (N, D) f32, ok (N,) bool as bytes, all
// contiguous on the device; writes d2 (Q, k) ascending and ids (Q, k),
// -1 where fewer than k points are valid. Returns cudaGetLastError().
extern "C" int knn_flat_launch(const float* q, const float* p,
                               const unsigned char* ok, int Q, int N, int D,
                               int k, float* out_d, int* out_i,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return launch<1>(q, p, ok, Q, N, k, out_d, out_i, s);
    case 2: return launch<2>(q, p, ok, Q, N, k, out_d, out_i, s);
    case 3: return launch<3>(q, p, ok, Q, N, k, out_d, out_i, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
