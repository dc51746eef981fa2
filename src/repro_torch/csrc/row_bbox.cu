// Masked per-row bounding boxes of the leaf rows: lo/hi over the valid
// slots of each row of an (R, C, D) point array.
//
// Replaces: src/repro/kernels/bbox/kernel.py:row_bbox_pallas (body
// _bbox_kernel), the TPU kernel that tiles rows into VMEM and reduces the
// slot axis with masked min/max. It computes what the reference's core
// path computes, src/repro/core/leafstore.py:row_bbox_from_slots: the
// result keeps the points' own type (int32 or float32), and a row with no
// valid slot gets (+max, -max) of that type. (The TPU kernel casts to
// float32 with a 3.4e38 sentinel; the core path never called it.) NaN
// coordinates are outside the contract.
//
// What bounds it on an H100: bytes. Every slot's flag is read (R * C
// bytes), the coordinates of the valid slots only (4 * D bytes each), and
// the output is 2 * R * D words; the compares are negligible. Most rows of
// a tree are sparse or empty (a P-Orth tree over uniform points holds one
// or two points a row), so the flags dominate. The design reads them as
// 16-byte vectors: a row's C flags are split into 16-slot segments, G
// lanes of a warp share a row (G the power of two at or above C / 16, at
// most 32), and a lane loads a segment's flags with one load, then the
// coordinates of its valid slots only. The G lanes of a row reduce their
// running min and max with shuffles. With C = 64, a warp covers 8 rows and
// reads their 512 flag bytes in one coalesced load. Rows whose C is not a
// multiple of 16, or flags that are not 16-byte aligned, take byte loads
// instead.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 16;   // slots per flag segment: one 16-byte load

__device__ __forceinline__ int type_max(int) { return INT_MAX; }
__device__ __forceinline__ float type_max(float) { return FLT_MAX; }

template <typename T>
__device__ __forceinline__ T lesser(T a, T b) { return b < a ? b : a; }

template <typename T>
__device__ __forceinline__ T greater(T a, T b) { return b > a ? b : a; }

// The 16 flags of slots [s0, s0 + 16) of a row, one byte each, as four
// words (slots past C read as 0).
template <bool kVec>
__device__ __forceinline__ void load_flags(const unsigned char* rv, int s0,
                                           int C, unsigned (&w)[4]) {
  if (kVec) {
    const uint4 f = *reinterpret_cast<const uint4*>(rv + s0);
    w[0] = f.x;
    w[1] = f.y;
    w[2] = f.z;
    w[3] = f.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int s = s0 + 4 * q + b;
      if (s < C && rv[s]) word |= 1u << (8 * b);
    }
    w[q] = word;
  }
}

template <typename T, int D, bool kVec>
__global__ void row_bbox_kernel(const T* __restrict__ p,
                                const unsigned char* __restrict__ valid,
                                long long R, int C, int G,
                                T* __restrict__ lo, T* __restrict__ hi) {
  const int lane = threadIdx.x % 32;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const long long row = warp * (32 / G) + lane / G;
  const int sub = lane % G;
  const T big = type_max(T());
  T mn[D], mx[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    mn[d] = big;
    mx[d] = -big;
  }
  if (row < R) {
    const T* rp = p + row * C * D;
    const unsigned char* rv = valid + row * C;
    for (int s0 = sub * kSeg; s0 < C; s0 += G * kSeg) {
      unsigned w[4];
      load_flags<kVec>(rv, s0, C, w);
      if ((w[0] | w[1] | w[2] | w[3]) == 0) continue;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        if (!((w[j / 4] >> (8 * (j % 4))) & 0xffu)) continue;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const T v = rp[(s0 + j) * D + d];
          mn[d] = lesser(mn[d], v);
          mx[d] = greater(mx[d], v);
        }
      }
    }
  }
  // the G lanes of a row are consecutive: xor over offsets below G stays
  // inside the row's lanes
  for (int w = G / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mn[d] = lesser(mn[d], __shfl_xor_sync(0xffffffffu, mn[d], w));
      mx[d] = greater(mx[d], __shfl_xor_sync(0xffffffffu, mx[d], w));
    }
  }
  if (row < R && sub == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      lo[row * D + d] = mn[d];
      hi[row * D + d] = mx[d];
    }
  }
}

template <typename T, int D>
void launch(bool vec, const T* p, const unsigned char* valid, long long R,
            int C, int G, T* lo, T* hi, cudaStream_t s) {
  const long long rows_per_block = kThreads / 32 * (32 / G);
  const dim3 grid(static_cast<unsigned>((R + rows_per_block - 1) /
                                        rows_per_block));
  if (vec)
    row_bbox_kernel<T, D, true><<<grid, kThreads, 0, s>>>(p, valid, R, C, G,
                                                          lo, hi);
  else
    row_bbox_kernel<T, D, false><<<grid, kThreads, 0, s>>>(p, valid, R, C,
                                                           G, lo, hi);
}

template <typename T>
int dispatch(int D, const void* p, const unsigned char* valid, long long R,
             int C, void* lo, void* hi, cudaStream_t s) {
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const int segs = (C + kSeg - 1) / kSeg;
  int G = 1;
  while (G < segs && G < 32) G *= 2;
  const bool vec = C % kSeg == 0 &&
                   reinterpret_cast<unsigned long long>(valid) % 16 == 0;
  const T* pt = static_cast<const T*>(p);
  T* l = static_cast<T*>(lo);
  T* h = static_cast<T*>(hi);
  switch (D) {
    case 1: launch<T, 1>(vec, pt, valid, R, C, G, l, h, s); break;
    case 2: launch<T, 2>(vec, pt, valid, R, C, G, l, h, s); break;
    case 3: launch<T, 3>(vec, pt, valid, R, C, G, l, h, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts (R, C, D) int32 (is_float = 0) or float32 (is_float = 1), valid
// (R, C) bool as bytes, both contiguous; writes lo and hi, (R, D) each, in
// the points' type. Returns cudaGetLastError().
extern "C" int row_bbox_launch(const void* pts, const unsigned char* valid,
                               int is_float, long long R, int C, int D,
                               void* lo, void* hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float ? dispatch<float>(D, pts, valid, R, C, lo, hi, s)
                  : dispatch<int>(D, pts, valid, R, C, lo, hi, s);
}
