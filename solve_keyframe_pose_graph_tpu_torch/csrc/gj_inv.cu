// Kernel K2: batched inverse of SPD blocks by unpivoted in-place
// Gauss-Jordan.
//
// Replaces the Pallas TPU kernel _gj_pallas_kernel / pallas_gj_inv in
// solve_keyframe_pose_graph_tpu/ops/smallinv.py. The band preconditioner's
// cyclic reduction (ops/band.py bcr_factorize) calls it on its odd diagonal
// blocks at every level and on the root blocks, once per LM iteration; on the
// main path d = 6 * fanout = 30 and n = 1024, 512 and 512.
//
// What bounds it on an H100: the chain of d dependent pivot steps, not bytes
// or arithmetic. At n = 1024, d = 30 in fp32 a call moves 2 * n * d * d * 4 B
// = 7.4 MB (2.2 us at 3.35 TB/s) and does 2 n d^3 = 55 MFLOP (0.8 us at
// 67 TFLOP/s). The first version of this kernel gave each matrix a block of
// 256 threads and two block barriers per step, with the tableau swept in
// shared memory: about 4 us a step, 126 us a call.
//
// Design: one warp per matrix and no barrier at all. Lane c holds column c
// of the matrix in registers (d <= 32; for 32 < d <= 64 it holds columns c
// and c + 32), and the inverse overwrites it in place: at step k column k
// takes the values the [A | I] tableau's column d + k would hold. A step
// reads the pivot a[k][k] and the pivot column a[r][k] from the lane that
// owns column k by warp shuffles, all issued before the first instruction
// that waits on one; each lane then does one division (its own entry of the
// scaled pivot row) and d fused updates. The arithmetic is the tableau's
// step, entry for entry, as on the TPU:
//   row k:  a[k][c] <- a[k][c] / p,   (the identity column: 1 / p)
//   r != k: a[r][c] <- a[r][c] - a[r][k] * a[k][c]   (identity column: 0 - ...)
// The fp32 division is the hardware reciprocal and a multiply: the IEEE
// division sat in the chain of every step and cost about a quarter of the
// call. The step loop is not unrolled (the rows rotate
// through fixed registers, see the kernel), which keeps the code small and
// its build at seconds. A call is the latency of one warp's d steps, so
// n = 1 takes nearly what n = 1024 does.
// No pivoting: all inputs are damped SPD. A column is loaded and stored with
// coalesced accesses (at each r the lanes touch d consecutive values), so no
// shared memory is used. kWarps matrices share a block (n = 1024 is 256
// blocks). Each matrix's d x d values are contiguous; matrix m starts at
// A + m * batch_stride, so a strided batch such as A[1::2] is read in place.
// The output is contiguous (n, d, d).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;                       // matrices per block
constexpr unsigned kFull = 0xffffffffu;

// x / p: in fp32 by the hardware reciprocal and a multiply (within 2 ulp),
// in fp64 rounded exactly.
__device__ __forceinline__ float divide(float x, float p) {
  return __fdividef(x, p);
}
__device__ __forceinline__ double divide(double x, double p) { return x / p; }

// CPL: columns per lane, 1 for d <= 32, 2 for d <= 64.
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
gj_inv_kernel(const T* __restrict__ A, T* __restrict__ out, int n, int d,
              long long batch_stride) {
  constexpr int DM = 32 * CPL;                  // rows and columns, padded
  constexpr int kChunk = CPL == 1 ? 32 : 8;     // pivot-column rows in flight
  static_assert(DM % kChunk == 0, "chunks tile the rows");
  const int lane = threadIdx.x & 31;
  const long long m = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (m >= n) return;                           // a whole warp leaves
  const T* a = A + m * batch_stride;

  // the matrix padded to DM x DM with an identity block: its inverse is
  // the matrix's inverse padded the same way, and the padding steps
  // change no entry of the matrix's own block
  T col[CPL][DM];
#pragma unroll
  for (int h = 0; h < CPL; ++h) {
    const int c = lane + 32 * h;
#pragma unroll
    for (int r = 0; r < DM; ++r)
      col[h][r] = (c < d && r < d) ? a[r * d + c] : T(r == c ? 1 : 0);
  }

  // Step k pivots on row k. Each step moves every row up one slot as it
  // updates it and puts the pivot row last, so the pivot row is always slot
  // 0 (register indices stay compile-time in a loop that is not unrolled)
  // and DM steps restore the order.
#pragma unroll 1
  for (int k = 0; k < DM; ++k) {
    const bool upper = CPL > 1 && k >= 32;      // which of the owner's columns
    const int kl = k & 31;                      // the owner lane
    T rc[CPL];                                  // this lane's pivot-row entry
#pragma unroll
    for (int r0 = 0; r0 < DM; r0 += kChunk) {
      // a[r][k] for the chunk's rows (r = 0 is the pivot), all the shuffles
      // issued before the first instruction that waits on one
      T f[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        f[j] = __shfl_sync(kFull, upper ? col[CPL - 1][r0 + j]
                                        : col[0][r0 + j], kl);
      if (r0 == 0) {
#pragma unroll
        for (int h = 0; h < CPL; ++h)
          rc[h] = divide(lane + 32 * h == k ? T(1) : col[h][0], f[0]);
      }
#pragma unroll
      for (int j = r0 == 0 ? 1 : 0; j < kChunk; ++j) {
        const int r = r0 + j;
#pragma unroll
        for (int h = 0; h < CPL; ++h)
          col[h][r - 1] = (lane + 32 * h == k ? T(0) : col[h][r]) -
                          f[j] * rc[h];
      }
    }
#pragma unroll
    for (int h = 0; h < CPL; ++h) col[h][DM - 1] = rc[h];
  }

  T* o = out + m * d * d;
#pragma unroll
  for (int h = 0; h < CPL; ++h) {
    const int c = lane + 32 * h;
    if (c < d) {
#pragma unroll
      for (int r = 0; r < DM; ++r)
        if (r < d) o[r * d + c] = col[h][r];
    }
  }
}

template <typename T>
int launch(const T* A, T* out, int n, int d, long long batch_stride,
           void* stream) {
  if (n > 0) {
    const int grid = (n + kWarps - 1) / kWarps;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d <= 32) {
      gj_inv_kernel<T, 1><<<grid, kWarps * 32, 0, s>>>(A, out, n, d,
                                                        batch_stride);
    } else {
      gj_inv_kernel<T, 2><<<grid, kWarps * 32, 0, s>>>(A, out, n, d,
                                                        batch_stride);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. A: device pointer of n matrices of
// (d, d) contiguous values each, matrix m at A + m * batch_stride (in
// elements); out: a contiguous (n, d, d) device tensor; 1 <= d <= 64. The
// launch is asynchronous on `stream`. Returns the cudaGetLastError() code
// right after the launch (0 = success).
extern "C" int kpg_gj_inv_f32(const float* A, float* out, int n, int d,
                              long long batch_stride, void* stream) {
  return launch<float>(A, out, n, d, batch_stride, stream);
}

extern "C" int kpg_gj_inv_f64(const double* A, double* out, int n, int d,
                              long long batch_stride, void* stream) {
  return launch<double>(A, out, n, d, batch_stride, stream);
}

extern "C" const char* kpg_gj_inv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
