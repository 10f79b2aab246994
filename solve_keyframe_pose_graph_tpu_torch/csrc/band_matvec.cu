// Kernel K1: the odometry-band part of the reduced-system matvec, in the
// entry-major layout (blocks (36, N), vectors (6, N), node axis last).
//
// Replaces the Pallas TPU kernel _band_kernel / band_matvec_pre in
// solve_keyframe_pose_graph_tpu/ops/pallas_band.py. Computes
//
//   y[i,u] = sum_j D[6i+j, u] x[j, u]
//          + sum_f sum_j B[f, 6i+j, u]     x[j, u-f-1]     (lower band)
//          + sum_f sum_j B[f, 6j+i, u+f+1] x[j, u+f+1]     (upper band)
//
// with x read as zero outside [0, N). It runs once per CG iteration.
//
// What bounds it on an H100: bytes. At N = 8192, F = 5 and fp32 one call
// streams (36 + 36 F) * N * 4 B = 7 MB of D and B from device memory, and the
// second, shifted read of B mostly hits L2: a few microseconds at 3.35 TB/s.
// At that size the launch overhead is of the same order, so the design aims
// only at coalesced loads and a single pass, and is not tuned further.
//
// Design: one thread per node column u. At a fixed entry k neighbouring
// threads read neighbouring D[k,u], B[f,k,u] and B[f,k,u+f+1], so every
// matrix load is coalesced and the upper band is read in place: no shifted
// copy of B (the TPU kernel's Bup) is built. Each block stages its window of
// x, columns [u0-F, u0+BN+F), with the halo, once in shared memory. Any N is
// taken: the ragged last block is masked (the TPU kernel asserted N % bn == 0).
// The sums are grouped as in the plain version (gn.band_matvec_t): the
// diagonal sum first, then per offset the lower and the upper sum.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_matvec_kernel(const T* __restrict__ D, const T* __restrict__ B,
                   const T* __restrict__ x, T* __restrict__ y, int F, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);       // (6, W) window of x
  const int W = kThreads + 2 * F;
  const int u0 = blockIdx.x * kThreads;
  for (int idx = threadIdx.x; idx < 6 * W; idx += kThreads) {
    const int j = idx / W;
    const int u = u0 - F + (idx - j * W);
    xs[idx] = (u >= 0 && u < N) ? x[static_cast<size_t>(j) * N + u] : T(0);
  }
  __syncthreads();

  const int u = u0 + threadIdx.x;
  if (u >= N) return;
  const size_t n = static_cast<size_t>(N);
  const int c = threadIdx.x + F;                // column of u in the window

  T acc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = D[(6 * i) * n + u] * xs[c];
#pragma unroll
    for (int j = 1; j < 6; ++j) s += D[(6 * i + j) * n + u] * xs[j * W + c];
    acc[i] = s;
  }
  for (int f = 0; f < F; ++f) {
    const T* Bf = B + static_cast<size_t>(f) * 36 * n;
    const int lo = c - f - 1;                   // window column of u-f-1
    const int hi = c + f + 1;                   // window column of u+f+1
    const int up = u + f + 1;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T s = Bf[(6 * i) * n + u] * xs[lo];
#pragma unroll
      for (int j = 1; j < 6; ++j) s += Bf[(6 * i + j) * n + u] * xs[j * W + lo];
      acc[i] += s;
      if (up < N) {
        T t = Bf[i * n + up] * xs[hi];
#pragma unroll
        for (int j = 1; j < 6; ++j) t += Bf[(6 * j + i) * n + up] * xs[j * W + hi];
        acc[i] += t;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) y[i * n + u] = acc[i];
}

template <typename T>
int launch(const T* D, const T* B, const T* x, T* y, int F, int N,
           void* stream) {
  if (N > 0) {
    const int grid = (N + kThreads - 1) / kThreads;
    const size_t smem = sizeof(T) * 6 * (kThreads + 2 * F);
    band_matvec_kernel<T><<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        D, B, x, y, F, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors; the launch is asynchronous on `stream`. Returns the
// cudaGetLastError() code right after the launch (0 = success).
extern "C" int kpg_band_matvec_f32(const float* D, const float* B,
                                   const float* x, float* y, int F, int N,
                                   void* stream) {
  return launch<float>(D, B, x, y, F, N, stream);
}

extern "C" int kpg_band_matvec_f64(const double* D, const double* B,
                                   const double* x, double* y, int F, int N,
                                   void* stream) {
  return launch<double>(D, B, x, y, F, N, stream);
}

extern "C" const char* kpg_band_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
