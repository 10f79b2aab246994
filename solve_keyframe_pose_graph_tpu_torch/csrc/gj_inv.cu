// Kernel K2: batched inverse of SPD blocks by unpivoted Gauss-Jordan on a
// [A | I] tableau.
//
// Replaces the Pallas TPU kernel _gj_pallas_kernel / pallas_gj_inv in
// solve_keyframe_pose_graph_tpu/ops/smallinv.py. The band preconditioner's
// cyclic reduction (ops/band.py bcr_factorize) calls it on its odd diagonal
// blocks at every level and on the root blocks, once per LM iteration; on the
// main path d = 6 * fanout = 30 and n = 1024, 512 and 512.
//
// What bounds it on an H100: the chain of d dependent pivot steps, not bytes
// or arithmetic. At n = 1024, d = 30 in fp32 a call moves 2 * n * d * d * 4 B
// = 7.4 MB and does about 2 n d^3 = 55 MFLOP, microseconds of either; the d
// steps each need a block-wide barrier between scaling the pivot row and
// eliminating.
//
// Design: one thread block per matrix, so the batch spreads over all SMs and
// a barrier costs one block only. The d x 2d tableau sits in shared memory
// (7.2 KB at d = 30 in fp32); each step first writes the scaled pivot row and
// the old pivot column to two small shared arrays, then every thread updates
// its tableau entries: buf[r][c] -= col[r] * row[c] for r != k and
// buf[k][c] = row[c], exactly the update of the TPU kernel. No pivoting: all
// inputs are damped SPD. d is a runtime argument up to 64; shared memory is
// sized from it (above 48 KB after raising the kernel's limit).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_inv_kernel(const T* __restrict__ A, T* __restrict__ out, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = 2 * d;
  const int nel = d * w;
  T* buf = reinterpret_cast<T*>(smem_raw);      // (d, 2d) tableau
  T* row = buf + nel;                           // (2d,) scaled pivot row
  T* col = row + w;                             // (d,)  old pivot column

  const T* a = A + static_cast<size_t>(blockIdx.x) * d * d;
  for (int idx = threadIdx.x; idx < nel; idx += kThreads) {
    const int r = idx / w;
    const int c = idx - r * w;
    buf[idx] = c < d ? a[r * d + c] : (c - d == r ? T(1) : T(0));
  }
  __syncthreads();

  for (int k = 0; k < d; ++k) {
    const T piv = buf[k * w + k];
    for (int idx = threadIdx.x; idx < w + d; idx += kThreads) {
      if (idx < w) {
        row[idx] = buf[k * w + idx] / piv;
      } else {
        col[idx - w] = buf[(idx - w) * w + k];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nel; idx += kThreads) {
      const int r = idx / w;
      const int c = idx - r * w;
      buf[idx] = r == k ? row[c] : buf[idx] - col[r] * row[c];
    }
    __syncthreads();
  }

  T* o = out + static_cast<size_t>(blockIdx.x) * d * d;
  for (int idx = threadIdx.x; idx < d * d; idx += kThreads) {
    const int r = idx / d;
    o[idx] = buf[r * w + d + (idx - r * d)];
  }
}

template <typename T>
int launch(const T* A, T* out, int n, int d, void* stream) {
  if (n > 0) {
    const size_t smem = sizeof(T) * (static_cast<size_t>(d) * 2 * d + 3 * d);
    if (smem > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          gj_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    gj_inv_kernel<T><<<n, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(A, out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. A and out are device pointers of
// contiguous (n, d, d) tensors; the launch is asynchronous on `stream`.
// Returns the cudaGetLastError() code right after the launch (0 = success).
extern "C" int kpg_gj_inv_f32(const float* A, float* out, int n, int d,
                              void* stream) {
  return launch<float>(A, out, n, d, stream);
}

extern "C" int kpg_gj_inv_f64(const double* A, double* out, int n, int d,
                              void* stream) {
  return launch<double>(A, out, n, d, stream);
}

extern "C" const char* kpg_gj_inv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
