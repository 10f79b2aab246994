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
// must move (36 + 36 F + 6 + 6) * N * 4 B = 7.47 MB, 2.2 us at 3.35 TB/s; its
// 6.5 MFLOP are 0.1 us at 67 TFLOP/s. Reaching that needs megabytes in
// flight on every SM at once: a thread per node that loads its column entry
// by entry (the first version of this kernel) keeps too few bytes in flight
// and fills only N / 256 = 32 of the 132 SMs.
//
// Design: a block owns a tile of T = 32 node columns, so N = 8192 is 256
// blocks, all resident at once. Before any arithmetic the block issues every
// copy of its inputs into shared memory as asynchronous 16-byte cp.async
// copies: the D tile (36, T), the B tile with the columns of the upper band's
// halo (F * 36, T + H) and the x window (6, T + 2 H), H = F rounded up to a
// whole 16-byte chunk. Each byte of D and B is then read from device memory
// once (a neighbour's halo columns come from L2) and the upper band is read
// from the staged halo: no shifted copy of B and no second pass. Columns
// outside [0, N) are zero-filled by the copy itself, so no branch remains in
// the arithmetic. 6 T threads then compute one output (row i, node u) each
// from shared memory, and y is written coalesced. Where the staged B tile
// would exceed kBStageBytes (a large F, mostly in fp64), the offsets are
// staged and summed in groups, in order.
//
// The 16-byte copies need 16-byte-aligned rows: N a multiple of 4 (fp32) or
// 2 (fp64) and aligned base pointers, which the main path always has (node
// capacities are powers of two or multiples of 1024). Any other N takes the
// same kernel with one element per copy (the Aligned = false instance).
//
// The sums are grouped as in the plain version (gn.band_matvec_t): the
// diagonal sum first, then per offset the lower and the upper sum.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 32;                      // node columns per block
constexpr int kThreads = 6 * kTile;            // one thread per output
constexpr int kBStageBytes = 64 * 1024;        // B staged per group, at most
constexpr int kMaxFanout = 32;                 // ops/band_matvec.py MAX_FANOUT

// Asynchronous global -> shared copy of Bytes bytes (4, 8 or 16); the
// source is read only when `full`, else the destination is zero-filled.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? Bytes : 0;
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(Bytes), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage `rows` rows of `cols` columns, from global column c0 on, of a
// row-major array with row stride N into shared memory (row stride `cols`),
// V elements per copy. Columns outside [0, N) are zero-filled; with N a
// multiple of V a copy is wholly inside or wholly outside.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int rows, int cols, int c0, int N) {
  const int chunks = cols / V;
  const int total = rows * chunks;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * V;
    const int u = c0 + c;
    const bool in = u >= 0 && u < N;
    const T* s = in ? src + static_cast<size_t>(r) * N + u : src;
    cp_async<static_cast<int>(V * sizeof(T))>(dst + r * cols + c, s, in);
  }
}

template <typename T, bool Aligned>
__global__ void __launch_bounds__(kThreads)
band_matvec_kernel(const T* __restrict__ D, const T* __restrict__ B,
                   const T* __restrict__ x, T* __restrict__ y, int F, int N,
                   int H, int G) {
  constexpr int V = Aligned ? 16 / static_cast<int>(sizeof(T)) : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WB = kTile + H;                    // B tile row: tile + halo
  const int WX = kTile + 2 * H;                // x window row
  T* Ds = reinterpret_cast<T*>(smem_raw);      // (36, T), column 0 = u0
  T* xs = Ds + 36 * kTile;                     // (6, WX), column 0 = u0 - H
  T* Bs = xs + 6 * WX;                         // (G * 36, WB), column 0 = u0
  const int u0 = blockIdx.x * kTile;
  const size_t n = static_cast<size_t>(N);

  const int i = threadIdx.x / kTile;           // output row
  const int l = threadIdx.x - i * kTile;       // column in the tile
  const int cx = l + H;                        // column of u in the x window

  T acc = T(0);
  const int groups = F > 0 ? (F + G - 1) / G : 1;
  for (int gi = 0; gi < groups; ++gi) {
    const int g0 = gi * G;
    const int fg = min(G, F - g0);             // 0 when F == 0
    if (gi > 0) {
      __syncthreads();                         // the last group is consumed
    } else {
      stage<T, V>(Ds, D, 36, kTile, u0, N);
      stage<T, V>(xs, x, 6, WX, u0 - H, N);
    }
    stage<T, V>(Bs, B + static_cast<size_t>(g0) * 36 * n, fg * 36, WB, u0,
                N);
    cp_async_wait_all();
    __syncthreads();

    if (gi == 0) {
      T s = Ds[(6 * i) * kTile + l] * xs[cx];
#pragma unroll
      for (int j = 1; j < 6; ++j)
        s += Ds[(6 * i + j) * kTile + l] * xs[j * WX + cx];
      acc = s;
    }
    for (int f = 0; f < fg; ++f) {
      const T* Bf = Bs + f * 36 * WB;
      const int o = g0 + f + 1;                // band offset
      const int lo = cx - o;                   // x window column of u-o
      const int hi = cx + o;                   // x window column of u+o
      const int up = l + o;                    // B tile column of u+o
      T s = Bf[(6 * i) * WB + l] * xs[lo];
#pragma unroll
      for (int j = 1; j < 6; ++j) s += Bf[(6 * i + j) * WB + l] * xs[j * WX + lo];
      acc += s;
      T t = Bf[i * WB + up] * xs[hi];
#pragma unroll
      for (int j = 1; j < 6; ++j) t += Bf[(6 * j + i) * WB + up] * xs[j * WX + hi];
      acc += t;
    }
  }
  const int u = u0 + l;
  if (u < N) y[i * n + u] = acc;
}

// Shared memory of one block for halo H and a group of G offsets.
template <typename T>
size_t smem_bytes(int H, int G) {
  return sizeof(T) * (36 * kTile + 6 * (kTile + 2 * H) +
                      static_cast<size_t>(G) * 36 * (kTile + H));
}

// The staging of one launch: the halo H, the offsets staged per group G
// and the dynamic shared memory of a block.
struct Staging {
  int H, G;
  size_t smem;
};

template <typename T, bool Aligned>
Staging staging(int F) {
  constexpr int V = Aligned ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int H = (F + V - 1) / V * V;           // halo, whole copies
  const size_t per_f = sizeof(T) * 36 * static_cast<size_t>(kTile + H);
  int G = static_cast<int>(kBStageBytes / per_f);
  G = G < 1 ? 1 : (G > F ? F : G);             // 0 when F == 0
  return {H, G, smem_bytes<T>(H, G)};
}

// Opt the kernel instance in to the most dynamic shared memory any F <=
// kMaxFanout needs (above 48 KB only by opt-in). Once per device, when the
// library loads (kpg_band_matvec_init), never at a launch: a launch may be
// captured into a CUDA graph.
template <typename T, bool Aligned>
cudaError_t opt_in_smem() {
  size_t most = 0;
  for (int F = 0; F <= kMaxFanout; ++F) {
    const size_t s = staging<T, Aligned>(F).smem;
    most = s > most ? s : most;
  }
  if (most <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(band_matvec_kernel<T, Aligned>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(most));
}

template <typename T, bool Aligned>
int launch_as(const T* D, const T* B, const T* x, T* y, int F, int N,
              cudaStream_t stream) {
  const Staging st = staging<T, Aligned>(F);
  const int grid = (N + kTile - 1) / kTile;
  band_matvec_kernel<T, Aligned><<<grid, kThreads, st.smem, stream>>>(
      D, B, x, y, F, N, st.H, st.G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* D, const T* B, const T* x, T* y, int F, int N,
           void* stream) {
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const bool aligned =
      N % V == 0 &&
      (reinterpret_cast<uintptr_t>(D) | reinterpret_cast<uintptr_t>(B) |
       reinterpret_cast<uintptr_t>(x)) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aligned ? launch_as<T, true>(D, B, x, y, F, N, s)
                 : launch_as<T, false>(D, B, x, y, F, N, s);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors; the launch is asynchronous on `stream`. Returns the
// cudaGetLastError() code right after the launch (0 = success). Call
// kpg_band_matvec_init once on each device first.
extern "C" int kpg_band_matvec_init() {
  cudaError_t e = opt_in_smem<float, true>();
  if (e == cudaSuccess) e = opt_in_smem<float, false>();
  if (e == cudaSuccess) e = opt_in_smem<double, true>();
  if (e == cudaSuccess) e = opt_in_smem<double, false>();
  return static_cast<int>(e);
}

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

// 1 if a call with these arguments takes the 16-byte-copy path, else 0.
extern "C" int kpg_band_matvec_aligned(const void* D, const void* B,
                                       const void* x, int elem_bytes, int N) {
  const int V = 16 / elem_bytes;
  return N % V == 0 &&
         (reinterpret_cast<uintptr_t>(D) | reinterpret_cast<uintptr_t>(B) |
          reinterpret_cast<uintptr_t>(x)) % 16 == 0;
}

extern "C" const char* kpg_band_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
