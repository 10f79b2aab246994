// The preconditioner apply: the band part's block cyclic reduction passes
// and the coarse correction's aggregate sums, applied to a (6, Nc) residual
// once per CG iteration (ops/bcr_apply.py precond_apply).
//
// It replaces no Pallas kernel. The JAX package computes the same apply as
// XLA-fused jnp (solve_keyframe_pose_graph_tpu/ops/band.py bcr_solve and
// ops/coarse.py coarse_apply). Its plain PyTorch form, ops/band.py bcr_solve
// and ops/coarse.py coarse_apply, launches ~38 kernels an apply at two
// levels: 13 batched cuBLAS gemv on (d, d) blocks, four torch.cat shifts
// (two of them full copies of a level's Ce blocks), a stack per level and
// the pads, sums, masks and adds around them. This file does the same
// arithmetic in one launch per reduction pass.
//
// The factor (ops/band.py bcr_factorize) has L levels; level l holds, for
// its h = m / 2 odd super-nodes i, Aoinv[i] (the inverse of the odd diagonal
// block), Co[i] = C[2i+1] and Ce[i] = C[2i], each a (d, d) block, d = 6 g,
// and the root holds m_L blocks root_inv[i]. Then:
//
//   forward, l = 0 .. L-1 (bcr_apply_forward_kernel), for each i < h:
//     y_i   = Aoinv[i] bo_i,                bo_i = b[2i+1], be_i = b[2i]
//     b'_i  = be_i - Co[i]^T y_i - Ce[i] y_{i-1}       (y_{-1} = 0)
//   and the last forward pass also applies the root: x_L[i] = root[i] b'_i;
//   backward, l = L-1 .. 0 (bcr_apply_backward_kernel), for each i < h:
//     x[2i]   = x'[i]
//     x[2i+1] = Aoinv[i] (bo_i - Co[i] x'[i] - Ce[i+1]^T x'[i+1])
//   with x'[h] = 0 and Ce[h] = 0. At L = 0 the root alone is the band part
//   (bcr_apply_root_kernel).
//
// The coarse correction adds free_mask[u] * y_c[u / c] to node u, y_c =
// Hc_inv rc, rc the sums of r over aggregates of c nodes: rc comes from
// bcr_apply_coarse_sum_kernel, the dense (6M, 6M) product stays one
// torch.mv (a plain large matrix product, left to the library), and the
// add goes into the store of the last pass.
//
// What bounds it on an H100: bytes. Each level's Aoinv, Co and Ce are read
// twice (forward and backward) and the root once; at the 30k bucket (n_cap
// 32768, g = 5, d = 30, fp32, 3,600 B a block) that is (6 * 4096 + 6 * 2048 +
// 2048) blocks = 140.1 MB, 41.8 us at 3.35 TB/s; at 5k (n_cap 8192) 35.0 MB,
// 10.5 us, which also fits in the 50 MB L2 between applies. The arithmetic
// is three (d, d) matrix-vector products per block triple, 2 FLOP per 4 B.
//
// Design: a block owns a run of R consecutive outputs of a pass, a warp per
// output (R = 4 unless a large d or fp64 runs out of shared memory). Before
// any arithmetic it issues every copy of its blocks and vectors into shared
// memory as asynchronous copies (16 bytes a copy for the blocks, each block
// contiguous and a multiple of 16 bytes; one element a copy for the
// vectors), so that a block's ~50 KB are in flight at once and a few blocks
// per SM cover the memory's latency. Co and Co^T, Ce and Ce^T are all read
// from the staged block: no transposed or shifted copy. y_{i-1} comes from
// the output before the run, recomputed at the run's edge (one more Aoinv
// block a run, usually from L2): no second pass and no grid-wide sync. The
// forward pass copies its Aoinv blocks and vectors first and starts on y
// while Co and Ce are still arriving. A lane computes one row of a product
// (two for d > 32), summing over the columns in order: every sum runs in a
// fixed order, so the apply repeats bit for bit. Pass 0 reads r in its
// (6, Nc) layout, nodes at or past Nc read as zero, and the last pass
// stores into the contiguous (6, Nc) output, so there is no transpose, pad
// or slice; the last pass may instead store node-major, the (Nc, 6) array
// in memory, for a mesh that slices the result by nodes. Each block is
// row-major (ops/lm.py band_factor makes it so), 16-byte aligned, and
// the blocks of a batch one uniform stride apart (ops/bcr_apply.py checks
// it): a (d, d) block of any d = 6 g is 144 g^2 or 288 g^2 bytes, a multiple
// of 16.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxD = 64;                       // ops/smallinv.py MAX_D
constexpr int kMaxRun = 4;                      // outputs (warps) per block
constexpr int kSmemCap = 200 * 1024;            // dynamic shared memory cap
constexpr int kSumWarps = 8;                    // coarse sums per block
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
}

// A product rounded on its own, never contracted into an add: the coarse
// term is added as the plain form adds it, band + (y * mask).
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// Stage one (d, d) block (dd values) by 16-byte copies; zero-filled when
// !valid (src is then not read).
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* src, int dd,
                                            bool valid) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  for (int c = threadIdx.x * V; c < dd; c += blockDim.x * V)
    cp_async<16>(dst + c, src + (valid ? c : 0), valid);
}

// Where value j of super-node s's d-vector lives. Stacked: row s of an
// (m, d) array. Node layout: a (6, Nc) array, super-node s holding nodes
// s g .. s g + g - 1, so value j is node s g + j / 6, row j % 6, stored
// row-major (the residual's layout) or node-major ((Nc, 6) in memory);
// nodes at or past Nc hold no value (-1).
constexpr int kStacked = 0, kRowMajor = 1, kNodeMajor = 2;

struct Layout {
  int nodes;     // kStacked, kRowMajor or kNodeMajor
  int Nc, g, d;

  __device__ __forceinline__ long long at(int s, int j) const {
    if (nodes == kStacked) return static_cast<long long>(s) * d + j;
    const int u = s * g + j / 6;
    if (u >= Nc) return -1;
    return nodes == kRowMajor ? static_cast<long long>(j % 6) * Nc + u
                              : static_cast<long long>(u) * 6 + j % 6;
  }
};

// Stage super-node s's vector (zeros where s is outside [0, m) or a node is
// past Nc) by one-element copies.
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src,
                                          const Layout& lay, int s, int m,
                                          int j) {
  const long long k = (s >= 0 && s < m) ? lay.at(s, j) : -1;
  cp_async<static_cast<int>(sizeof(T))>(dst, src + (k >= 0 ? k : 0), k >= 0);
}

// sum_k A[row][k] v[k] over the staged block A, k in order.
template <typename T>
__device__ __forceinline__ T row_dot(const T* A, const T* v, int row, int d) {
  const T* a = A + row * d;
  T s = a[0] * v[0];
  for (int k = 1; k < d; ++k) s += a[k] * v[k];
  return s;
}

// sum_k A[k][col] v[k]: the product with A^T, from the same staged block.
template <typename T>
__device__ __forceinline__ T col_dot(const T* A, const T* v, int col, int d) {
  T s = A[col] * v[0];
  for (int k = 1; k < d; ++k) s += A[k * d + col] * v[k];
  return s;
}

// Store value `row` of super-node s: stacked, or into the (6, Nc) output
// plus the coarse term free_mask[u] * yc[(u / cg) * 6 + row % 6] when yc is
// given.
template <typename T>
__device__ __forceinline__ void store(T* out, const Layout& lay, int s,
                                      int row, T v, const T* yc,
                                      const T* fm, int cg) {
  const long long k = lay.at(s, row);
  if (k < 0) return;
  if (lay.nodes != kStacked && yc != nullptr) {
    const int u = s * lay.g + row / 6;
    v = v + mul_rn(yc[(u / cg) * 6 + row % 6], fm[u]);
  }
  out[k] = v;
}

// Forward pass of one level: b (2h super-nodes, in `in`'s layout) ->
// out (h, d) stacked: b', or with `root`, root[i] b'_i.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxRun)
bcr_apply_forward_kernel(const T* __restrict__ b, Layout in,
                         const T* __restrict__ Ainv, long long sA,
                         const T* __restrict__ Co, long long sCo,
                         const T* __restrict__ Ce, long long sCe,
                         const T* __restrict__ root, long long sR,
                         T* __restrict__ out, int h, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = in.d, dd = d * d, m = 2 * h;
  T* shAinv = reinterpret_cast<T*>(smem_raw);    // R + 1: outputs i0-1 ..
  T* shCo = shAinv + (R + 1) * dd;                // R
  T* shCe = shCo + R * dd;                        // R
  T* shRoot = shCe + R * dd;                      // R with a root, else 0
  T* vec = shRoot + (root != nullptr ? R * dd : 0);  // 2R + 1 super-nodes
  T* y = vec + (2 * R + 1) * d;                 // R + 1
  T* bn = y + (R + 1) * d;                      // R
  const int i0 = blockIdx.x * R;
  const int s0 = 2 * i0 - 1;                    // vec[q] is super-node s0 + q

  // group 0: what y needs (Aoinv of outputs i0-1 .. i0+R-1, the vectors)
  for (int t = 0; t <= R; ++t) {
    const int i = i0 - 1 + t;
    const bool ok = i >= 0 && i < h;
    stage_block(shAinv + t * dd, Ainv + (ok ? i * sA : 0), dd, ok);
  }
  for (int idx = threadIdx.x; idx < (2 * R + 1) * d; idx += blockDim.x) {
    const int q = idx / d;
    stage_vec(vec + idx, b, in, s0 + q, m, idx - q * d);
  }
  cp_async_commit();
  // group 1: Co, Ce (and the root) of outputs i0 .. i0+R-1
  for (int t = 0; t < R; ++t) {
    const int i = i0 + t;
    const bool ok = i < h;
    stage_block(shCo + t * dd, Co + (ok ? i * sCo : 0), dd, ok);
    stage_block(shCe + t * dd, Ce + (ok ? i * sCe : 0), dd, ok);
    if (root != nullptr)
      stage_block(shRoot + t * dd, root + (ok ? i * sR : 0), dd, ok);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  cp_async_wait<1>();
  __syncthreads();
  // y[t] = Aoinv[i0-1+t] bo, bo = b[2(i0-1+t)+1] = vec[2t]
  for (int t = warp; t <= R; t += R)
    for (int row = lane; row < d; row += 32)
      y[t * d + row] = row_dot(shAinv + t * dd, vec + 2 * t * d, row, d);
  cp_async_wait<0>();
  __syncthreads();

  const int t = warp, i = i0 + t;
  if (i >= h) return;                           // the whole warp
  const T* co = shCo + t * dd;
  const T* ce = shCe + t * dd;
  for (int row = lane; row < d; row += 32) {
    const T v = vec[(2 * t + 1) * d + row]      // be = b[2i]
                - col_dot(co, y + (t + 1) * d, row, d)
                - row_dot(ce, y + t * d, row, d);
    if (root == nullptr)
      out[static_cast<long long>(i) * d + row] = v;
    else
      bn[t * d + row] = v;
  }
  if (root == nullptr) return;
  __syncwarp();
  for (int row = lane; row < d; row += 32)
    out[static_cast<long long>(i) * d + row] =
        row_dot(shRoot + t * dd, bn + t * d, row, d);
}

// Backward pass of one level: x' (h, d) stacked and this level's b (2h
// super-nodes, in `in`'s layout) -> x (2h super-nodes, in `to`'s layout,
// with the coarse term when yc is given).
template <typename T>
__global__ void __launch_bounds__(32 * kMaxRun)
bcr_apply_backward_kernel(const T* __restrict__ xe, const T* __restrict__ b,
                          Layout in, const T* __restrict__ Ainv, long long sA,
                          const T* __restrict__ Co, long long sCo,
                          const T* __restrict__ Ce, long long sCe,
                          T* __restrict__ out, Layout to,
                          const T* __restrict__ yc, const T* __restrict__ fm,
                          int cg, int h, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = in.d, dd = d * d, m = 2 * h;
  T* shAinv = reinterpret_cast<T*>(smem_raw);    // R
  T* shCo = shAinv + R * dd;                      // R
  T* shCe = shCo + R * dd;                        // R: Ce[i+1]
  T* xs = shCe + R * dd;                         // R + 1: x'[i0 ..]
  T* bo = xs + (R + 1) * d;                     // R
  T* rhs = bo + R * d;                          // R
  const int i0 = blockIdx.x * R;
  const Layout stacked{kStacked, 0, 0, d};

  for (int t = 0; t < R; ++t) {
    const int i = i0 + t;
    const bool ok = i < h, next = i + 1 < h;
    stage_block(shAinv + t * dd, Ainv + (ok ? i * sA : 0), dd, ok);
    stage_block(shCo + t * dd, Co + (ok ? i * sCo : 0), dd, ok);
    stage_block(shCe + t * dd, Ce + (next ? (i + 1) * sCe : 0), dd, next);
  }
  for (int idx = threadIdx.x; idx < (R + 1) * d; idx += blockDim.x) {
    const int q = idx / d;
    stage_vec(xs + idx, xe, stacked, i0 + q, h, idx - q * d);
  }
  for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
    const int q = idx / d;
    stage_vec(bo + idx, b, in, 2 * (i0 + q) + 1, m, idx - q * d);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int t = threadIdx.x >> 5, lane = threadIdx.x & 31, i = i0 + t;
  if (i >= h) return;                           // the whole warp
  const T* x0 = xs + t * d;
  for (int row = lane; row < d; row += 32)
    rhs[t * d + row] = bo[t * d + row]
                       - row_dot(shCo + t * dd, x0, row, d)
                       - col_dot(shCe + t * dd, x0 + d, row, d);
  __syncwarp();
  for (int row = lane; row < d; row += 32) {
    store(out, to, 2 * i, row, x0[row], yc, fm, cg);
    store(out, to, 2 * i + 1, row,
          row_dot(shAinv + t * dd, rhs + t * d, row, d),
          yc, fm, cg);
  }
}

// The band part without a reduction level (L = 0): x[s] = root[s] b[s] for
// each of the m super-nodes, from the (6, Nc) layout `in` to `to`.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxRun)
bcr_apply_root_kernel(const T* __restrict__ r, Layout in,
                      const T* __restrict__ root, long long sR,
                      T* __restrict__ out, Layout to,
                      const T* __restrict__ yc, const T* __restrict__ fm,
                      int cg, int m, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = in.d, dd = d * d;
  T* shRoot = reinterpret_cast<T*>(smem_raw);    // R
  T* vec = shRoot + R * dd;                      // R
  const int s0 = blockIdx.x * R;
  for (int t = 0; t < R; ++t) {
    const bool ok = s0 + t < m;
    stage_block(shRoot + t * dd, root + (ok ? (s0 + t) * sR : 0), dd, ok);
  }
  for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
    const int q = idx / d;
    stage_vec(vec + idx, r, in, s0 + q, m, idx - q * d);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int t = threadIdx.x >> 5, lane = threadIdx.x & 31, s = s0 + t;
  if (s >= m) return;
  for (int row = lane; row < d; row += 32)
    store(out, to, s, row, row_dot(shRoot + t * dd, vec + t * d, row, d), yc,
          fm, cg);
}

// rc[a * 6 + c] = sum of r[c, u] over the nodes u of aggregate a (cg nodes
// from a cg, those below Nc): a warp per sum, each lane summing every 32nd
// node in order, then a fixed butterfly across the lanes. No atomics.
template <typename T>
__global__ void __launch_bounds__(32 * kSumWarps)
bcr_apply_coarse_sum_kernel(const T* __restrict__ r, int Nc, int cg, int M,
                            T* __restrict__ rc) {
  const int w = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= 6 * M) return;                       // the whole warp
  const int a = w / 6, c = w - a * 6;
  const int u1 = min((a + 1) * cg, Nc);
  const T* row = r + static_cast<long long>(c) * Nc;
  T acc = T(0);
  for (int u = a * cg + lane; u < u1; u += 32) acc += row[u];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) rc[w] = acc;
}

// Shared memory of a block of R outputs, by kernel.
template <typename T>
size_t forward_smem(int d, int R, bool root) {
  const size_t dd = static_cast<size_t>(d) * d;
  return sizeof(T) * ((R + 1 + 2 * R + (root ? R : 0)) * dd +
                      static_cast<size_t>(2 * R + 1 + R + 1 + R) * d);
}
template <typename T>
size_t backward_smem(int d, int R) {
  const size_t dd = static_cast<size_t>(d) * d;
  return sizeof(T) * (3 * R * dd + static_cast<size_t>(3 * R + 1) * d);
}
template <typename T>
size_t root_smem(int d, int R) {
  return sizeof(T) * (static_cast<size_t>(R) * d * d +
                      static_cast<size_t>(R) * d);
}

// The most outputs a block takes within kSmemCap, and its shared memory.
template <typename F>
int run_length(F smem) {
  int R = kMaxRun;
  while (R > 1 && smem(R) > static_cast<size_t>(kSmemCap)) --R;
  return R;
}

template <typename T>
cudaError_t opt_in() {
  const void* fns[] = {
      reinterpret_cast<const void*>(bcr_apply_forward_kernel<T>),
      reinterpret_cast<const void*>(bcr_apply_backward_kernel<T>),
      reinterpret_cast<const void*>(bcr_apply_root_kernel<T>)};
  for (const void* f : fns) {
    const cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

bool takes(int d, int g) { return g >= 1 && d == 6 * g && d <= kMaxD; }

bool node_layout(int nodes) { return nodes == kRowMajor || nodes == kNodeMajor; }

int refused() { return static_cast<int>(cudaErrorInvalidValue); }

template <typename T>
int forward(const T* b, int nodes, int Nc, int g, const T* Ainv,
            long long sA, const T* Co, long long sCo, const T* Ce,
            long long sCe, const T* root, long long sR, T* out, int h, int d,
            void* stream) {
  if (!takes(d, g) || h <= 0 || (nodes != kStacked && nodes != kRowMajor))
    return refused();
  const bool has_root = root != nullptr;
  const int R = run_length([&](int r) {
    return forward_smem<T>(d, r, has_root);
  });
  const size_t smem = forward_smem<T>(d, R, has_root);
  if (smem > static_cast<size_t>(kSmemCap)) return refused();
  const Layout in{nodes, Nc, g, d};
  bcr_apply_forward_kernel<T>
      <<<(h + R - 1) / R, 32 * R, smem, static_cast<cudaStream_t>(stream)>>>(
          b, in, Ainv, sA, Co, sCo, Ce, sCe, root, sR, out, h, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const T* xe, const T* b, int b_nodes, int Nc, int g,
             const T* Ainv, long long sA, const T* Co, long long sCo,
             const T* Ce, long long sCe, T* out, int out_nodes, const T* yc,
             const T* fm, int cg, int h, int d, void* stream) {
  if (!takes(d, g) || h <= 0 || (yc != nullptr && cg <= 0) ||
      (b_nodes != kStacked && b_nodes != kRowMajor) ||
      (out_nodes != kStacked && !node_layout(out_nodes)))
    return refused();
  const int R = run_length([&](int r) { return backward_smem<T>(d, r); });
  const size_t smem = backward_smem<T>(d, R);
  if (smem > static_cast<size_t>(kSmemCap)) return refused();
  const Layout in{b_nodes, Nc, g, d}, to{out_nodes, Nc, g, d};
  bcr_apply_backward_kernel<T>
      <<<(h + R - 1) / R, 32 * R, smem, static_cast<cudaStream_t>(stream)>>>(
          xe, b, in, Ainv, sA, Co, sCo, Ce, sCe, out, to, yc, fm, cg, h, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int root_only(const T* r, int Nc, int g, const T* root, long long sR, T* out,
              int out_nodes, const T* yc, const T* fm, int cg, int m, int d,
              void* stream) {
  if (!takes(d, g) || m <= 0 || (yc != nullptr && cg <= 0) ||
      !node_layout(out_nodes))
    return refused();
  const int R = run_length([&](int q) { return root_smem<T>(d, q); });
  const size_t smem = root_smem<T>(d, R);
  const Layout in{kRowMajor, Nc, g, d}, to{out_nodes, Nc, g, d};
  bcr_apply_root_kernel<T>
      <<<(m + R - 1) / R, 32 * R, smem, static_cast<cudaStream_t>(stream)>>>(
          r, in, root, sR, out, to, yc, fm, cg, m, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int coarse_sum(const T* r, int Nc, int cg, int M, T* rc, void* stream) {
  if (cg <= 0 || M <= 0) return refused();
  const int blocks = (6 * M + kSumWarps - 1) / kSumWarps;
  bcr_apply_coarse_sum_kernel<T>
      <<<blocks, 32 * kSumWarps, 0, static_cast<cudaStream_t>(stream)>>>(
          r, Nc, cg, M, rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; each
// (d, d) block is row-major, 16-byte aligned, and block i of a batch
// starts i * s* elements after the first. A layout argument (`nodes`,
// `b_nodes`, `out_nodes`) is 0 for stacked (m, d), 1 for the row-major
// (6, Nc) node layout and 2 for its node-major form. Vectors are
// contiguous. The launch is asynchronous on `stream`; the return value is
// the cudaGetLastError() code right after it (0 = success), or
// cudaErrorInvalidValue for arguments the kernels do not take (d != 6 g,
// d > 64, a layout a pass does not take). Call kpg_bcr_apply_init once on
// each device first.
extern "C" int kpg_bcr_apply_init() {
  cudaError_t e = opt_in<float>();
  if (e == cudaSuccess) e = opt_in<double>();
  return static_cast<int>(e);
}

#define KPG_BCR_APPLY_ENTRIES(T, SUFFIX)                                      \
  extern "C" int kpg_bcr_apply_forward_##SUFFIX(                              \
      const T* b, int nodes, int Nc, int g, const T* Ainv, long long sA,      \
      const T* Co, long long sCo, const T* Ce, long long sCe, const T* root,  \
      long long sR, T* out, int h, int d, void* stream) {                     \
    return forward<T>(b, nodes, Nc, g, Ainv, sA, Co, sCo, Ce, sCe, root, sR,  \
                      out, h, d, stream);                                     \
  }                                                                           \
  extern "C" int kpg_bcr_apply_backward_##SUFFIX(                             \
      const T* xe, const T* b, int b_nodes, int Nc, int g, const T* Ainv,     \
      long long sA, const T* Co, long long sCo, const T* Ce, long long sCe,   \
      T* out, int out_nodes, const T* yc, const T* fm, int cg, int h, int d,  \
      void* stream) {                                                         \
    return backward<T>(xe, b, b_nodes, Nc, g, Ainv, sA, Co, sCo, Ce, sCe,     \
                       out, out_nodes, yc, fm, cg, h, d, stream);             \
  }                                                                           \
  extern "C" int kpg_bcr_apply_root_##SUFFIX(                                 \
      const T* r, int Nc, int g, const T* root, long long sR, T* out,         \
      int out_nodes, const T* yc, const T* fm, int cg, int m, int d,          \
      void* stream) {                                                         \
    return root_only<T>(r, Nc, g, root, sR, out, out_nodes, yc, fm, cg, m, d, \
                        stream);                                              \
  }                                                                           \
  extern "C" int kpg_bcr_apply_coarse_sum_##SUFFIX(                           \
      const T* r, int Nc, int cg, int M, T* rc, void* stream) {               \
    return coarse_sum<T>(r, Nc, cg, M, rc, stream);                           \
  }

KPG_BCR_APPLY_ENTRIES(float, f32)
KPG_BCR_APPLY_ENTRIES(double, f64)

extern "C" const char* kpg_bcr_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
