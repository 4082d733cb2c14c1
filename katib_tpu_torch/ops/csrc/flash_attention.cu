// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Counterparts of the three Pallas TPU kernels in
// katib_tpu/ops/flash_attention.py (_fwd_kernel, _dq_kernel, _dkv_kernel),
// behind a plain C interface loaded with ctypes
// (katib_tpu_torch/ops/flash_attention.py).  Inputs are contiguous
// [B, H, S, D] tensors, float32 or bfloat16, D in {32, 64, 128}; every
// product and every softmax statistic is float32, and bfloat16 outputs are
// rounded once at the store.
//
// Semantics (the JAX package's): the causal mask is bottom-right aligned,
// key j visible to query i iff j <= i + (Sk - Sq); a query row that sees no
// key gets output 0 and logsumexp -1e30.  The backward recomputes
// p = exp(scale * q.k - lse) from the saved logsumexp and applies the mask
// after the subtraction (a fully masked row has lse = -1e30, where the
// unmasked exponent would be +huge): masked entries are exactly 0.
//
// Blocking, shared by the three kernels: 64-row q and k tiles held in
// shared memory as float32 (row stride D + 1, so the column walks below hit
// distinct banks); 128 threads, each owning a 4 x 8 patch of the 64 x 64
// score tile (rows ty*4 + i, columns tx + 8*j) and the matching 4 x D/8
// patch of its output rows.  The eight threads of one row group are eight
// neighbouring lanes, so row reductions are three xor shuffles.  Products
// are plain float32 FMAs from shared memory: simple and exact in f32 rather
// than fast; tensor-core (wgmma) pipelines are later work.  Blocks run in
// parallel in no order, so each kernel walks its own loop over the other
// sequence's tiles; nothing carries between blocks and nothing is atomic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // rows of every q tile and every k tile
constexpr int THREADS = 128;    // 16 row groups x 8 column lanes
constexpr int TR = 4;           // score-tile rows per thread
constexpr int TC = 8;           // score-tile columns per thread, strided by 8
constexpr int PLD = TILE + 1;   // padded row stride of the 64 x 64 tiles
constexpr float MASK_VALUE = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [row0, row0 + TILE) of a row-major [rows, D] matrix into shared
// memory as float32, row stride D + 1; rows past the end read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = row0 + r < rows ? to_f32(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// TILE entries of a per-row float32 vector from row0 on; 0 past the end
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) dst[r] = row0 + r < rows ? src[row0 + r] : 0.f;
}

// reductions over the eight neighbouring lanes that share a row group
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ bool visible(int row, int col, int sq, int sk, int shift, int causal) {
  return row < sq && col < sk && (!causal || col <= row + shift);
}

// number of k tiles the q tile starting at q0 sees (causal: those starting
// at or before its last row's diagonal)
__device__ __forceinline__ int live_k_tiles(int q0, int sq, int sk, int shift, int causal) {
  const int n_kt = (sk + TILE - 1) / TILE;
  if (!causal) return n_kt;
  const int last_col = min(q0 + TILE, sq) - 1 + shift;
  return last_col < 0 ? 0 : min(n_kt, last_col / TILE + 1);
}

// ---------------------------------------------------------------------------
// forward
//
// Replaces katib_tpu/ops/flash_attention.py::_fwd_kernel (:60, launched by
// _fwd :121).  One block per (q tile, batch x head); q tiles are taken
// longest-first so the causal tail of the grid is short.  K and V stream
// through shared memory in 64-row tiles; the running (o, m, l) of the
// online softmax stay in float32 registers; causal tiles past the diagonal
// are skipped.
// Bound on the H100: operations (2 products of 2*D flops per visible
// (query, key) pair; 989 TFLOP/s in bf16 tensor cores).  This design runs
// its products on the float32 FMA units (67 TFLOP/s) from shared memory,
// so it sits far above that bound; the probabilities go through shared
// memory once per tile and never to device memory.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk, float scale,
                 int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DC = D / 8;
  float* s_q = smem;
  float* s_k = s_q + TILE * LD;
  float* s_v = s_k + TILE * LD;
  float* s_p = s_v + TILE * LD;

  const int shift = sk - sq;
  const int n_qt = (sq + TILE - 1) / TILE;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * TILE;
  const size_t bh = blockIdx.y;
  q += bh * sq * D;
  o += bh * sq * D;
  lse += bh * sq;
  k += bh * sk * D;
  v += bh * sk * D;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  float acc[TR][DC], m[TR], l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  load_tile<T, D>(s_q, q, q0, sq);
  const int live = live_k_tiles(q0, sq, sk, shift, causal);
  for (int kt = 0; kt < live; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(s_k, k, k0, sk);
    load_tile<T, D>(s_v, v, k0, sk);
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = s_q[(ty * TR + i) * LD + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = s_k[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty * TR + i;
      bool vis[TC];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        vis[j] = visible(row, k0 + tx + 8 * j, sq, sk, shift, causal);
        s[i][j] *= scale;
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        s_p[(ty * TR + i) * PLD + tx + 8 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float p[TR], w[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) p[i] = s_p[(ty * TR + i) * PLD + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) w[jj] = s_v[c * LD + tx + 8 * jj];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(p[i], w[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty * TR + i;
    if (row >= sq) continue;
    const bool seen = l[i] > 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      store(o + (size_t)row * D + tx + 8 * jj, seen ? acc[i][jj] / l[i] : 0.f);
    if (tx == 0) lse[row] = seen ? m[i] + logf(l[i]) : MASK_VALUE;
  }
}

// ---------------------------------------------------------------------------
// dq
//
// Replaces katib_tpu/ops/flash_attention.py::_dq_kernel (:150, launched by
// _bwd :245).  One block per (q tile, batch x head), longest causal rows
// first.  Streams K and V, recomputes p from the saved logsumexp,
// ds = p * (dO.v - dmd) with dmd = rowsum(dO * O) - dlse computed by the
// wrapper, and accumulates dq = scale * ds.k in float32 registers.
// Bound on the H100: operations (3 products of 2*D flops per visible pair).
// Same float32-FMA design as the forward; ds goes through shared memory
// once per tile and never to device memory.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dmd, T* __restrict__ dq, int sq, int sk, float scale,
                int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DC = D / 8;
  float* s_q = smem;
  float* s_do = s_q + TILE * LD;
  float* s_k = s_do + TILE * LD;
  float* s_v = s_k + TILE * LD;
  float* s_ds = s_v + TILE * LD;

  const int shift = sk - sq;
  const int n_qt = (sq + TILE - 1) / TILE;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * TILE;
  const size_t bh = blockIdx.y;
  q += bh * sq * D;
  dout += bh * sq * D;
  dq += bh * sq * D;
  lse += bh * sq;
  dmd += bh * sq;
  k += bh * sk * D;
  v += bh * sk * D;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  float row_lse[TR], row_dmd[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty * TR + i;
    row_lse[i] = row < sq ? lse[row] : 0.f;
    row_dmd[i] = row < sq ? dmd[row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  load_tile<T, D>(s_q, q, q0, sq);
  load_tile<T, D>(s_do, dout, q0, sq);
  const int live = live_k_tiles(q0, sq, sk, shift, causal);
  for (int kt = 0; kt < live; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile<T, D>(s_k, k, k0, sk);
    load_tile<T, D>(s_v, v, k0, sk);
    __syncthreads();

    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[TR], g[TR], b[TC], w[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        a[i] = s_q[(ty * TR + i) * LD + d];
        g[i] = s_do[(ty * TR + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        b[j] = s_k[(tx + 8 * j) * LD + d];
        w[j] = s_v[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty * TR + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const bool vis = visible(row, k0 + tx + 8 * j, sq, sk, shift, causal);
        const float p = vis ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        s_ds[(ty * TR + i) * PLD + tx + 8 * j] = p * (dp[i][j] - row_dmd[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float ds[TR], kk[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) ds[i] = s_ds[(ty * TR + i) * PLD + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) kk[jj] = s_k[c * LD + tx + 8 * jj];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(ds[i], kk[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty * TR + i;
    if (row >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) store(dq + (size_t)row * D + tx + 8 * jj, scale * acc[i][jj]);
  }
}

// ---------------------------------------------------------------------------
// dk / dv
//
// Replaces katib_tpu/ops/flash_attention.py::_dkv_kernel (:190, launched by
// _bwd :263).  One block per (k tile, batch x head); k tile 0, which sees
// the most causal rows, is block 0.  Holds its K and V tile, streams the q
// tiles (with their dO, lse and dmd rows) from the first one on or below
// the diagonal, first_qt = max(0, k0 - shift) / 64, so the sums stay in
// the block: dv += p^T.dO and dk += scale * ds^T.q in float32 registers,
// no atomics.
// Bound on the H100: operations (4 products of 2*D flops per visible pair).
// Same float32-FMA design; p and ds go through shared memory once per tile.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ dmd, T* __restrict__ dk, T* __restrict__ dv, int sq,
                 int sk, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DC = D / 8;
  float* s_k = smem;
  float* s_v = s_k + TILE * LD;
  float* s_q = s_v + TILE * LD;
  float* s_do = s_q + TILE * LD;
  float* s_p = s_do + TILE * LD;
  float* s_ds = s_p + TILE * PLD;
  float* s_lse = s_ds + TILE * PLD;
  float* s_dmd = s_lse + TILE;

  const int shift = sk - sq;
  const int k0 = (int)blockIdx.x * TILE;
  const size_t bh = blockIdx.y;
  q += bh * sq * D;
  dout += bh * sq * D;
  lse += bh * sq;
  dmd += bh * sq;
  k += bh * sk * D;
  v += bh * sk * D;
  dk += bh * sk * D;
  dv += bh * sk * D;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  float dk_acc[TR][DC], dv_acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  load_tile<T, D>(s_k, k, k0, sk);
  load_tile<T, D>(s_v, v, k0, sk);
  const int n_qt = (sq + TILE - 1) / TILE;
  const int first_qt = causal ? max(0, k0 - shift) / TILE : 0;
  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile<T, D>(s_q, q, q0, sq);
    load_tile<T, D>(s_do, dout, q0, sq);
    load_rows(s_lse, lse, q0, sq);
    load_rows(s_dmd, dmd, q0, sq);
    __syncthreads();

    // transposed scores: rows are this block's keys, columns the queries
    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[TR], w[TR], b[TC], g[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        a[i] = s_k[(ty * TR + i) * LD + d];
        w[i] = s_v[(ty * TR + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        b[j] = s_q[(tx + 8 * j) * LD + d];
        g[j] = s_do[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int col = k0 + ty * TR + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int r = tx + 8 * j;
        const bool vis = visible(q0 + r, col, sq, sk, shift, causal);
        const float p = vis ? expf(s[i][j] * scale - s_lse[r]) : 0.f;
        s_p[(ty * TR + i) * PLD + r] = p;
        s_ds[(ty * TR + i) * PLD + r] = p * (dp[i][j] - s_dmd[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < TILE; ++r) {
      float p[TR], ds[TR], qq[DC], gg[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        p[i] = s_p[(ty * TR + i) * PLD + r];
        ds[i] = s_ds[(ty * TR + i) * PLD + r];
      }
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        qq[jj] = s_q[r * LD + tx + 8 * jj];
        gg[jj] = s_do[r * LD + tx + 8 * jj];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          dv_acc[i][jj] = fmaf(p[i], gg[jj], dv_acc[i][jj]);
          dk_acc[i][jj] = fmaf(ds[i], qq[jj], dk_acc[i][jj]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int col = k0 + ty * TR + i;
    if (col >= sk) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      store(dk + (size_t)col * D + tx + 8 * jj, scale * dk_acc[i][jj]);
      store(dv + (size_t)col * D + tx + 8 * jj, dv_acc[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers: dynamic shared memory above 48 KB needs the attribute raised
// once per instantiation and device, before the first launch there (and so
// outside any CUDA graph capture, which the callers warm up before)
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int sq, int sk, float scale, int causal, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const size_t smem = (3 * TILE * (D + 1) + TILE * PLD) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + TILE - 1) / TILE, bh);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, sq, sk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dmd, void* dq, int bh, int sq, int sk,
                      float scale, int causal, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const size_t smem = (4 * TILE * (D + 1) + TILE * PLD) * sizeof(float);
  cudaError_t err = allow_smem(flash_dq_kernel<T, D>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + TILE - 1) / TILE, bh);
  flash_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse, (const float*)dmd, (T*)dq, sq, sk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dmd, void* dk, void* dv, int bh, int sq,
                       int sk, float scale, int causal, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const size_t smem = (4 * TILE * (D + 1) + 2 * TILE * PLD + 2 * TILE) * sizeof(float);
  cudaError_t err = allow_smem(flash_dkv_kernel<T, D>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + TILE - 1) / TILE, bh);
  flash_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse, (const float*)dmd, (T*)dk, (T*)dv, sq, sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// one instantiation per (dtype, head dim): dtype 0 = float32, 1 = bfloat16
#define KATIB_FLASH_DISPATCH(LAUNCH, d, dtype, ...)                              \
  switch ((d) * 2 + (dtype)) {                                                  \
    case 64: return (int)LAUNCH<float, 32>(__VA_ARGS__);                        \
    case 65: return (int)LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);                \
    case 128: return (int)LAUNCH<float, 64>(__VA_ARGS__);                       \
    case 129: return (int)LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);               \
    case 256: return (int)LAUNCH<float, 128>(__VA_ARGS__);                      \
    case 257: return (int)LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);              \
    default: return (int)cudaErrorInvalidValue;                                 \
  }

// o [bh, sq, d] and lse [bh, sq] from q [bh, sq, d], k and v [bh, sk, d]
extern "C" int katib_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int bh, int sq, int sk, int d, float scale, int causal, int dtype,
                               void* stream) {
  KATIB_FLASH_DISPATCH(launch_fwd, d, dtype, q, k, v, o, lse, bh, sq, sk, scale, causal,
                       (cudaStream_t)stream)
}

// dq [bh, sq, d]; dmd = rowsum(dO * O) - dlse, [bh, sq] float32
extern "C" int katib_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* dmd, void* dq, int bh, int sq, int sk,
                              int d, float scale, int causal, int dtype, void* stream) {
  KATIB_FLASH_DISPATCH(launch_dq, d, dtype, q, k, v, dout, lse, dmd, dq, bh, sq, sk, scale,
                       causal, (cudaStream_t)stream)
}

// dk and dv [bh, sk, d]
extern "C" int katib_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* dmd, void* dk, void* dv, int bh,
                               int sq, int sk, int d, float scale, int causal, int dtype,
                               void* stream) {
  KATIB_FLASH_DISPATCH(launch_dkv, d, dtype, q, k, v, dout, lse, dmd, dk, dv, bh, sq, sk, scale,
                       causal, (cudaStream_t)stream)
}

extern "C" const char* katib_flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
