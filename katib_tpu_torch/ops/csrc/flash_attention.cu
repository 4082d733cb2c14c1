// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Counterparts of the three Pallas TPU kernels in
// katib_tpu/ops/flash_attention.py (_fwd_kernel, _dq_kernel, _dkv_kernel),
// behind a plain C interface loaded with ctypes
// (katib_tpu_torch/ops/flash_attention.py).  Inputs are contiguous
// [B, H, S, D] tensors, float32 or bfloat16, D in {32, 64, 128}; every
// sum and every softmax statistic is float32, and bfloat16 outputs are
// rounded once at the store.
//
// Semantics (the JAX package's): the causal mask is bottom-right aligned,
// key j visible to query i iff j <= i + (Sk - Sq); a query row that sees no
// key gets output 0 and logsumexp -1e30.  The backward recomputes
// p = exp(scale * q.k - lse) from the saved logsumexp and applies the mask
// after the subtraction (a fully masked row has lse = -1e30, where the
// unmasked exponent would be +huge): masked entries are exactly 0.
//
// Two designs share the entry points.  Blocks run in parallel in no order,
// so in both each kernel walks its own loop over the other sequence's tiles;
// nothing carries between blocks and nothing is atomic.
//
// Tensor-core kernels: the three bfloat16 kernels (flash_fwd_kernel,
// flash_dq_kernel, flash_dkv_kernel).  Every product is mma.sync m16n8k16
// with bf16 operands and float32 accumulators; four warps per block, each
// owning 16 rows of the block's 64-row tile.  Operands come from bf16 tiles
// in swizzled shared memory through ldmatrix (.trans for the transposed
// ones), streamed by cp.async into a two-stage ring so the next tile lands
// while this one computes.  The scores, p and ds never leave registers: the
// accumulator fragment of the first product is the A fragment of the
// second, and a row's softmax statistics are reduced over the four lanes
// that hold it.  p and ds enter the second product as a bf16 pair,
// hi = bf16(x) and lo = bf16(x - hi), two MMAs into one float32
// accumulator: rounding them to one bf16 (2^-9 relative per term) would
// miss the one-bf16-spacing tolerance the kernels are held to by tens of
// times, the pair keeps 16 bits.  So the tensor cores do 3/2 of the
// forward's counted work, 4/3 of dq's and 6/4 of dk/dv's.
//
// float32-FMA kernels: the float32 forward, dq and dk/dv
// (flash_fwd_fma_kernel, flash_dq_fma_kernel, flash_dkv_fma_kernel).
// 64-row q and k tiles held in shared memory as float32 (row stride D + 1,
// so the column walks hit distinct banks); 128 threads, each owning a 4 x 8
// patch of the 64 x 64 score tile (rows ty*4 + i, columns tx + 8*j) and the
// matching 4 x D/8 patch of its output rows.  The eight threads of one row
// group are eight neighbouring lanes, so row reductions are three xor
// shuffles.  Products are plain float32 FMAs from shared memory: exact in
// f32 (which tensor cores would round) rather than fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int TILE = 64;        // rows of every q tile and every k tile
constexpr int THREADS = 128;    // 16 row groups x 8 column lanes
constexpr int TR = 4;           // score-tile rows per thread
constexpr int TC = 8;           // score-tile columns per thread, strided by 8
constexpr int PLD = TILE + 1;   // padded row stride of the 64 x 64 tiles
constexpr float MASK_VALUE = -1e30f;

// rows [row0, row0 + TILE) of a row-major [rows, D] matrix into shared
// memory, row stride D + 1; rows past the end read as 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int rows) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = row0 + r < rows ? src[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

// TILE entries of a per-row float32 vector from row0 on; 0 past the end
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) dst[r] = row0 + r < rows ? src[row0 + r] : 0.f;
}

// reductions over the LANES neighbouring lanes that share a row: eight in
// the FMA kernels' row groups, the four of a quad in an mma.sync C fragment
template <int LANES>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int mask = 1; mask < LANES; mask *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, mask));
  return x;
}

template <int LANES>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int mask = 1; mask < LANES; mask *= 2) x += __shfl_xor_sync(0xffffffffu, x, mask);
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
// float32 forward
//
// The float32 instantiation of katib_tpu/ops/flash_attention.py::_fwd_kernel
// (:60, launched by _fwd :121); the bfloat16 one is flash_fwd_kernel below.
// One block per (q tile, batch x head); q tiles are taken longest-first so
// the causal tail of the grid is short.  K and V stream through shared
// memory in 64-row tiles; the running (o, m, l) of the online softmax stay
// in float32 registers; causal tiles past the diagonal are skipped; the
// probabilities go through shared memory once per tile and never to device
// memory.  Its products run on the float32 FMA units (67 TFLOP/s).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float scale, int causal) {
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

  load_tile<D>(s_q, q, q0, sq);
  const int live = live_k_tiles(q0, sq, sk, shift, causal);
  for (int kt = 0; kt < live; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(s_k, k, k0, sk);
    load_tile<D>(s_v, v, k0, sk);
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
      const float m_new = fmaxf(m[i], group_max<8>(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        s_p[(ty * TR + i) * PLD + tx + 8 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group_sum<8>(rs);
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
      o[(size_t)row * D + tx + 8 * jj] = seen ? acc[i][jj] / l[i] : 0.f;
    if (tx == 0) lse[row] = seen ? m[i] + logf(l[i]) : MASK_VALUE;
  }
}

// ---------------------------------------------------------------------------
// float32 dq
//
// The float32 instantiation of katib_tpu/ops/flash_attention.py::_dq_kernel
// (:150, launched by _bwd :245); the bfloat16 one is flash_dq_kernel below.
// One block per (q tile, batch x head), longest causal rows first.  Streams
// K and V, recomputes p from the saved logsumexp, ds = p * (dO.v - dmd)
// with dmd = rowsum(dO * O) - dlse computed by the wrapper, and accumulates
// dq = scale * ds.k in float32 registers.  Same float32-FMA design as
// flash_fwd_fma_kernel; ds goes through shared memory once per tile and
// never to device memory.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dmd,
                    float* __restrict__ dq, int sq, int sk, float scale, int causal) {
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

  load_tile<D>(s_q, q, q0, sq);
  load_tile<D>(s_do, dout, q0, sq);
  const int live = live_k_tiles(q0, sq, sk, shift, causal);
  for (int kt = 0; kt < live; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile<D>(s_k, k, k0, sk);
    load_tile<D>(s_v, v, k0, sk);
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
    for (int jj = 0; jj < DC; ++jj) dq[(size_t)row * D + tx + 8 * jj] = scale * acc[i][jj];
  }
}

// ---------------------------------------------------------------------------
// float32 dk / dv
//
// The float32 instantiation of katib_tpu/ops/flash_attention.py::_dkv_kernel
// (:190, launched by _bwd :263); the bfloat16 one is flash_dkv_kernel below.
// One block per (k tile, batch x head); k tile 0, which sees the most
// causal rows, is block 0.  Holds its K and V tile, streams the q tiles
// (with their dO, lse and dmd rows) from the first one on or below the
// diagonal, first_qt = max(0, k0 - shift) / 64, so the sums stay in the
// block: dv += p^T.dO and dk += scale * ds^T.q in float32 registers, no
// atomics.  Same float32-FMA design; p and ds go through shared memory once
// per tile.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dmd,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, float scale,
                     int causal) {
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

  load_tile<D>(s_k, k, k0, sk);
  load_tile<D>(s_v, v, k0, sk);
  const int n_qt = (sq + TILE - 1) / TILE;
  const int first_qt = causal ? max(0, k0 - shift) / TILE : 0;
  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile<D>(s_q, q, q0, sq);
    load_tile<D>(s_do, dout, q0, sq);
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
      dk[(size_t)col * D + tx + 8 * jj] = scale * dk_acc[i][jj];
      dv[(size_t)col * D + tx + 8 * jj] = dv_acc[i][jj];
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core building blocks of the bfloat16 kernels: the only inline PTX
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;  // q rows per forward and dq block (16 per warp)
constexpr int BK = 64;  // k rows per dk/dv block (16 per warp), and per streamed k tile
static_assert(BK == TILE, "dq counts its k tiles with live_k_tiles");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without waiting; src_size 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared without waiting; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] holds row lane/4, columns 2(lane%4) + {0,1}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// the same, each matrix transposed: r[i] holds rows 2(lane%4) + {0,1}, column lane/4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, float32 accumulator.
// With g = lane/4, t = lane%4: a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
// a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..); b0 = (k 2t..2t+1, n g),
// b1 = (k 2t+8.., n g); c = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// shared-memory tiles and fragments of the tensor-core kernels
// ---------------------------------------------------------------------------

// A bf16 tile of rows x D lies in shared memory as 16-byte chunks, D/8 to a
// row, with the chunk index XORed by the row so that the eight rows one
// ldmatrix reads at the same column fall in eight distinct bank groups
// (D = 32: two rows share a 128-byte line, so the XOR takes row/2).
// Returns the element offset of (row, 8 * chunk).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CH = D / 8;
  return (row * CH + (chunk ^ (CH >= 8 ? row & 7 : (row >> 1) & 3))) * 8;
}

// rows [row0, row0 + ROWS) of a row-major [rows, D] bf16 matrix into a
// swizzled tile, asynchronously; rows past the end read as 0
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0, int rows) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool valid = row0 + r < rows;
    cp_async16(dst + swz<D>(r, c), src + (valid ? (size_t)(row0 + r) * D + c * 8 : 0), valid);
  }
}

// ROWS entries of a per-row float32 vector from row0 on, asynchronously; 0 past the end
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int row0, int rows) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const bool valid = row0 + r < rows;
    cp_async4(dst + r, src + (valid ? row0 + r : 0), valid);
  }
}

// A fragment of rows [r0, r0 + 16) x columns [16 kk, 16 kk + 16) of a tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int kk,
                                       int lane) {
  ldmatrix_x4(a, tile + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B fragments of two n tiles (b[0], b[1]: n rows [n0, n0 + 8); b[2], b[3]:
// [n0 + 8, n0 + 16)) for a product against the tile's rows, contraction
// over its columns [16 kk, 16 kk + 16): the tile is B transposed
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile, int n0, int kk,
                                            int lane) {
  ldmatrix_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
}

// B fragments of two n tiles (columns [16 nn, 16 nn + 8) and the 8 after)
// for a contraction over the tile's rows [k0, k0 + 16): the tile is B
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile, int k0, int nn,
                                            int lane) {
  ldmatrix_x4_trans(b, tile + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                     2 * nn + (lane >> 4)));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x0, x1 (neighbouring columns) as hi = bf16(x), lo = bf16(x - hi), packed
// as an A-fragment register each
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A fragments (hi and lo) of columns [16 ks, 16 ks + 16) of a 16-row
// float32 accumulator: the C fragments of n tiles 2 ks and 2 ks + 1 are, in
// the same threads, the A fragment of that 16 x 16 block.
template <int N>
__device__ __forceinline__ void split_a(const float (&c)[N][4], int ks, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_bf16(c[2 * ks][0], c[2 * ks][1], hi[0], lo[0]);
  split_bf16(c[2 * ks][2], c[2 * ks][3], hi[1], lo[1]);
  split_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1], hi[2], lo[2]);
  split_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3], hi[3], lo[3]);
}

// acc[16 x D] += x[16 x 16 ks..] . tile[rows 16 ks.., D] for x split in hi and lo
template <int D, int N>
__device__ __forceinline__ void mma_split_rows(float (&acc)[D / 8][4], const float (&x)[N][4],
                                               const bf16* tile, int lane) {
#pragma unroll
  for (int ks = 0; ks < N / 2; ++ks) {
    uint32_t hi[4], lo[4];
    split_a(x, ks, hi, lo);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b[4];
      load_b_cols<D>(b, tile, 16 * ks, nn, lane);
      mma_bf16(acc[2 * nn], hi, b[0], b[1]);
      mma_bf16(acc[2 * nn], lo, b[0], b[1]);
      mma_bf16(acc[2 * nn + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * nn + 1], lo, b[2], b[3]);
    }
  }
}

// s[16 x N*8] = a_tile[r0.., D] . b_tile[N*8, D]^T and
// t = c_tile[r0.., D] . d_tile[N*8, D]^T, the two first products of a tile
template <int D, int N>
__device__ __forceinline__ void mma_pair_nt(float (&s)[N][4], float (&t)[N][4], const bf16* a_tile,
                                            const bf16* b_tile, const bf16* c_tile,
                                            const bf16* d_tile, int r0, int lane) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], c[4];
    load_a<D>(a, a_tile, r0, kk, lane);
    load_a<D>(c, c_tile, r0, kk, lane);
#pragma unroll
    for (int nn = 0; nn < N / 2; ++nn) {
      uint32_t b[4], d[4];
      load_b_rows<D>(b, b_tile, 16 * nn, kk, lane);
      load_b_rows<D>(d, d_tile, 16 * nn, kk, lane);
      mma_bf16(s[2 * nn], a, b[0], b[1]);
      mma_bf16(s[2 * nn + 1], a, b[2], b[3]);
      mma_bf16(t[2 * nn], c, d[0], d[1]);
      mma_bf16(t[2 * nn + 1], c, d[2], d[3]);
    }
  }
}

// s[16 x N*8] = a[16 x D] . b_tile[N*8, D]^T with a's A fragments in registers
template <int D, int N>
__device__ __forceinline__ void mma_nt(float (&s)[N][4], const uint32_t (&a)[D / 16][4],
                                       const bf16* b_tile, int lane) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int nn = 0; nn < N / 2; ++nn) {
      uint32_t b[4];
      load_b_rows<D>(b, b_tile, 16 * nn, kk, lane);
      mma_bf16(s[2 * nn], a[kk], b[0], b[1]);
      mma_bf16(s[2 * nn + 1], a[kk], b[2], b[3]);
    }
}

// scale * acc rounded to bf16 into rows row0 + g and row0 + g + 8 of a
// row-major [rows, D] matrix; rows past the end are not stored
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], float scale,
                                           int row0, int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + 8 * j + 2 * t) =
          __floats2bfloat162_rn(scale * acc[j][2 * h], scale * acc[j][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// forward, bfloat16
//
// Replaces katib_tpu/ops/flash_attention.py::_fwd_kernel (:60, launched by
// _fwd :121).  One block per (64-row q tile, batch x head), longest causal
// rows first; warp w owns q rows [16 w, 16 w + 16).  The block loads its q
// tile once through cp.async and keeps each warp's A fragments of it in
// registers; K and V stream in 64-row tiles through a two-stage cp.async
// ring, and k tiles past the diagonal are skipped.  Per k tile and warp:
// s = q.k^T on the tensor cores; the online softmax on s's C fragment in
// registers, in the exp2 domain (scale * log2 e folded into exp2's FMA),
// each row's max reduced over the four lanes of its quad, the running sum
// kept per lane and reduced once at the end; the accumulator rescaled by
// alpha = exp2(m_old - m_new); then o += p.V with p as a bf16 hi + lo pair.
// The running max starts at the finite -1e30, so a row whose tile is fully
// masked gets alpha = 1 and p = exp2(-inf) = 0, never inf - inf.  The mask
// is evaluated only on tiles that cross the diagonal or the ragged end.
// At the store o = acc / l, rounded once to bf16, and lse = m ln 2 + ln l;
// a row that saw no key (l = 0) gets o = 0 and lse = -1e30.
// Bound on the H100: operations, 2 products of 2*D flops per visible
// (query, key) pair at 989 TFLOP/s of bf16 tensor cores; the hi/lo pair
// makes the second product two MMAs, so the tensor cores do 3/2 of the
// counted work.  mma.sync fed by ldmatrix (one k and one v tile per 16
// rows of products), and each warp's softmax between its two products (an
// exp2 and about ten other instructions per score), keep it far below that
// peak; wgmma and TMA are the next step.
// ---------------------------------------------------------------------------
template <int D, bool MASK>
__device__ __forceinline__ void fwd_tile(float (&acc)[D / 8][4], float (&m)[2], float (&l)[2],
                                         const uint32_t (&qa)[D / 16][4], const bf16* s_k,
                                         const bf16* s_v, int q0, int k0, int sq, int sk,
                                         int causal, float scale_log2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[BK / 8][4];
  mma_nt<D>(s, qa, s_k, lane);
  float row_max[2] = {-INFINITY, -INFINITY};  // of the unscaled scores
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      if (MASK && !visible(q0 + 16 * warp + g + 8 * h, k0 + 8 * j + 2 * t + (e & 1), sq, sk,
                           sk - sq, causal))
        s[j][e] = -INFINITY;  // exp2(-inf) = 0: p is 0 before it is ever formed
      row_max[h] = fmaxf(row_max[h], s[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], group_max<4>(row_max[h]) * scale_log2);
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -m[e >> 1]));  // p
      l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
  mma_split_rows<D>(acc, s, s_v, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, float scale, int causal) {
  extern __shared__ uint4 tc_smem[];
  constexpr int KV = BK * D;  // elements of one k or v tile
  bf16* s_q = reinterpret_cast<bf16*>(tc_smem);
  bf16* s_k = s_q + BQ * D;  // two stages each of k and v
  bf16* s_v = s_k + 2 * KV;

  const int shift = sk - sq;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  q += bh * sq * D;
  o += bh * sq * D;
  lse += bh * sq;
  k += bh * sk * D;
  v += bh * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + 16 * warp;

  const int live = live_k_tiles(q0, sq, sk, shift, causal);
  load_tile_async<D, BQ>(s_q, q, q0, sq);
  if (live > 0) {
    load_tile_async<D, BK>(s_k, k, 0, sk);
    load_tile_async<D, BK>(s_v, v, 0, sk);
  }
  cp_async_commit();

  const float scale_log2 = scale * LOG2E;
  uint32_t qa[D / 16][4];
  float acc[D / 8][4], m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < live; ++kt) {
    if (kt + 1 < live) {  // the next tile into the other stage, read two iterations ago
      load_tile_async<D, BK>(s_k + ((kt + 1) & 1) * KV, k, (kt + 1) * BK, sk);
      load_tile_async<D, BK>(s_v + ((kt + 1) & 1) * KV, v, (kt + 1) * BK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {  // the q tile landed with the first k/v stage
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<D>(qa[kk], s_q, 16 * warp, kk, lane);
    }
    const int k0 = kt * BK;
    const bool full = k0 + BK <= sk && q0 + BQ <= sq && (!causal || k0 + BK - 1 <= q0 + shift);
    const bf16* kb = s_k + (kt & 1) * KV;
    const bf16* vb = s_v + (kt & 1) * KV;
    if (full)
      fwd_tile<D, false>(acc, m, l, qa, kb, vb, q0, k0, sq, sk, causal, scale_log2);
    else
      fwd_tile<D, true>(acc, m, l, qa, kb, vb, q0, k0, sq, sk, causal, scale_log2);
    __syncthreads();  // this stage is free for the load two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = group_sum<4>(l[h]);
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][2 * h] *= inv;
      acc[j][2 * h + 1] *= inv;
    }
    const int row = row0 + (lane >> 2) + 8 * h;
    if ((lane & 3) == 0 && row < sq)
      lse[row] = l[h] > 0.f ? m[h] / LOG2E + logf(l[h]) : MASK_VALUE;
  }
  store_rows<D>(o, acc, 1.f, row0, sq, lane);
}

// ---------------------------------------------------------------------------
// dq, bfloat16
//
// Replaces katib_tpu/ops/flash_attention.py::_dq_kernel (:150, launched by
// _bwd :245).  One block per (64-row q tile, batch x head), longest causal
// rows first; warp w owns q rows [16 w, 16 w + 16).  The block keeps its q
// and dO tiles and streams K and V in 64-row tiles through a two-stage
// cp.async ring.  Per k tile and warp: s = q.k^T and dp = dO.v^T on the
// tensor cores, then in registers p = exp(scale * s - lse) and
// ds = p * (dp - dmd), dmd = rowsum(dO * O) - dlse from the wrapper; then
// dq += ds.k with ds as a bf16 hi + lo pair.  The mask is evaluated only on
// tiles that cross the diagonal or the ragged end.
// Bound on the H100: operations, 3 products of 2*D flops per visible
// (query, key) pair at 989 TFLOP/s of bf16 tensor cores; the hi/lo pair
// makes the third product two MMAs, so the tensor cores do 4/3 of the
// counted work.  Per tile and warp the ldmatrix traffic is 3 k/v tiles for
// 16 rows of products, which caps mma.sync well below that peak; wgmma and
// TMA are the next step.
// ---------------------------------------------------------------------------
template <int D, bool MASK>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4], const bf16* s_q, const bf16* s_do,
                                        const bf16* s_k, const bf16* s_v, int q0, int k0, int sq,
                                        int sk, int causal, float scale_log2,
                                        const float (&lse2)[2], const float (&row_dmd)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[BK / 8][4], dp[BK / 8][4];
  mma_pair_nt<D>(s, dp, s_q, s_k, s_do, s_v, 16 * warp, lane);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float x = fmaf(s[j][e], scale_log2, -lse2[h]);
      if (MASK && !visible(q0 + 16 * warp + g + 8 * h, k0 + 8 * j + 2 * t + (e & 1), sq, sk,
                           sk - sq, causal))
        x = -INFINITY;  // exp2(-inf) = 0: p is 0 before it is ever formed
      s[j][e] = exp2f(x) * (dp[j][e] - row_dmd[h]);  // ds
    }
  mma_split_rows<D>(acc, s, s_k, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dmd, bf16* __restrict__ dq, int sq, int sk, float scale,
                int causal) {
  extern __shared__ uint4 tc_smem[];
  constexpr int KV = BK * D;  // elements of one k or v tile
  bf16* s_q = reinterpret_cast<bf16*>(tc_smem);
  bf16* s_do = s_q + BQ * D;
  bf16* s_k = s_do + BQ * D;  // two stages each of k and v
  bf16* s_v = s_k + 2 * KV;

  const int shift = sk - sq;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  q += bh * sq * D;
  dout += bh * sq * D;
  dq += bh * sq * D;
  lse += bh * sq;
  dmd += bh * sq;
  k += bh * sk * D;
  v += bh * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + 16 * warp;

  const int live = live_k_tiles(q0, sq, sk, shift, causal);
  load_tile_async<D, BQ>(s_q, q, q0, sq);
  load_tile_async<D, BQ>(s_do, dout, q0, sq);
  if (live > 0) {
    load_tile_async<D, BK>(s_k, k, 0, sk);
    load_tile_async<D, BK>(s_v, v, 0, sk);
  }
  cp_async_commit();

  const float scale_log2 = scale * LOG2E;
  float lse2[2], row_dmd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (lane >> 2) + 8 * h;
    lse2[h] = row < sq ? lse[row] * LOG2E : 0.f;
    row_dmd[h] = row < sq ? dmd[row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < live; ++kt) {
    if (kt + 1 < live) {  // the next tile into the other stage, read two iterations ago
      load_tile_async<D, BK>(s_k + ((kt + 1) & 1) * KV, k, (kt + 1) * BK, sk);
      load_tile_async<D, BK>(s_v + ((kt + 1) & 1) * KV, v, (kt + 1) * BK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * BK;
    const bool full = k0 + BK <= sk && q0 + BQ <= sq && (!causal || k0 + BK - 1 <= q0 + shift);
    const bf16* kb = s_k + (kt & 1) * KV;
    const bf16* vb = s_v + (kt & 1) * KV;
    if (full)
      dq_tile<D, false>(acc, s_q, s_do, kb, vb, q0, k0, sq, sk, causal, scale_log2, lse2, row_dmd);
    else
      dq_tile<D, true>(acc, s_q, s_do, kb, vb, q0, k0, sq, sk, causal, scale_log2, lse2, row_dmd);
    __syncthreads();  // this stage is free for the load two tiles on
  }
  cp_async_wait<0>();
  store_rows<D>(dq, acc, scale, row0, sq, lane);
}

// ---------------------------------------------------------------------------
// dk / dv, bfloat16
//
// Replaces katib_tpu/ops/flash_attention.py::_dkv_kernel (:190, launched by
// _bwd :263).  One block per (64-row k tile, batch x head); k tile 0, which
// sees the most causal rows, is block 0; warp w owns keys [16 w, 16 w + 16).
// The block keeps its K and V tile and streams q tiles (with their dO, lse
// and dmd rows) through a two-stage cp.async ring from the first one on or
// below the diagonal, first_qt = max(0, k0 - shift) / BQ, so the sums stay
// in the block and nothing is atomic.  Per q tile and warp, in transposed
// form with keys as rows: s^T = k.q^T and dp^T = v.dO^T on the tensor
// cores, p^T and ds^T in registers, then dv += p^T.dO and dk += ds^T.q with
// p^T and ds^T as bf16 hi + lo pairs; dk is scaled once at the store.
// D = 128 streams 32-row q tiles so that the two D-wide accumulators and
// the score fragments fit in registers.
// Bound on the H100: operations, 4 products of 2*D flops per visible pair
// at 989 TFLOP/s; the hi/lo pairs make the tensor cores do 6/4 of that.
// ---------------------------------------------------------------------------
template <int D>
constexpr int DKV_QR = D >= 128 ? 32 : 64;  // q rows per streamed dk/dv tile

template <int D, bool MASK>
__device__ __forceinline__ void dkv_tile(float (&dk)[D / 8][4], float (&dv)[D / 8][4],
                                         const bf16* s_k, const bf16* s_v, const bf16* s_q,
                                         const bf16* s_do, const float* s_lse, const float* s_dmd,
                                         int q0, int k0, int sq, int sk, int causal,
                                         float scale_log2) {
  constexpr int QR = DKV_QR<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[QR / 8][4], dp[QR / 8][4];
  mma_pair_nt<D>(s, dp, s_k, s_q, s_v, s_do, 16 * warp, lane);
#pragma unroll
  for (int j = 0; j < QR / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(s_lse + 8 * j + 2 * t);
    const float2 m = *reinterpret_cast<const float2*>(s_dmd + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      float x = fmaf(s[j][e], scale_log2, -(c ? l.y : l.x) * LOG2E);
      if (MASK && !visible(q0 + 8 * j + 2 * t + c, k0 + 16 * warp + g + 8 * (e >> 1), sq, sk,
                           sk - sq, causal))
        x = -INFINITY;  // exp2(-inf) = 0: p is 0 before it is ever formed
      s[j][e] = exp2f(x);                               // p^T
      dp[j][e] = s[j][e] * (dp[j][e] - (c ? m.y : m.x));  // ds^T
    }
  }
  mma_split_rows<D>(dv, s, s_do, lane);
  mma_split_rows<D>(dk, dp, s_q, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dmd,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, float scale,
                 int causal) {
  constexpr int QR = DKV_QR<D>;
  constexpr int QT = QR * D;  // elements of one q or dO tile
  extern __shared__ uint4 tc_smem[];
  bf16* s_k = reinterpret_cast<bf16*>(tc_smem);
  bf16* s_v = s_k + BK * D;
  bf16* s_q = s_v + BK * D;  // two stages each of q and dO, then of lse and dmd
  bf16* s_do = s_q + 2 * QT;
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * QT);
  float* s_dmd = s_lse + 2 * QR;

  const int shift = sk - sq;
  const int k0 = (int)blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  q += bh * sq * D;
  dout += bh * sq * D;
  lse += bh * sq;
  dmd += bh * sq;
  k += bh * sk * D;
  v += bh * sk * D;
  dk += bh * sk * D;
  dv += bh * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int n_qt = (sq + QR - 1) / QR;
  const int first_qt = causal ? max(0, k0 - shift) / QR : 0;
  auto load_q_stage = [&](int qt) {
    const int st = (qt - first_qt) & 1;
    load_tile_async<D, QR>(s_q + st * QT, q, qt * QR, sq);
    load_tile_async<D, QR>(s_do + st * QT, dout, qt * QR, sq);
    load_rows_async<QR>(s_lse + st * QR, lse, qt * QR, sq);
    load_rows_async<QR>(s_dmd + st * QR, dmd, qt * QR, sq);
  };
  load_tile_async<D, BK>(s_k, k, k0, sk);
  load_tile_async<D, BK>(s_v, v, k0, sk);
  if (first_qt < n_qt) load_q_stage(first_qt);
  cp_async_commit();

  const float scale_log2 = scale * LOG2E;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int qt = first_qt; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) {  // the next tile into the other stage, read two iterations ago
      load_q_stage(qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * QR, st = (qt - first_qt) & 1;
    const bool full = q0 + QR <= sq && k0 + BK <= sk && (!causal || k0 + BK - 1 <= q0 + shift);
    if (full)
      dkv_tile<D, false>(dk_acc, dv_acc, s_k, s_v, s_q + st * QT, s_do + st * QT, s_lse + st * QR,
                         s_dmd + st * QR, q0, k0, sq, sk, causal, scale_log2);
    else
      dkv_tile<D, true>(dk_acc, dv_acc, s_k, s_v, s_q + st * QT, s_do + st * QT, s_lse + st * QR,
                        s_dmd + st * QR, q0, k0, sq, sk, causal, scale_log2);
    __syncthreads();  // this stage is free for the load two tiles on
  }
  cp_async_wait<0>();
  store_rows<D>(dk, dk_acc, scale, k0 + 16 * warp, sk, lane);
  store_rows<D>(dv, dv_acc, 1.f, k0 + 16 * warp, sk, lane);
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

// cp.async copies 16-byte chunks: the bf16 tensors must start 16-byte aligned
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int sq, int sk, float scale, int causal, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  if constexpr (std::is_same_v<T, bf16>) {
    if (!aligned16({q, k, v, o})) return cudaErrorMisalignedAddress;
    const size_t smem = (BQ * D + 4 * BK * D) * sizeof(bf16);
    cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem, ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, sq, sk, scale, causal);
  } else {
    const size_t smem = (3 * TILE * (D + 1) + TILE * PLD) * sizeof(float);
    cudaError_t err = allow_smem(flash_fwd_fma_kernel<D>, smem, ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + TILE - 1) / TILE, bh);
    flash_fwd_fma_kernel<D><<<grid, THREADS, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, sq, sk, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dmd, void* dq, int bh, int sq, int sk,
                      float scale, int causal, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  if constexpr (std::is_same_v<T, bf16>) {
    if (!aligned16({q, k, v, dout, dq})) return cudaErrorMisalignedAddress;
    const size_t smem = (2 * BQ * D + 4 * BK * D) * sizeof(bf16);
    cudaError_t err = allow_smem(flash_dq_kernel<D>, smem, ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    flash_dq_kernel<D><<<grid, THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse, (const float*)dmd, (bf16*)dq, sq, sk, scale, causal);
  } else {
    const size_t smem = (4 * TILE * (D + 1) + TILE * PLD) * sizeof(float);
    cudaError_t err = allow_smem(flash_dq_fma_kernel<D>, smem, ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + TILE - 1) / TILE, bh);
    flash_dq_fma_kernel<D><<<grid, THREADS, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dmd, (float*)dq, sq, sk, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dmd, void* dk, void* dv, int bh, int sq,
                       int sk, float scale, int causal, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  if constexpr (std::is_same_v<T, bf16>) {
    if (!aligned16({q, k, v, dout, dk, dv})) return cudaErrorMisalignedAddress;
    constexpr int QR = DKV_QR<D>;
    const size_t smem = (2 * BK * D + 4 * QR * D) * sizeof(bf16) + 4 * QR * sizeof(float);
    cudaError_t err = allow_smem(flash_dkv_kernel<D>, smem, ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((sk + BK - 1) / BK, bh);
    flash_dkv_kernel<D><<<grid, THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse, (const float*)dmd, (bf16*)dk, (bf16*)dv, sq, sk, scale, causal);
  } else {
    const size_t smem = (4 * TILE * (D + 1) + 2 * TILE * PLD + 2 * TILE) * sizeof(float);
    cudaError_t err = allow_smem(flash_dkv_fma_kernel<D>, smem, ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((sk + TILE - 1) / TILE, bh);
    flash_dkv_fma_kernel<D><<<grid, THREADS, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dmd, (float*)dk, (float*)dv, sq, sk, scale, causal);
  }
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
