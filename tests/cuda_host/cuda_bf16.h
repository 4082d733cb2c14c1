// Host stand-in for cuda_bf16.h (round-to-nearest-even conversions) and the
// per-lane semantics of the PTX instructions the tensor-core kernels use,
// which tests substitute for the bodies of the kernels' PTX helpers: each
// lane posts its operands to the warp buffer, and after a warp barrier
// reads back what the instruction would hand it.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};  // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}

// cp.async with src_size 0 or n: a synchronous copy or zero fill
inline void host_cp_async(void* dst, const void* src, bool valid, size_t n) {
  if (valid) std::memcpy(dst, src, n);
  else std::memset(dst, 0, n);
}

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lanes 8i..8i+7 give the
// rows of matrix i; r[i] gets row lane/4, columns 2(lane%4) + {0,1}, or
// with trans rows 2(lane%4) + {0,1} of column lane/4
inline void host_ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row, bool trans) {
  const int l = host_lane();
  host_slot(l)[0] = reinterpret_cast<uint64_t>(row);
  host_warp_sync();
  for (int i = 0; i < 4; ++i) {
    uint32_t e[2];
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat16* base =
          reinterpret_cast<const __nv_bfloat16*>(host_slot(8 * i + (trans ? 2 * (l & 3) + h : l >> 2))[0]);
      e[h] = (trans ? base[l >> 2] : base[2 * (l & 3) + h]).x;
    }
    r[i] = e[0] | (e[1] << 16);
  }
  host_warp_sync();
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, with the PTX ISA's
// fragment layouts (g = lane/4, t = lane%4): A (g | g+8, 2t.. | 2t+8..),
// B (k 2t.. | 2t+8.., n g), C (g | g+8, 2t + {0,1})
inline void host_mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int l = host_lane();
  uint64_t* mine = host_slot(l);
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  host_warp_sync();
  auto value = [](uint64_t reg, int k) {
    return __bfloat162float({uint16_t(uint32_t(reg) >> (16 * (k & 1)))});
  };
  for (int e = 0; e < 4; ++e) {
    const int row = (l >> 2) + 8 * (e >> 1), col = 2 * (l & 3) + (e & 1);
    float acc = c[e];
    for (int k = 0; k < 16; ++k) {
      const uint64_t a_reg = host_slot((row & 7) * 4 + ((k & 7) >> 1))[(row >= 8) + 2 * (k >= 8)];
      const uint64_t b_reg = host_slot(col * 4 + ((k & 7) >> 1))[4 + (k >= 8)];
      acc += value(a_reg, k) * value(b_reg, k);
    }
    c[e] = acc;
  }
  host_warp_sync();
}
