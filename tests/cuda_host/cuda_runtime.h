// Host stand-in for the part of the CUDA runtime that the port's kernel
// sources use, so that tests can compile a .cu file with a host C++20
// compiler and run its kernels on the CPU.  Each block runs as THREADS
// std::threads; __syncthreads is a block barrier and the warp-collective
// operations exchange values through a per-warp buffer between two warp
// barriers.  Blocks run one after another.  Used by
// tests/test_torch_flash_attention.py; not part of the package.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(threads)
#define __restrict__ __restrict

struct uint3 { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct uint4 { unsigned x, y, z, w; };
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidDevice = 101,
  cudaErrorMisalignedAddress = 716,
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
template <typename Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t err) { return err ? "host stand-in error" : "no error"; }

struct HostBlock {
  std::barrier<> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  uint64_t lanes[32][32][8];  // [warp][lane][slot]: the warp exchange buffer
  unsigned char* smem;
  explicit HostBlock(int threads) : block(threads) {
    for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new std::barrier<>(32));
  }
};
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local HostBlock* host_block;

inline void __syncthreads() { host_block->block.arrive_and_wait(); }
inline unsigned char* host_shared_memory() { return host_block->smem; }
inline int host_lane() { return threadIdx.x & 31; }
inline uint64_t* host_slot(int lane) { return host_block->lanes[threadIdx.x >> 5][lane]; }
inline void host_warp_sync() { host_block->warps[threadIdx.x >> 5]->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float x, int lane_mask) {
  std::memcpy(host_slot(host_lane()), &x, sizeof x);
  host_warp_sync();
  float y;
  std::memcpy(&y, host_slot(host_lane() ^ lane_mask), sizeof y);
  host_warp_sync();
  return y;
}

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// host_launch(grid, threads, smem, stream, [=] { kernel(args); })
template <typename Body>
void host_launch(dim3 grid, int threads, size_t smem, cudaStream_t, Body body) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      HostBlock blk(threads);
      std::vector<unsigned char> buffer(smem + 128);
      blk.smem = buffer.data() + (128 - reinterpret_cast<uintptr_t>(buffer.data()) % 128) % 128;
      std::memset(blk.smem, 0xA5, smem);  // shared memory starts as garbage
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          host_block = &blk;
          body();
        });
      for (auto& t : ts) t.join();
    }
}
