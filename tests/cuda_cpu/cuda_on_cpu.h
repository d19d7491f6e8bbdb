// The few CUDA names videoyolo_torch/csrc/correlation.cu uses, on the CPU,
// so that g++ can build and run the source at small shapes in the tests
// (tests/test_torch_corr_grad_plan.py prepares the source: cp.async becomes
// memcpy, a launch becomes cuda_on_cpu_launch).  One OS thread per CUDA
// thread, a barrier for __syncthreads, the blocks of a grid one after
// another; dynamic shared memory is filled with NaN before each block, so a
// read of a float the block never staged shows in its output.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
struct uint3 {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim;
inline thread_local float* cuda_on_cpu_smem;
inline thread_local std::barrier<>* cuda_on_cpu_barrier;
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }
inline void __syncthreads() { cuda_on_cpu_barrier->arrive_and_wait(); }

inline void cuda_on_cpu_launch(dim3 grid, int threads, int smem, cudaStream_t, const std::function<void()>& body) {
  std::vector<float> shared((smem + 3) / 4 + 4);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::fill(shared.begin(), shared.end(), std::numeric_limits<float>::quiet_NaN());
        std::barrier<> barrier(threads);
        std::vector<std::thread> block;
        for (int t = 0; t < threads; ++t)
          block.emplace_back([&, t] {
            threadIdx = {unsigned(t), 0, 0};
            blockIdx = {x, y, z};
            blockDim = dim3(threads);
            cuda_on_cpu_smem = shared.data();
            cuda_on_cpu_barrier = &barrier;
            body();
          });
        for (auto& t : block) t.join();
      }
}
