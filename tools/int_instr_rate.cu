// Measures how many instructions of a class one SM starts per clock: the
// three-input and two-input two-lane 16-bit min/max the FAST kernel is made
// of, 32-bit integer add, and float32 multiply-add for comparison. Each
// thread runs 8 independent chains whose operands are the other chains, so
// nothing folds and nothing waits on latency. Built and timed by
// int_instr_rate.py; the bound of csrc/fast_nms.cu rests on its result.
#include <cuda_runtime.h>
#include <cstdint>

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b, uint32_t c, bool odd) {
  if (OP == 0) return odd ? __vimin3_s16x2(a, b, c) : __vimax3_s16x2(a, b, c);
  if (OP == 1) return odd ? __vmins2(a, b) : __vmaxs2(a, b);
  if (OP == 2) return a + b;
  return __float_as_uint(fmaf(__uint_as_float(a), __uint_as_float(b), __uint_as_float(c)));
}

template <int OP>
__global__ void rate_kernel(uint32_t* out, uint32_t seed, int iters) {
  uint32_t acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = seed * (threadIdx.x + 1) + 0x00010001u * k;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = step<OP>(acc[k], acc[(k + 1) & 7], acc[(k + 3) & 7], u & 1);
  }
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// Launches op (0 min/max3 s16x2, 1 min/max s16x2, 2 add, 3 fma) on `blocks`
// blocks of 256 threads; each thread executes 32 * iters instructions of the
// class. Returns the CUDA error of the launch.
extern "C" int rate_launch(int op, void* out, int blocks, int iters, void* stream) {
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) rate_kernel<0><<<blocks, 256, 0, s>>>(o, 12345u, iters);
  else if (op == 1) rate_kernel<1><<<blocks, 256, 0, s>>>(o, 12345u, iters);
  else if (op == 2) rate_kernel<2><<<blocks, 256, 0, s>>>(o, 12345u, iters);
  else rate_kernel<3><<<blocks, 256, 0, s>>>(o, 12345u, iters);
  return (int)cudaGetLastError();
}
