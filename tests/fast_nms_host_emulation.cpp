// Host build of csrc/fast_nms.cu's kernel body for CPU tests: the CUDA
// qualifiers become no-ops, every block runs with one thread (so the
// shared-memory phases run in order and __syncthreads is not needed), and
// the grid is walked by a loop. Reads C, H, W, border from argv and the
// [C, H, W] float32 levels from stdin; writes the [C, H, W] int32 map to
// stdout.
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>
using std::max;
using std::min;

struct Dim3 { int x, y, z; };
static Dim3 threadIdx, blockIdx;
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__ static
#define __shared__ static
#define __restrict__
#define __launch_bounds__(x)
#define __syncthreads()
static inline int __float2int_rn(float v) { return (int)std::nearbyint(v); }
#define FAST_NMS_HOST_EMULATION
#define THREADS 1
#include "fast_nms.cu"

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const int C = atoi(argv[1]), H = atoi(argv[2]), W = atoi(argv[3]), border = atoi(argv[4]);
  const size_t n = (size_t)C * H * W;
  std::vector<float> in(n);
  std::vector<int> out(n);
  if (fread(in.data(), sizeof(float), n, stdin) != n) return 3;
  threadIdx = {0, 0, 0};
  for (int z = 0; z < C; ++z)
    for (int by = 0; by < (H + TILE_H - 1) / TILE_H; ++by)
      for (int bx = 0; bx < (W + TILE_W - 1) / TILE_W; ++bx) {
        blockIdx = {bx, by, z};
        fast_nms_comb_kernel(in.data(), out.data(), H, W, border);
      }
  fwrite(out.data(), sizeof(int), n, stdout);
  return 0;
}
