// Dense FAST-9/16 score + 3x3 non-max suppression + index packing for Hopper.
//
// Replaces the Pallas TPU kernel `fast_nms_comb` / `_kernel` of the reference
// package (eao_slam_tpu/ops/fast_pallas.py:34-94). Computes, for every pixel
// of every level image of a chunk [C, H, W] (float32, integer grey levels):
//
//   score(p) = max over {bright, dark} of max over 16 start positions of the
//              min over an arc of 9 consecutive differences on the 16-point
//              Bresenham ring of radius 3 (reads edge-clamped);
//   keep(p)  = score(p) >= each of its 8 neighbours' scores (neighbours
//              outside the image count as -inf);
//   out(p)   = (keep && p at least `border` from every edge
//                 ? clamp(score, 0, 1023) : 0) << 20 | (y * W + x).
//
// Design: one launch covers one pyramid level of a whole chunk (grid.z = C).
// Each 256-thread block owns a TILE_H x TILE_W output tile: it stages the
// tile plus a 4-pixel halo (ring radius 3 + 1 for the NMS) in shared memory
// as integers, computes the score on the tile plus a 1-pixel ring into
// shared memory, then suppresses and packs from shared memory. Every input
// pixel is read from device memory about 1.4 times (halo overlap) and every
// output written once.
//
// What bounds it on an H100: per pixel it must move 8 bytes (4 read, 4
// written) and do ~205 integer operations (32 ring differences, 2 x (64 mins
// + 15 maxes) for the arcs, 8 NMS maxes, masking and packing). For the
// ~0.95 M pixels of one 640x480 frame's 8 levels that is 7.6 MB (~2.3 us at
// 3.35 TB/s) and ~0.19 G operations (~2.9 us at the 67 T/s float32 vector
// rate): a few microseconds per frame either way, operations slightly ahead.
// The kernel keeps all intermediates in shared memory and registers, so it
// moves only the bytes it must.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (eao_slam_torch/ops/fast_nms.py).
// FAST_NMS_HOST_EMULATION compiles only the kernel body, as plain C++ with
// one thread per block, for the CPU test tests/fast_nms_host_emulation.cpp.

#ifndef FAST_NMS_HOST_EMULATION
#include <cuda_runtime.h>
#endif
#include <climits>

#define TILE_W 32
#define TILE_H 16
#define HALO 4
#ifndef THREADS
#define THREADS 256
#endif
#define PIX_W (TILE_W + 2 * HALO)
#define PIX_H (TILE_H + 2 * HALO)
#define SC_W (TILE_W + 2)
#define SC_H (TILE_H + 2)

__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ int arc9_max_min(const int d[16]) {
  int e2[16], e4[16], e8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) e2[i] = min(d[i], d[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) e4[i] = min(e2[i], e2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) e8[i] = min(e4[i], e4[(i + 4) & 15]);
  int m = min(e8[0], d[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) m = max(m, min(e8[i], d[(i + 8) & 15]));
  return m;
}

__global__ void __launch_bounds__(THREADS)
fast_nms_comb_kernel(const float* __restrict__ in, int* __restrict__ out,
                     int H, int W, int border) {
  __shared__ int pix[PIX_H][PIX_W];
  __shared__ int sc[SC_H][SC_W];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const long long plane = (long long)H * W;
  const float* img = in + (long long)blockIdx.z * plane;
  int* dst = out + (long long)blockIdx.z * plane;

  // 1. tile + halo, edge-clamped, as integers
  for (int i = tid; i < PIX_H * PIX_W; i += THREADS) {
    const int r = i / PIX_W, c = i % PIX_W;
    const int gy = min(max(y0 - HALO + r, 0), H - 1);
    const int gx = min(max(x0 - HALO + c, 0), W - 1);
    pix[r][c] = __float2int_rn(img[(long long)gy * W + gx]);
  }
  __syncthreads();

  // 2. FAST score on the tile plus a 1-pixel ring (-inf outside the image)
  for (int i = tid; i < SC_H * SC_W; i += THREADS) {
    const int r = i / SC_W, c = i % SC_W;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    int s = INT_MIN;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int py = r + HALO - 1, px = c + HALO - 1;
      const int center = pix[py][px];
      int db[16], dd[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int v = pix[py + kRingDy[k]][px + kRingDx[k]];
        db[k] = v - center;
        dd[k] = center - v;
      }
      s = max(arc9_max_min(db), arc9_max_min(dd));
    }
    sc[r][c] = s;
  }
  __syncthreads();

  // 3. 3x3 NMS, border mask, pack
  for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W, c = i % TILE_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const int s = sc[r + 1][c + 1];
    int mx = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = max(mx, sc[r + dy][c + dx]);
    const bool inb = y >= border && y < H - border && x >= border && x < W - border;
    const int kept = (s >= mx && inb) ? min(max(s, 0), 1023) : 0;
    dst[(long long)y * W + x] = (kept << 20) | (y * W + x);
  }
}

#ifndef FAST_NMS_HOST_EMULATION
extern "C" int fast_nms_comb_launch(const void* in, void* out, int C, int H, int W,
                                    int border, void* stream) {
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, C);
  fast_nms_comb_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)in, (int*)out, H, W, border);
  return (int)cudaGetLastError();
}
#endif  // FAST_NMS_HOST_EMULATION
