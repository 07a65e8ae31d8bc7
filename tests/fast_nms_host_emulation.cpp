// Host build of csrc/fast_nms.cu's kernel body for CPU tests: the CUDA
// qualifiers become no-ops and every intrinsic the kernel uses gets a host
// form with the same two-lane 16-bit semantics. The kernel's phases are
// functions of the thread index, so a block runs as the device runs it, with
// the same number of threads: each phase for every thread in turn, the next
// phase where the device has its barrier. The grid is walked by a loop over
// the same table of levels the device launch builds.
//
//   fast_nms_emu MODE BORDER C N_LEVELS H_0 W_0 ... H_{n-1} W_{n-1}
//
// MODE 0 is the full map, 1 the per-cell maximum. Reads the levels'
// [C, H_l, W_l] float32 images from stdin one after another and writes the
// int32 outputs to stdout in the same order.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
using std::max;
using std::min;

struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
static inline int2 make_int2(int x, int y) { return {x, y}; }
#define __global__
#define __device__
#define __forceinline__ inline
static inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
static inline uint32_t __byte_perm(uint32_t a, uint32_t b, uint32_t sel) {
  const uint64_t all = ((uint64_t)b << 32) | a;
  uint32_t out = 0;
  for (int i = 0; i < 4; ++i) out |= (uint32_t)((all >> (8 * ((sel >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return out;
}
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t shift) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (shift & 31));
}
template <class F>
static inline uint32_t lanes_s16x2(uint32_t a, uint32_t b, F f) {
  const int16_t lo = f((int16_t)(a & 0xffff), (int16_t)(b & 0xffff));
  const int16_t hi = f((int16_t)(a >> 16), (int16_t)(b >> 16));
  return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}
static inline uint32_t __vmins2(uint32_t a, uint32_t b) {
  return lanes_s16x2(a, b, [](int16_t x, int16_t y) { return std::min(x, y); });
}
static inline uint32_t __vmaxs2(uint32_t a, uint32_t b) {
  return lanes_s16x2(a, b, [](int16_t x, int16_t y) { return std::max(x, y); });
}
static inline uint32_t __vimin3_s16x2(uint32_t a, uint32_t b, uint32_t c) {
  return __vmins2(__vmins2(a, b), c);
}
static inline uint32_t __vimax3_s16x2(uint32_t a, uint32_t b, uint32_t c) {
  return __vmaxs2(__vmaxs2(a, b), c);
}
#define FAST_NMS_HOST_EMULATION
#include "fast_nms.cu"

template <bool TILE_MAX>
static void run_block(const FastParams& p, int bx, int frame) {
  static FastSmem sm;
  const FastTile t = fast_tile(p, bx, frame, TILE_MAX);
  for (int tid = 0; tid < FAST_THREADS; ++tid) fast_stage(sm, t, tid);
  for (int tid = 0; tid < FAST_THREADS; ++tid) fast_score(sm, t, tid);
  for (int tid = 0; tid < FAST_THREADS; ++tid) fast_nms<TILE_MAX>(sm, t, p.border, tid);
  if (TILE_MAX) {
    for (int tid = 0; tid < FAST_THREADS; ++tid) fast_cell_columns(sm, tid);
    for (int tid = 0; tid < FAST_THREADS; ++tid) fast_cell_store(sm, t, tid);
  }
}

int main(int argc, char** argv) {
  if (argc < 7) return 2;
  const int mode = atoi(argv[1]), border = atoi(argv[2]), C = atoi(argv[3]), n = atoi(argv[4]);
  if (n < 1 || argc != 5 + 2 * n) return 2;
  std::vector<int> hs(n), ws(n);
  std::vector<std::vector<float>> in(n);
  std::vector<std::vector<int>> out(n);
  std::vector<const void*> ins(n);
  std::vector<void*> outs(n);
  for (int l = 0; l < n; ++l) {
    hs[l] = atoi(argv[5 + 2 * l]);
    ws[l] = atoi(argv[6 + 2 * l]);
    const size_t px = (size_t)C * hs[l] * ws[l];
    in[l].resize(px);
    if (fread(in[l].data(), sizeof(float), px, stdin) != px) return 3;
    out[l].assign(mode ? (size_t)C * ((hs[l] + 15) / 16) * ((ws[l] + 15) / 16) : px, -1);
    ins[l] = in[l].data();
    outs[l] = out[l].data();
  }
  FastParams p;
  const int tiles = fast_fill_params(&p, ins.data(), outs.data(), hs.data(), ws.data(), n, border);
  if (tiles <= 0) return 4;
  for (int z = 0; z < C; ++z)
    for (int b = 0; b < tiles; ++b) {
      if (mode) run_block<true>(p, b, z); else run_block<false>(p, b, z);
    }
  for (int l = 0; l < n; ++l) fwrite(out[l].data(), sizeof(int), out[l].size(), stdout);
  return 0;
}
