// Dense FAST-9/16 score + 3x3 non-max suppression + index packing for Hopper,
// with the per-cell maximum of the packed map folded in.
//
// Replaces the Pallas TPU kernel `fast_nms_comb` / `_kernel` of the reference
// package (eao_slam_tpu/ops/fast_pallas.py:34-94). For every pixel of every
// level image of a chunk, [C, H, W] float32 holding integer grey levels
// (8-bit images and their rounded pyramid levels; any integer 0..16383):
//
//   score(p) = max over {bright, dark} of max over 16 start positions of the
//              min over an arc of 9 consecutive differences on the 16-point
//              Bresenham ring of radius 3 (reads edge-clamped);
//   keep(p)  = score(p) >= each of its 8 neighbours' scores (neighbours
//              outside the image count as -inf);
//   out(p)   = (keep && p at least `border` from every edge
//                 ? clamp(score, 0, 1023) : 0) << 20 | (y * W + x).
//
// Two entries over one body:
//   full map  (TILE_MAX = false): out(p) for every pixel, [C, H, W] int32;
//   tile max  (TILE_MAX = true):  the maximum of out(p) over each 16 x 16
//              cell, [C, ceil(H/16), ceil(W/16)] int32, and no full map. The
//              keypoint selection downstream uses nothing else.
//
// What bounds it on an H100. Per pixel it must read 4 bytes and write 4 (full
// map) or 4/256 (tile max): 0.95 M pixels x 32 frames at 3.35 TB/s is 0.073
// ms or 0.036 ms per chunk. The work is integer min/max, of which an SM
// starts 64 per clock (the toolkit's table of arithmetic throughput gives 64
// per SM per clock for 32-bit integer compare, minimum and maximum at compute
// capability 9.0; tools/int_instr_rate.py measures 61.7 for the two-lane
// 16-bit forms, two- and three-input alike). What the function needs per
// PAIR of output pixels, whatever the tiling, in the widest instructions the
// card has (two 16-bit lanes, three inputs): 80 for the scores (32 for the
// runs of 3 on both sides, 32 for the arcs of 9, 16 down the 16 arcs), 2 to
// finish them (the larger side or 0, the clamp), 2 for the 3x3 maximum (one
// across, one down), and for the tile-max entry 2 more (each packed value
// into its cell's maximum): 84 or 86, 1.31 or 1.34 clocks of an SM. At 132
// SMs and 1.98 GHz that is 0.076 or 0.078 ms per chunk (chip_smoke.py holds
// the constants and computes the bound). Operations bound it, bytes do not,
// which is why the tile-max entry, though it writes 1/256 of the bytes, takes
// as long. The kernel itself issues more than the function needs: the score
// is recomputed on a 1-pixel ring around each tile (34 rows and two columns
// for 32 rows), and loads, addresses, masks, packing and stores share the
// issue slots.
//
// What the design does about that:
//  * one launch covers all levels of a call (a table of tile counts in the
//    by-value parameter struct; the largest level first, the small ones fill
//    the tail);
//  * pixels are staged in shared memory as 16-bit values, twice (once
//    shifted by a pixel), so that every pair of horizontally adjacent pixels
//    at any ring offset is one aligned 32-bit load at an immediate offset;
//  * a thread computes two pixels in the two signed 16-bit lanes of a word
//    with Hopper's three-input min/max (DPX) instructions. min over an arc
//    of (v - c) is (min over the arc of v) - c, so the arc trees run on the
//    raw pixels, one subtraction per side at the end: min3 over runs of 3,
//    min3 of three runs for each arc of 9, max3 down the 16 arcs: 80
//    instructions for two pixels where one pixel took 158;
//  * a tile is 64 x 32 pixels, eight whole cells. A warp takes a row, a lane
//    a pair, so every address is the lane plus a constant and nothing is
//    divided. The score is needed on the tile plus a 1-pixel ring: 34 row
//    tasks and two more for the two ring columns (6 % more than the tile; a
//    tile 16 high pays 12 %). Four warps a block: the phases of the many
//    small blocks of an SM overlap (16 warps a block took 1.5 times as long);
//  * the NMS walks down a warp's 8 rows and carries the row maxima, so each
//    score row is read and reduced across once, not three times;
//  * the cell maximum goes thread (over its rows), then shared memory (over
//    the warps of a row of cells, over the 8 pairs of a cell): a block owns
//    whole cells, so no atomics and no second pass;
//  * rows are read 16 bytes a thread where the level's width is a multiple
//    of 4, four single pixels a thread otherwise; float to integer is one
//    float add (no conversion instruction);
//  * every pixel does the same work. Only max(score, 0) matters, and an arc
//    of 9 holds two adjacent compass points of the ring, so a warp none of
//    whose pixels has two such points on one side of the centre could stop
//    after 4 ring reads; but four fifths of the pixels of a noise image and
//    of a rendered, textured frame pass that test, no warp of 64 pixels
//    stops, and the test cost 10 % when it was tried (PERF.md). It is not in
//    the source.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (eao_slam_torch/ops/fast_nms.py).
// The kernel's phases are functions of the thread index. With
// FAST_NMS_HOST_EMULATION the source compiles as plain C++ without the
// __global__ wrapper, and tests/fast_nms_host_emulation.cpp, which supplies
// the intrinsics, runs the phases thread by thread on the CPU.

#ifndef FAST_NMS_HOST_EMULATION
#include <cuda_runtime.h>
#endif
#include <cstdint>

#define FAST_TILE_W 64    // one warp lane per pair of pixels across
#define FAST_TILE_H 32
#define FAST_CELL 16
#define FAST_WARP 32
#define FAST_MAX_LEVELS 16
#define FAST_THREADS 128

static_assert(FAST_THREADS % FAST_WARP == 0, "whole warps");
static_assert(FAST_TILE_W == 2 * FAST_WARP, "a lane per pair of pixels across the tile");

constexpr int kHalo = 4;                            // ring radius 3 + 1 for the NMS
constexpr int kPixW = FAST_TILE_W + 2 * kHalo;      // staged pixel columns (72)
constexpr int kPixH = FAST_TILE_H + 2 * kHalo;      // staged pixel rows (40)
constexpr int kPixS = kPixW / 2;                    // 32-bit words per staged row
constexpr int kScRows = FAST_TILE_H + 2;            // score rows: tile + 1-pixel ring
constexpr int kScS = FAST_TILE_W / 2 + 2;           // score words per row, see FastSmem
constexpr int kEdgeTasks = (kScRows + FAST_WARP - 1) / FAST_WARP;   // ring columns, a row a lane
constexpr int kCellsX = FAST_TILE_W / FAST_CELL;
constexpr int kCellsY = FAST_TILE_H / FAST_CELL;
constexpr int kWarps = FAST_THREADS / FAST_WARP;
constexpr int kNmsRows = FAST_TILE_H / kWarps;      // tile rows a warp suppresses
static_assert(FAST_TILE_H % FAST_CELL == 0, "a tile is whole cells");
static_assert(kNmsRows * kWarps == FAST_TILE_H && FAST_CELL % kNmsRows == 0,
              "a warp's rows lie in one row of cells");

struct FastLevel {
  const float* in;   // [C, H, W]
  int* out;          // [C, H, W] or [C, ceil(H/16), ceil(W/16)]
  int H, W;
  int tiles_x;       // tiles across
  int tile_begin;    // first blockIdx.x of this level
  int vec4;          // rows can be read 16 bytes at a time
};

struct FastParams {
  FastLevel lv[FAST_MAX_LEVELS];
  int n_levels;
  int border;
};

// Fills the table of levels; returns the number of tiles of one frame (the
// grid's x extent), or -1 for a count of levels the table cannot hold.
static inline int fast_fill_params(FastParams* p, const void* const* ins, void* const* outs,
                                   const int* hs, const int* ws, int n_levels, int border) {
  if (n_levels < 1 || n_levels > FAST_MAX_LEVELS) return -1;
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    FastLevel& v = p->lv[l];
    v.in = (const float*)ins[l];
    v.out = (int*)outs[l];
    v.H = hs[l];
    v.W = ws[l];
    v.tiles_x = (ws[l] + FAST_TILE_W - 1) / FAST_TILE_W;
    v.tile_begin = tiles;
    v.vec4 = (ws[l] % 4 == 0) && ((uintptr_t)ins[l] % 16 == 0);
    tiles += v.tiles_x * ((hs[l] + FAST_TILE_H - 1) / FAST_TILE_H);
  }
  p->n_levels = n_levels;
  p->border = border;
  return tiles;
}

// A block's shared memory. The tile and its halo are staged as 16-bit pixels
// twice: word k of a row of pixA holds staged columns (2k, 2k+1), of pixB
// (2k+1, 2k+2), so that a pair of adjacent pixels at any column is one
// aligned word. Word k of a row of sc holds max(score, 0) of image columns
// x0 + 2k - 2 and x0 + 2k - 1: words 1..32 are the tile's pairs, the high half
// of word 0 and the low half of word 33 the ring columns x0 - 1 and x0 + 64.
struct FastSmem {
  uint32_t pixA[kPixH * kPixS];
  uint32_t pixB[kPixH * kPixS];
  uint32_t sc[kScRows * kScS];
  int part[kWarps * FAST_WARP];          // each thread's maximum over its rows
  int col[kCellsY * FAST_WARP];          // per row of cells, each pair column's maximum
};

// The tile a block works on.
struct FastTile {
  const float* img;  // the frame's level image
  int* out;          // the frame's output
  int H, W, x0, y0, vec4;
};

__device__ __forceinline__ FastTile fast_tile(const FastParams& p, int bx, int frame,
                                              bool tile_max) {
  int l = 0;
  while (l + 1 < p.n_levels && bx >= p.lv[l + 1].tile_begin) ++l;
  const FastLevel& lv = p.lv[l];
  FastTile t;
  t.H = lv.H;
  t.W = lv.W;
  t.vec4 = lv.vec4;
  const int tile = bx - lv.tile_begin;
  const int tile_y = tile / lv.tiles_x;               // once per block
  t.x0 = (tile - tile_y * lv.tiles_x) * FAST_TILE_W;
  t.y0 = tile_y * FAST_TILE_H;
  t.img = lv.in + (long long)frame * t.H * t.W;
  const int th = (t.H + FAST_CELL - 1) / FAST_CELL, tw = (t.W + FAST_CELL - 1) / FAST_CELL;
  t.out = lv.out + (long long)frame * (tile_max ? th * tw : t.H * t.W);
  return t;
}

// two-lane signed 16-bit min/max (values here are 0..32767, so the sign never shows)
__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) { return __vmins2(a, b); }
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) { return __vmaxs2(a, b); }
__device__ __forceinline__ uint32_t min3(uint32_t a, uint32_t b, uint32_t c) {
  return __vimin3_s16x2(a, b, c);
}
__device__ __forceinline__ uint32_t max3(uint32_t a, uint32_t b, uint32_t c) {
  return __vimax3_s16x2(a, b, c);
}

// Ring reads of a thread that owns the tile's pair `lane` of a score row:
// staged columns 4 + 2 lane + DX and the next, so an even DX reads pixA and
// an odd DX pixB, both at offsets known at compile time. `a` and `b` point
// at word `lane` of the pair's own staged row in the two copies.
struct RowRing {
  const uint32_t* a;
  const uint32_t* b;
  template <int DY, int DX>
  __device__ __forceinline__ uint32_t get() const {
    if (DX & 1) return b[DY * kPixS + (3 + DX) / 2];
    return a[DY * kPixS + 2 + DX / 2];
  }
};

// Ring reads of a thread that owns one row of the two ring columns beside
// the tile, x0 - 1 (low lane, staged column 3) and x0 + 64 (high lane, staged
// column 68): two 16-bit reads. `row` points at the pixels' own staged row.
struct EdgeRing {
  const unsigned short* row;
  template <int DY, int DX>
  __device__ __forceinline__ uint32_t get() const {
    const unsigned short* r = row + DY * kPixW + DX;
    return (uint32_t)r[kHalo - 1] | ((uint32_t)r[kHalo + FAST_TILE_W] << 16);
  }
};

// max(FAST-9/16 score, 0) of two pixels from their 16 ring pairs v and centre c.
__device__ __forceinline__ uint32_t fast_score2(const uint32_t (&v)[16], uint32_t c) {
  uint32_t lo9[16], hi9[16], lo3[16], hi3[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo3[i] = min3(v[i], v[(i + 1) & 15], v[(i + 2) & 15]);
    hi3[i] = max3(v[i], v[(i + 1) & 15], v[(i + 2) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo9[i] = min3(lo3[i], lo3[(i + 3) & 15], lo3[(i + 6) & 15]);
    hi9[i] = max3(hi3[i], hi3[(i + 3) & 15], hi3[(i + 6) & 15]);
  }
  // brightest arc minimum, darkest arc maximum
  uint32_t B = max3(lo9[0], lo9[1], lo9[2]), D = min3(hi9[0], hi9[1], hi9[2]);
#pragma unroll
  for (int i = 3; i < 15; i += 2) {
    B = max3(B, lo9[i], lo9[i + 1]);
    D = min3(D, hi9[i], hi9[i + 1]);
  }
  B = max2(B, lo9[15]);
  D = min2(D, hi9[15]);
  // per lane min(max(B - c, c - D, 0), 1023): bias each lane by 2^14 so that
  // the 32-bit subtractions borrow nothing across lanes (pixels are < 2^14)
  const uint32_t bias = 0x40004000u;
  return min2(max3((B + bias) - c, (c + bias) - D, bias) - bias, 0x03ff03ffu);
}

// max(score, 0) of the pair a ring belongs to; `mask` clears the lanes that
// lie outside the image.
template <class Ring>
__device__ __forceinline__ uint32_t fast_score_pair(const Ring ring, uint32_t mask) {
  if (mask == 0) return 0;
  uint32_t v[16];
  const uint32_t c = ring.template get<0, 0>();
  v[0] = ring.template get<-3, 0>();
  v[1] = ring.template get<-3, 1>();
  v[2] = ring.template get<-2, 2>();
  v[3] = ring.template get<-1, 3>();
  v[4] = ring.template get<0, 3>();
  v[5] = ring.template get<1, 3>();
  v[6] = ring.template get<2, 2>();
  v[7] = ring.template get<3, 1>();
  v[8] = ring.template get<3, 0>();
  v[9] = ring.template get<3, -1>();
  v[10] = ring.template get<2, -2>();
  v[11] = ring.template get<1, -3>();
  v[12] = ring.template get<0, -3>();
  v[13] = ring.template get<-1, -3>();
  v[14] = ring.template get<-2, -2>();
  v[15] = ring.template get<-3, -1>();
  return fast_score2(v, c) & mask;
}

// An integer-valued float 0..16383 as an integer in the low 16 bits (adding
// 2^23 leaves it in the mantissa; no conversion instruction).
__device__ __forceinline__ uint32_t fast_grey(float f) { return __float_as_uint(f + 8388608.0f); }
// the low halves of lo and hi as one word
__device__ __forceinline__ uint32_t fast_pack(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5410);
}

// Phase 1: the tile and its halo, edge-clamped, as 16-bit pixels in both
// copies. A thread keeps one group of four columns (one 16-byte read where
// the level allows) and walks down the rows, so that what depends on the
// column is worked out once.
__device__ __forceinline__ void fast_stage(FastSmem& sm, const FastTile& t, int tid) {
  constexpr int G = kPixW / 4;                  // groups across (18)
  constexpr int kRowsPerPass = FAST_THREADS / G;
  static_assert(kRowsPerPass >= 1, "a pass stages at least one row");
  int r = tid / G;                              // once per thread
  if (r >= kRowsPerPass) return;
  const int g = tid - r * G;
  const int gx = t.x0 - kHalo + 4 * g, last = t.W - 1;
  const bool inside = gx >= 0 && gx + 3 <= last;
  const bool vec = inside && t.vec4;
  const int c0 = min(max(gx, 0), last), c1 = min(max(gx + 1, 0), last);
  const int c2 = min(max(gx + 2, 0), last), c3 = min(max(gx + 3, 0), last);
  unsigned short* const sB = reinterpret_cast<unsigned short*>(sm.pixB);
  for (; r < kPixH; r += kRowsPerPass) {
    const int gy = min(max(t.y0 - kHalo + r, 0), t.H - 1);
    const float* row = t.img + gy * t.W;
    float f0, f1, f2, f3;
    if (vec) {
      const float4 f = *reinterpret_cast<const float4*>(row + gx);
      f0 = f.x; f1 = f.y; f2 = f.z; f3 = f.w;
    } else {
      f0 = row[c0]; f1 = row[c1]; f2 = row[c2]; f3 = row[c3];
    }
    const uint32_t q0 = fast_grey(f0), q1 = fast_grey(f1), q2 = fast_grey(f2), q3 = fast_grey(f3);
    const int w = r * kPixS + 2 * g;
    sm.pixA[w] = fast_pack(q0, q1);
    sm.pixA[w + 1] = fast_pack(q2, q3);
    if (g > 0) sB[2 * w - 1] = (unsigned short)q0;
    sm.pixB[w] = fast_pack(q1, q2);
    sB[2 * w + 2] = (unsigned short)q3;
  }
}

// Phase 2: max(score, 0) on the tile plus a 1-pixel ring, 0 outside the
// image. A warp takes a score row (image row y0 - 1 + r), lane j the tile's
// pair j; further tasks take the two ring columns, a lane their pixels of one
// row.
__device__ __forceinline__ void fast_score(FastSmem& sm, const FastTile& t, int tid) {
  const int lane = tid & (FAST_WARP - 1), warp = tid / FAST_WARP;
  const int x = t.x0 + 2 * lane;
  const uint32_t mask_x = (x < t.W ? 0x0000ffffu : 0u) | (x + 1 < t.W ? 0xffff0000u : 0u);
  for (int task = warp; task < kScRows + kEdgeTasks; task += kWarps) {
    if (task < kScRows) {
      const int gy = t.y0 - 1 + task;
      const int w = (task + 3) * kPixS + lane;
      const uint32_t s = fast_score_pair(RowRing{sm.pixA + w, sm.pixB + w},
                                         gy >= 0 && gy < t.H ? mask_x : 0u);
      sm.sc[task * kScS + 1 + lane] = s;
    } else {
      const int row = (task - kScRows) * FAST_WARP + lane;
      const bool live = row < kScRows;
      const int r = live ? row : 0;
      const int gy = t.y0 - 1 + r;
      const bool in_y = live && gy >= 0 && gy < t.H;
      const uint32_t mask = (in_y && t.x0 > 0 ? 0x0000ffffu : 0u) |
                            (in_y && t.x0 + FAST_TILE_W < t.W ? 0xffff0000u : 0u);
      const unsigned short* pix = reinterpret_cast<const unsigned short*>(sm.pixA);
      const uint32_t s = fast_score_pair(EdgeRing{pix + (r + 3) * kPixW}, mask);
      if (live) {
        unsigned short* scs = reinterpret_cast<unsigned short*>(sm.sc + r * kScS);
        scs[1] = (unsigned short)s;
        scs[2 * (kScS - 1)] = (unsigned short)(s >> 16);
      }
    }
  }
}

// The maximum over the 3 neighbours across, for the pair `lane` of a score
// row: score word lane + 1 (returned in `centre`), between the high half of
// word `lane` and the low half of word lane + 2. `w` points at word `lane`.
__device__ __forceinline__ uint32_t fast_row_max(const uint32_t* w, uint32_t& centre) {
  centre = w[1];
  return max3(__funnelshift_r(w[0], centre, 16), centre, __funnelshift_r(centre, w[2], 16));
}

// Phase 3: 3x3 NMS, border mask, pack. A warp takes kNmsRows consecutive
// tile rows, lane j the pair at tile columns 2j, 2j + 1, and carries the row
// maxima down, so that each score row is read once. The full-map entry
// stores the packed pair; the tile-max entry keeps each thread's maximum.
template <bool TILE_MAX>
__device__ __forceinline__ void fast_nms(FastSmem& sm, const FastTile& t, int border, int tid) {
  const int lane = tid & (FAST_WARP - 1), warp = tid / FAST_WARP;
  const int x = t.x0 + 2 * lane, H = t.H, W = t.W;
  const bool have_lo = x < W, have_hi = x + 1 < W;
  const bool in_lo = x >= border && x < W - border;
  const bool in_hi = x + 1 >= border && x + 1 < W - border;
  const int row0 = warp * kNmsRows;
  const uint32_t* w = sm.sc + row0 * kScS + lane;    // score row of image row y - 1
  uint32_t c, unused;
  uint32_t above = fast_row_max(w, unused);
  uint32_t here = fast_row_max(w + kScS, c);
  int best = 0;
#pragma unroll
  for (int k = 0; k < kNmsRows; ++k) {
    const int y = t.y0 + row0 + k;
    if (y >= H) break;
    uint32_t c_below;
    const uint32_t below = fast_row_max(w + (k + 2) * kScS, c_below);
    const uint32_t mx = max3(above, here, below);
    const bool in_y = y >= border && y < H - border;
    const int s_lo = c & 0xffff, s_hi = c >> 16;
    const bool keep_lo = s_lo == (int)(mx & 0xffff) && in_y && in_lo;
    const bool keep_hi = s_hi == (int)(mx >> 16) && in_y && in_hi;
    const int idx = y * W + x;
    const int v_lo = ((keep_lo ? s_lo : 0) << 20) | idx;
    const int v_hi = ((keep_hi ? s_hi : 0) << 20) | (idx + 1);
    if (TILE_MAX) {
      best = max(best, max(have_lo ? v_lo : 0, have_hi ? v_hi : 0));
    } else if (have_hi && (W & 1) == 0) {
      *reinterpret_cast<int2*>(t.out + idx) = make_int2(v_lo, v_hi);
    } else {
      if (have_lo) t.out[idx] = v_lo;
      if (have_hi) t.out[idx + 1] = v_hi;
    }
    above = here;
    here = below;
    c = c_below;
  }
  if (TILE_MAX) sm.part[tid] = best;
}

// Phase 4 of the tile-max entry: per row of cells, the maximum over its
// warps for each pair column; then over the 8 pair columns of each cell. A
// block owns whole cells, so this is the cell's value.
__device__ __forceinline__ void fast_cell_columns(FastSmem& sm, int tid) {
  constexpr int kWarpsPerCellRow = kWarps / kCellsY;
  if (tid >= kCellsY * FAST_WARP) return;
  const int cell_row = tid / FAST_WARP, lane = tid & (FAST_WARP - 1);
  const int* p = sm.part + cell_row * kWarpsPerCellRow * FAST_WARP + lane;
  int best = p[0];
#pragma unroll
  for (int w = 1; w < kWarpsPerCellRow; ++w) best = max(best, p[w * FAST_WARP]);
  sm.col[tid] = best;
}

__device__ __forceinline__ void fast_cell_store(FastSmem& sm, const FastTile& t, int tid) {
  if (tid >= kCellsX * kCellsY) return;
  const int cell_row = tid / kCellsX, cell_x = tid % kCellsX;
  const int* p = sm.col + cell_row * FAST_WARP + cell_x * (FAST_CELL / 2);
  int best = p[0];
#pragma unroll
  for (int k = 1; k < FAST_CELL / 2; ++k) best = max(best, p[k]);
  const int th = (t.H + FAST_CELL - 1) / FAST_CELL, tw = (t.W + FAST_CELL - 1) / FAST_CELL;
  const int cy = t.y0 / FAST_CELL + cell_row, cx = t.x0 / FAST_CELL + cell_x;
  if (cy < th && cx < tw) t.out[cy * tw + cx] = best;
}

#ifndef FAST_NMS_HOST_EMULATION
template <bool TILE_MAX>
__global__ void __launch_bounds__(FAST_THREADS) fast_nms_kernel(const FastParams p) {
  __shared__ FastSmem sm;
  const int tid = threadIdx.x;
  const FastTile t = fast_tile(p, blockIdx.x, blockIdx.y, TILE_MAX);
  fast_stage(sm, t, tid);
  __syncthreads();
  fast_score(sm, t, tid);
  __syncthreads();
  fast_nms<TILE_MAX>(sm, t, p.border, tid);
  if (TILE_MAX) {
    __syncthreads();
    fast_cell_columns(sm, tid);
    __syncthreads();
    fast_cell_store(sm, t, tid);
  }
}
#endif

#ifndef FAST_NMS_HOST_EMULATION
// One launch for all levels of a call. ins/outs/hs/ws: per level, the [C, H, W]
// float32 input, the int32 output and the size. tile_max selects the entry.
// Returns the CUDA error of the launch (0 = launched), or -1 for bad arguments.
extern "C" int fast_nms_launch(const void* const* ins, void* const* outs, const int* hs,
                               const int* ws, int n_levels, int C, int border, int tile_max,
                               void* stream) {
  FastParams p;
  const int tiles = fast_fill_params(&p, ins, outs, hs, ws, n_levels, border);
  if (tiles <= 0 || C < 1 || C > 65535) return -1;
  const dim3 grid(tiles, C);
  if (tile_max)
    fast_nms_kernel<true><<<grid, FAST_THREADS, 0, (cudaStream_t)stream>>>(p);
  else
    fast_nms_kernel<false><<<grid, FAST_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
#endif  // FAST_NMS_HOST_EMULATION
