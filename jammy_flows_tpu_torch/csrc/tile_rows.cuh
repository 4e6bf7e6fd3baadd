// The tensor-core tile stage of the kernels that make their parameter rows
// from hidden activations, b_j + w_j . hidden: the lazy2 and lazy block
// kernels (gf_block_src.cuh TileSrc, gf_block_bwd.cu) and the per-layer
// lazy kernels (gf_layer_src.cuh, gf_layer.cu, gf_layer_bwd.cu).  A block of T
// rows keeps its rows' hidden activations as a tile in shared memory (or
// streams them through it: rows_product_streamed); a piece of n parameter
// rows (rows(c), c < n) is then made for all T rows at once as the tile
// product hidden (T x H) . w_piece^T (H x n) + b, in 3xTF32 on the tensor
// cores (mma_tf32.cuh), into a shared slab that each row's thread reads
// (rows_product).  The backward writes each row's
// cotangents of the piece over its slab column and adds the piece to the
// hidden cotangent dh += dp . w_piece (dh_product), to the block's partial
// gw_piece += dp^T . hidden (gw_product), both tile products too, and to
// gb by a fixed-order sum (gb_sum).  Every function here is
// block-synchronous: every thread of the block calls it, rows past B
// included (on zero hidden rows).  The operands the stage writes into
// shared memory keep a NaN through the TF32 split (keep_nan); w is split
// as it comes (split_tf32_any).
#pragma once

#include <cstdint>

#include "mma_tf32.cuh"

namespace gf {

// ---- the tile: rows per block and shared-memory layout ----------------------
constexpr int TILE_KC = 32;            // a W chunk: 32 hidden columns (or
constexpr int TILE_NC = 32;            // k rows) of 32 parameter rows
constexpr int TILE_WS = TILE_KC + 8;   // a chunk row's capacity (floats)
constexpr int TILE_SMEM_LIMIT = 227 * 1024;

// Shared memory of a block that makes its rows' parameters by tile, in
// floats:
//   wc  2 x (32, TILE_WS)  double-buffered W chunks (cp.async)
//   hid (Hp, hs)  hidden[h][t]; hs = T + 8: conflict-free A fragments
//   sa  (na, ts)  lazy2: a layer's offset and reflection rows, kept
//                 through it (the per-layer kernels: none)
//   sm  (nm, ts)  one dimension's mixture rows; ts = T + 4: conflict-free
//                 C stores and per-row reads
// T rows (threads) a block, a multiple of 32; Hp = H rounded up to 8, nm
// and na to 32 (the per-layer backward: nm to 16, W chunks of 40 rows).
// The flagship's lazy2 blocks (H = 128, 20 / 30 rows a piece, T = 128):
// 10,240 + 69,632 + 16,896 + 16,896 = 113,664 bytes, two blocks (8 warps)
// per SM; the skewed per-layer backward (40 rows a piece): 12,800 + 69,632
// + 25,344 = 107,776, the same.
struct TileShape {
  int T, Hp, hs, ts, na, nm;
  __host__ __device__ size_t floats() const {
    return (size_t)Hp * hs + (size_t)(na + nm) * ts + 2 * TILE_NC * TILE_WS;
  }
};

// the shared memory of a block (TileShape), chunk buffers first so that
// 16-byte copies land aligned; w: the final MLP weight (P, H) whose rows
// the block reads
struct Tile {
  float* wc;   // 2 x (TILE_NC, TILE_WS)
  float* hid;  // (Hp, hs)
  float* sa;   // (na, ts)
  float* sm;   // (nm, ts)
  int H, Hp, hs, ts;
  bool vec;    // w's rows 16-byte aligned: 16-byte copies

  // wc_floats: the chunk buffers' floats, 2 x (rows of a chunk) x TILE_WS
  __device__ Tile(int H_, const TileShape& s, const float* w, float* smem,
                  int wc_floats = 2 * TILE_NC * TILE_WS)
      : wc(smem), hid(smem + wc_floats),
        sa(hid + (size_t)s.Hp * s.hs), sm(sa + (size_t)s.na * s.ts), H(H_),
        Hp(s.Hp), hs(s.hs), ts(s.ts),
        vec(H_ % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {}
};

// The precomputed hidden rows row0 .. row0 + T - 1 (T = blockDim.x) of
// the (B, H) activations into the tile, coalesced, eight loads in flight a
// thread: zeros past B and in the columns H .. Hp - 1; a NaN kept for the
// TF32 split.  Block-synchronous; its first barrier waits for the previous
// tile's readers.
__device__ inline void load_hidden_tile(const Tile& tl, const float* hidden,
                                        int row0, int B, int H) {
  constexpr int U = 8;
  const int T = blockDim.x, t = threadIdx.x, total = T * H;
  const int n = min(T, B - row0) * H;
  const float* src = hidden + (size_t)row0 * H;
  __syncthreads();
  for (int i0 = 0; i0 < total; i0 += U * T) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T + t;
      v[u] = i < n ? __ldg(src + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T + t;
      if (i < total) {
        const int r = i / H, h = i - r * H;
        tl.hid[h * tl.hs + r] = keep_nan(v[u]);
      }
    }
  }
  for (int i = t; i < (tl.Hp - H) * T; i += T)
    tl.hid[(H + i / T) * tl.hs + i % T] = 0.0f;
  __syncthreads();
}

// Start copying w's rows rows(c0 .. c0 + NC - 1) (those below n), columns
// h0 .. h0 + 31 (those below H), into a chunk buffer at row stride ws,
// zeros elsewhere; one cp.async group.
template <int NC = TILE_NC, class TileT, class Rows>
__device__ void load_w_chunk(const TileT& tl, float* buf, int ws,
                             const float* w, const Rows& rows, int n, int c0,
                             int h0) {
  if (tl.vec) {
    constexpr int V = TILE_KC / 4;
    for (int i = threadIdx.x; i < NC * V; i += blockDim.x) {
      const int c = i / V, q = (i - c * V) * 4;
      const bool ok = c0 + c < n && h0 + q < tl.H;
      cp_async16(buf + c * ws + q,
                 ok ? w + (size_t)rows(c0 + c) * tl.H + h0 + q : w,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < NC * TILE_KC; i += blockDim.x) {
      const int c = i / TILE_KC, q = i - c * TILE_KC;
      const bool ok = c0 + c < n && h0 + q < tl.H;
      cp_async4(buf + c * ws + q,
                ok ? w + (size_t)rows(c0 + c) * tl.H + h0 + q : w,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// The row product of one piece: slab[c][t] = b[rows(c)] + sum_h hid[t][h]
// w[rows(c)][h] for the block's rows t and the piece's columns c < n (and
// zeros up to the next multiple of 8), in 3xTF32 on the tensor cores.  Warp
// w makes rows 32w .. 32w + 31 (two m16 tiles), 8 NT columns (NT n8 tiles)
// at a time, the hidden axis in chunks of 32 streamed through the two
// chunk buffers (row stride TILE_KC + 4: conflict-free B fragments).  The
// k order is fixed (hidden units 0..7, 8..15, ...), so a row's parameters
// do not depend on the tile, the piece or the kernel that makes them: the
// forward and the backward make the same bits.  Block-synchronous.
template <int NT = 4, class Rows>
__device__ void rows_product(const Tile& tl, float* slab, const float* w,
                             const float* b, const Rows& rows, int n) {
  if (n <= 0) return;
  constexpr int WS = TILE_KC + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int t0 = (threadIdx.x >> 5) * 32;
  const int n_kc = (tl.Hp + TILE_KC - 1) / TILE_KC;
  constexpr int NC = 8 * NT;
  const int n_steps = (n + NC - 1) / NC * n_kc;
  float acc[2][NT][4];
  load_w_chunk<NC>(tl, tl.wc, WS, w, rows, n, 0, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int nc = s / n_kc, kc = s - nc * n_kc;
    if (s + 1 < n_steps) {
      const int nc1 = (s + 1) / n_kc;
      load_w_chunk<NC>(tl, tl.wc + ((s + 1) & 1) * NC * TILE_WS, WS, w,
                       rows, n, nc1 * NC, (s + 1 - nc1 * n_kc) * TILE_KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
    const float* wb = tl.wc + (s & 1) * NC * TILE_WS;
    const int n_tiles = min(NT, (n - nc * NC + 7) / 8);
    const int k_steps = min(TILE_KC, tl.Hp - kc * TILE_KC) / 8;
#pragma unroll
    for (int ks = 0; ks < TILE_KC / 8; ++ks) {
      if (ks < k_steps) {
        const float* hk =
            tl.hid + (size_t)(kc * TILE_KC + ks * 8 + q) * tl.hs + t0 + g;
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* h0 = hk + mt * 16;
          split_tf32(h0[0], ahi[mt][0], alo[mt][0]);
          split_tf32(h0[8], ahi[mt][1], alo[mt][1]);
          split_tf32(h0[4 * tl.hs], ahi[mt][2], alo[mt][2]);
          split_tf32(h0[4 * tl.hs + 8], ahi[mt][3], alo[mt][3]);
        }
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < n_tiles) {
            const float* wk = wb + (nt * 8 + g) * WS + ks * 8 + q;
            split_tf32_any(wk[0], bhi[nt][0], blo[nt][0]);
            split_tf32_any(wk[4], bhi[nt][1], blo[nt][1]);
          }
        }
        mma3_tile(acc, ahi, alo, bhi, blo, 2, n_tiles);
      }
    }
    if (kc == n_kc - 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < n_tiles) {
          const int c = nc * NC + nt * 8 + 2 * q;
          const float b0 = c < n ? __ldg(b + rows(c)) : 0.0f;
          const float b1 = c + 1 < n ? __ldg(b + rows(c + 1)) : 0.0f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float* o = slab + (size_t)c * tl.ts + t0 + mt * 16 + g;
            o[0] = acc[mt][nt][0] + b0;
            o[tl.ts] = acc[mt][nt][1] + b1;
            o[8] = acc[mt][nt][2] + b0;
            o[tl.ts + 8] = acc[mt][nt][3] + b1;
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---- the streamed tile: the hidden rows in chunks, not staged whole -------
// A block that needs the hidden rows only for the parameter products (the
// per-layer lazy forward) streams them from global memory (L2) in chunks of
// TILE_KC columns beside the W chunks, instead of keeping the whole tile:
// its shared memory then does not grow with H, and at the flagship's
// widths three blocks (12 warps) share an SM where the staged tile keeps
// two.  In floats:
//   wc  2 x (40, TILE_WS)  double-buffered W chunks of up to 40 rows (NT
//                          n8 tiles): a piece of the skewed flagship (4
//                          groups x K = 10) in one, so that each hidden
//                          chunk is split once
//   ac  2 x (T, TILE_AS)   double-buffered hidden chunks, row-major;
//                          TILE_AS = 36: conflict-free A fragments
//   sm  (nm, ts)           the piece's slab; nm = n rounded up to 8
constexpr int TILE_AS = TILE_KC + 4;
constexpr int STREAM_NT = 5;               // most n8 tiles of a W chunk
constexpr int STREAM_NC = 8 * STREAM_NT;   // its rows

struct StreamShape {
  int T, ts, nm;
  __host__ __device__ size_t floats() const {
    return 2 * STREAM_NC * TILE_WS + (size_t)2 * T * TILE_AS +
           (size_t)nm * ts;
  }
};

struct StreamTile {
  float* wc;   // 2 x (STREAM_NC, TILE_WS)
  float* ac;   // 2 x (T, TILE_AS)
  float* sm;   // (nm, ts)
  int H, Hp, ts;
  bool vec;    // w's rows 16-byte aligned
  bool avec;   // the hidden rows 16-byte aligned

  __device__ StreamTile(int H_, const StreamShape& s, const float* w,
                        const float* hidden, float* smem)
      : wc(smem), ac(smem + 2 * STREAM_NC * TILE_WS),
        sm(ac + (size_t)2 * s.T * TILE_AS), H(H_), Hp((H_ + 7) / 8 * 8),
        ts(s.ts),
        vec(H_ % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0),
        avec(H_ % 4 == 0 && reinterpret_cast<uintptr_t>(hidden) % 16 == 0) {}
};

// Start copying the hidden rows row0 .. row0 + T - 1 (those below B),
// columns h0 .. h0 + 31 (those below H), into a chunk buffer, zeros
// elsewhere (no commit: load_w_chunk's group takes it)
__device__ __forceinline__ void load_a_chunk(const StreamTile& tl, float* buf,
                                             const float* hidden, int row0,
                                             int B, int h0) {
  const int T = blockDim.x;
  if (tl.avec) {
    constexpr int V = TILE_KC / 4;
    for (int i = threadIdx.x; i < T * V; i += T) {
      const int r = i / V, q = (i - r * V) * 4;
      const bool ok = row0 + r < B && h0 + q < tl.H;
      cp_async16(buf + r * TILE_AS + q,
                 ok ? hidden + (size_t)(row0 + r) * tl.H + h0 + q : hidden,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < T * TILE_KC; i += T) {
      const int r = i / TILE_KC, q = i - r * TILE_KC;
      const bool ok = row0 + r < B && h0 + q < tl.H;
      cp_async4(buf + r * TILE_AS + q,
                ok ? hidden + (size_t)(row0 + r) * tl.H + h0 + q : hidden,
                ok ? 4 : 0);
    }
  }
}

// rows_product with the hidden rows streamed: slab[c][t] = b[rows(c)] +
// sum_h hidden[row0 + t][h] w[rows(c)][h], each step's hidden and W chunks
// copied together (cp.async, double-buffered), the piece's columns 8 * NT
// at a time (NT <= STREAM_NT: the accumulators a caller's registers can
// hold).  The hidden values come as they are in global memory, so they
// take the split that keeps any NaN (split_tf32_any); for finite values its
// parts, the k order and so the bits are rows_product's, whatever NT.
// Block-synchronous.
template <int NT, class Rows>
__device__ void rows_product_streamed(const StreamTile& tl,
                                      const float* hidden, int row0, int B,
                                      float* slab, const float* w,
                                      const float* b, const Rows& rows,
                                      int n) {
  static_assert(NT >= 1 && NT <= STREAM_NT, "a W chunk holds 40 rows");
  if (n <= 0) return;
  constexpr int WS = TILE_KC + 4;
  constexpr int NC = 8 * NT;
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int t0 = (threadIdx.x >> 5) * 32;
  const int n_kc = (tl.Hp + TILE_KC - 1) / TILE_KC;
  const int n_steps = (n + NC - 1) / NC * n_kc;
  float acc[2][NT][4];
  load_a_chunk(tl, tl.ac, hidden, row0, B, 0);
  load_w_chunk<NC>(tl, tl.wc, WS, w, rows, n, 0, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int nc = s / n_kc, kc = s - nc * n_kc;
    if (s + 1 < n_steps) {
      const int nc1 = (s + 1) / n_kc, kc1 = s + 1 - nc1 * n_kc;
      load_a_chunk(tl, tl.ac + ((s + 1) & 1) * T * TILE_AS, hidden, row0, B,
                   kc1 * TILE_KC);
      load_w_chunk<NC>(tl, tl.wc + ((s + 1) & 1) * NC * TILE_WS, WS, w, rows,
                       n, nc1 * NC, kc1 * TILE_KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
    const float* ab = tl.ac + (s & 1) * T * TILE_AS;
    const float* wb = tl.wc + (s & 1) * NC * TILE_WS;
    const int n_tiles = min(NT, (n - nc * NC + 7) / 8);
    const int k_steps = min(TILE_KC, tl.Hp - kc * TILE_KC) / 8;
#pragma unroll
    for (int ks = 0; ks < TILE_KC / 8; ++ks) {
      if (ks < k_steps) {
        const float* ak = ab + (t0 + g) * TILE_AS + ks * 8 + q;
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* a0 = ak + mt * 16 * TILE_AS;
          split_tf32_any(a0[0], ahi[mt][0], alo[mt][0]);
          split_tf32_any(a0[8 * TILE_AS], ahi[mt][1], alo[mt][1]);
          split_tf32_any(a0[4], ahi[mt][2], alo[mt][2]);
          split_tf32_any(a0[8 * TILE_AS + 4], ahi[mt][3], alo[mt][3]);
        }
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < n_tiles) {
            const float* wk = wb + (nt * 8 + g) * WS + ks * 8 + q;
            split_tf32_any(wk[0], bhi[nt][0], blo[nt][0]);
            split_tf32_any(wk[4], bhi[nt][1], blo[nt][1]);
          }
        }
        mma3_tile(acc, ahi, alo, bhi, blo, 2, n_tiles);
      }
    }
    if (kc == n_kc - 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < n_tiles) {
          const int c = nc * NC + nt * 8 + 2 * q;
          const float b0 = c < n ? __ldg(b + rows(c)) : 0.0f;
          const float b1 = c + 1 < n ? __ldg(b + rows(c + 1)) : 0.0f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float* o = slab + (size_t)c * tl.ts + t0 + mt * 16 + g;
            o[0] = acc[mt][nt][0] + b0;
            o[tl.ts] = acc[mt][nt][1] + b1;
            o[8] = acc[mt][nt][2] + b0;
            o[tl.ts + 8] = acc[mt][nt][3] + b1;
          }
        }
      }
    }
    __syncthreads();
  }
}

// dh[t][h] += sum_c dp[t][c] w[rows(c)][h] (3xTF32): warp w takes rows
// 32w .. 32w + 31 (two m16 tiles), the piece's columns are the k axis, in
// chunks of NC rows of w (32; the per-layer backward 40, a skewed flagship
// piece in one, so that dh is read and written once a piece) by 32 hidden
// columns streamed through the chunk buffers (row stride TILE_KC + 8:
// conflict-free B fragments), and each
// chunk's hidden columns are taken 16 at a time (two n8 tiles: 16
// accumulators a lane, so that the products keep to registers beside the
// body's live state).  dh (Hp, hs) is the block's global scratch (or, in
// the lazy mode where the tile leaves room, shared memory); the warp's own
// entries are the accumulators' start.
template <int NC = TILE_NC, class Rows>
__device__ void dh_product(const Tile& tl, const float* dp, float* dh,
                           const float* w, const Rows& rows, int n) {
  constexpr int WS = TILE_KC + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int t0 = (threadIdx.x >> 5) * 32;
  const int n_cc = (n + NC - 1) / NC;
  const int n_steps = (tl.Hp + TILE_KC - 1) / TILE_KC * n_cc;
  const int n8 = (n + 7) / 8 * 8;
  load_w_chunk<NC>(tl, tl.wc, WS, w, rows, n, 0, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int hc = s / n_cc, cc = s - hc * n_cc;
    if (s + 1 < n_steps) {
      const int hc1 = (s + 1) / n_cc;
      load_w_chunk<NC>(tl, tl.wc + ((s + 1) & 1) * NC * TILE_WS, WS, w, rows,
                       n, (s + 1 - hc1 * n_cc) * NC, hc1 * TILE_KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wb = tl.wc + (s & 1) * NC * TILE_WS;
    const int k_steps = min(NC, n8 - cc * NC) / 8;
    for (int h0 = hc * TILE_KC; h0 < min(tl.Hp, hc * TILE_KC + TILE_KC);
         h0 += 16) {
      const int n_tiles = min(2, (tl.Hp - h0) / 8);
      float acc[2][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* o =
              dh + (size_t)(h0 + nt * 8 + 2 * q) * tl.hs + t0 + mt * 16 + g;
          const bool in = nt < n_tiles;
          acc[mt][nt][0] = in ? o[0] : 0.0f;
          acc[mt][nt][1] = in ? o[tl.hs] : 0.0f;
          acc[mt][nt][2] = in ? o[8] : 0.0f;
          acc[mt][nt][3] = in ? o[tl.hs + 8] : 0.0f;
        }
#pragma unroll
      for (int ks = 0; ks < NC / 8; ++ks) {
        if (ks < k_steps) {
          const float* ak =
              dp + (size_t)(cc * NC + ks * 8 + q) * tl.ts + t0 + g;
          uint32_t ahi[2][4], alo[2][4], bhi[2][2], blo[2][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* a0 = ak + mt * 16;
            split_tf32(a0[0], ahi[mt][0], alo[mt][0]);
            split_tf32(a0[8], ahi[mt][1], alo[mt][1]);
            split_tf32(a0[4 * tl.ts], ahi[mt][2], alo[mt][2]);
            split_tf32(a0[4 * tl.ts + 8], ahi[mt][3], alo[mt][3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* wk = wb + (ks * 8 + q) * WS + (h0 & (TILE_KC - 1)) +
                              nt * 8 + g;
            split_tf32_any(wk[0], bhi[nt][0], blo[nt][0]);
            split_tf32_any(wk[4 * WS], bhi[nt][1], blo[nt][1]);
          }
          mma3_tile(acc, ahi, alo, bhi, blo, 2, n_tiles);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt < n_tiles) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float* o =
                dh + (size_t)(h0 + nt * 8 + 2 * q) * tl.hs + t0 + mt * 16 + g;
            o[0] = acc[mt][nt][0];
            o[tl.hs] = acc[mt][nt][1];
            o[8] = acc[mt][nt][2];
            o[tl.hs + 8] = acc[mt][nt][3];
          }
        }
      }
    }
    __syncthreads();
  }
}

// gw[rows(c)][h] += sum_t dp[t][c] hid[t][h] (3xTF32) into the block's
// partial: an item is 32 piece columns (two m16 tiles) by 16 hidden
// columns (two n8 tiles), the items dealt to the warps in turn, the tile's
// rows the k axis; the partial's entries are the accumulators' start.  A
// column past n reads what the slab holds there and feeds only rows that
// are not stored.
template <class Rows>
__device__ void gw_product(const Tile& tl, const float* dp, float* gw,
                           const Rows& rows, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int T = blockDim.x, n_warps = T >> 5;
  const int n_hc = (tl.Hp + 15) / 16, n_items = (n + 31) / 32 * n_hc;
  for (int item = threadIdx.x >> 5; item < n_items; item += n_warps) {
    const int c0 = item / n_hc * 32, h0 = (item % n_hc) * 16;
    const int m_tiles = min(2, (n - c0 + 15) / 16);
    const int n_tiles = min(2, (tl.Hp - h0) / 8);
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + mt * 16 + g + (e >= 2 ? 8 : 0);
          const int h = h0 + nt * 8 + 2 * q + (e & 1);
          acc[mt][nt][e] = mt < m_tiles && nt < n_tiles && c < n && h < tl.H
                               ? gw[(size_t)rows(c) * tl.H + h]
                               : 0.0f;
        }
    for (int k0 = 0; k0 < T; k0 += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[2][2], blo[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < m_tiles) {
          const float* a0 = dp + (size_t)(c0 + mt * 16 + g) * tl.ts + k0 + q;
          split_tf32(a0[0], ahi[mt][0], alo[mt][0]);
          split_tf32(a0[8 * tl.ts], ahi[mt][1], alo[mt][1]);
          split_tf32(a0[4], ahi[mt][2], alo[mt][2]);
          split_tf32(a0[8 * tl.ts + 4], ahi[mt][3], alo[mt][3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt < n_tiles) {
          const float* bk = tl.hid + (size_t)(h0 + nt * 8 + g) * tl.hs + k0 + q;
          split_tf32(bk[0], bhi[nt][0], blo[nt][0]);
          split_tf32(bk[4], bhi[nt][1], blo[nt][1]);
        }
      }
      mma3_tile(acc, ahi, alo, bhi, blo, m_tiles, n_tiles);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + mt * 16 + g + (e >= 2 ? 8 : 0);
          const int h = h0 + nt * 8 + 2 * q + (e & 1);
          if (mt < m_tiles && nt < n_tiles && c < n && h < tl.H)
            gw[(size_t)rows(c) * tl.H + h] = acc[mt][nt][e];
        }
  }
}

// gb[rows(c)] += sum over the tile's rows t of dp[t][c], in a fixed order:
// warp w sums rows 32w .. 32w + 31 of 32 columns (one a lane), then warp 0
// adds the warps' sums in warp order (through the chunk buffers, free once
// dh_product is done).  Block-synchronous.
template <class Rows>
__device__ __forceinline__ void gb_sum(const Tile& tl, const float* dp,
                                       float* gb, const Rows& rows, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.0f;
    if (c < n)
      for (int t = 32 * warp; t < 32 * warp + 32; ++t)
        acc += dp[(size_t)c * tl.ts + t];
    tl.wc[threadIdx.x] = acc;
    __syncthreads();
    if (warp == 0 && c < n) {
      float sum = 0.0f;
      for (int v = 0; v < (int)blockDim.x / 32; ++v) sum += tl.wc[v * 32 + lane];
      gb[rows(c)] += sum;
    }
    __syncthreads();
  }
}

}  // namespace gf
