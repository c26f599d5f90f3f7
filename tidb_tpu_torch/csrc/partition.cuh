// The owner partition M3 (hash_repartition.cu) and P2 (exchange.cu)
// share: a tile of compact::TILE rows, taken in ticket order, sends each
// row to one of nd owners (or to none: the bin nd) and must know where
// each owner's rows land, in row order, without a sort.
//
// A warp holds ITEMS rounds of 32 consecutive rows (row base + r * 32,
// r < ITEMS, base = tile * TILE + warp * 32 * ITEMS + lane), so the tile's
// rows in warp order are its rows in row order. Three steps, each called
// by every thread of the block:
//
//   rank_rows     each row's rank among its warp's rows of its owner (one
//                 ballot a bit of the bin, a running count a warp and owner
//                 in shared memory)
//   warp_offsets  per owner, each warp's first slot among the tile's rows
//                 of the owner and the tile's count, published at once as
//                 the tile's aggregate in look-back slot (tile, owner)
//   look_back_owners
//                 warp w looks back owners w, w + WARPS, ...: the owner's
//                 rows in the tiles before, its inclusive prefix published
//                 for the tiles after; the last tile writes each total
//
// A row of owner o then lands at (rows of o before the tile) + (its warp's
// first slot of o) + (its rank): its owner's slots fill in row order.

#pragma once

#include "compact.cuh"

namespace {
namespace part {

typedef long long ll;
using compact::LookBack;
using compact::P2;

constexpr int BLOCK = compact::BLOCK;
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

// rk[r]: the rank of round r's row among its warp's earlier rows of the
// same owner (o[r] == nd: no owner, rank unused). c: this warp's running
// count of each owner [nd], zeroed before the first call; it ends as the
// warp's count of each owner.
template <int N>
__device__ __forceinline__ void rank_rows(const int (&o)[N], int nd, int* c, int (&rk)[N]) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int nbits = 32 - __clz(nd);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    unsigned peers = FULL;
    for (int b = 0; b < nbits; ++b) {
      const unsigned bb = __ballot_sync(FULL, (o[r] >> b) & 1);
      peers &= ((o[r] >> b) & 1) ? bb : ~bb;
    }
    const bool real = o[r] < nd;
    const int before = real ? c[o[r]] : 0;
    __syncwarp();
    if (real && (peers & lt) == 0u) c[o[r]] = before + __popc(peers);
    __syncwarp();
    rk[r] = before + __popc(peers & lt);
  }
}

// cnt [WARPS][nd]: each warp's count of each owner in, each warp's first
// slot among the tile's rows of the owner out; tcount[q] the tile's rows
// of owner q, published as the tile's aggregate (inclusive at tile 0).
// Call after a barrier that follows rank_rows; the caller synchronizes
// before reading cnt or tcount.
__device__ __forceinline__ void warp_offsets(const LookBack& lb, ll tile, int nd, int* cnt, int* tcount) {
  for (int q = threadIdx.x; q < nd; q += BLOCK) {
    int run = 0;
    for (int ww = 0; ww < WARPS; ++ww) {
      const int x = cnt[ww * nd + q];
      cnt[ww * nd + q] = run;
      run += x;
    }
    tcount[q] = run;
    compact::put_desc(lb.desc(tile * nd + q), tile == 0 ? 2 : 1, P2{run, 0});
  }
}

// gbase[q]: owner q's rows in the tiles before this one (look-back slot q
// of every tile before), its inclusive prefix published; the last of
// ntiles tiles writes tot[q] (the owner's rows in all). Call after a
// barrier that follows warp_offsets; the caller synchronizes before
// reading gbase.
__device__ __forceinline__ void look_back_owners(const LookBack& lb, ll tile, ll ntiles, int nd, const int* tcount,
                                                 ll* gbase, ll* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int q = w; q < nd; q += WARPS) {
    ll before = 0;
    if (tile > 0) {
      before = compact::look_back(lb, tile, nd, q, compact::AddA()).a;
      if (lane == 0) compact::put_desc(lb.desc(tile * nd + q), 2, P2{before + tcount[q], 0});
    }
    if (lane == 0) {
      gbase[q] = before;
      if (tile == ntiles - 1) tot[q] = before + tcount[q];
    }
  }
}

}  // namespace part
}  // namespace
