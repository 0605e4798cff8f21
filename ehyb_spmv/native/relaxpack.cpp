// Relaxed SELL-body step assignment for the converter's relaxed packer
// (core/convert.py::_sell_pack_relaxed).  Each (slice, window-pair) "pair" is
// an independent bipartite multigraph: row lanes (128) on one side, x slots
// (128) on the other, one edge per body entry.  A step ("color") may hold
// each lane at most once and each slot for one class only.  Plain C ABI,
// loaded via ctypes like partition.cpp.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Relaxed SELL-body step assignment (convert.py::_sell_pack_relaxed): the
// same class-aware condition as ehyb_color_edges_cls — per (pair, step) each
// lane at most once, each slot single-class — but with UNBOUNDED colors (the
// body never spills; a pair's step count is whatever its Δ demands) and the
// objective "minimize per-pair max color" (padded stream size), served by
// the same lowest-free-color greedy.  Replaces the vectorized round
// election (_pack_steps_relaxed), which cost ~5.5 min at 84M nnz on
// permuted_poisson_4096 AND packs ~1.1-1.5x looser (the election assigns
// one step per round; the greedy backfills).  Reference economics analog:
// the one-pass C converter, convert.c:170-311.
//
// order MUST be grouped by pair (entries of one pair contiguous) — the
// caller's hint sort is pair-primary.  Masks are word-chunked uint64 with
// per-pair epochs (no O(n_pairs) state, no per-pair memset).  Returns the
// max color used + 1, or -1 on bad args, -2 if some pair exceeds MAXC.
long long ehyb_pack_relaxed(long long n_edges,
                            const int64_t* pair,
                            const int16_t* lane,
                            const int16_t* slot,
                            const int16_t* cls,
                            const int64_t* order,
                            int32_t* color_out) {
  if (n_edges < 0) return -1;
  constexpr int W = 256;             // 16384-color cap per pair
  constexpr int MAXC = W * 64;
  static_assert(MAXC <= INT16_MAX + 1, "hub cap");
  std::vector<uint64_t> lmask(128 * W, 0), smask(128 * W, 0);
  std::vector<int64_t> lepoch(128, -1), sepoch(128, -1);
  std::vector<int32_t> lhi(128, 0), shi_hi(128, 0);  // high-water word + 1
  // class per (slot, color); valid only under smask bits of this epoch
  std::vector<uint8_t> scls((size_t)128 * MAXC, 0);
  int64_t cur = -1;
  long long maxc = 0;
  for (long long k = 0; k < n_edges; ++k) {
    const int64_t e = order[k];
    if (pair[e] != cur) cur = pair[e];
    const int la = (uint16_t)lane[e], sl = (uint16_t)slot[e];
    uint64_t* lm = &lmask[(size_t)la * W];
    uint64_t* sm = &smask[(size_t)sl * W];
    if (lepoch[la] != cur) {
      std::memset(lm, 0, (size_t)lhi[la] * 8);
      lepoch[la] = cur;
      lhi[la] = 0;
    }
    if (sepoch[sl] != cur) {
      std::memset(sm, 0, (size_t)shi_hi[sl] * 8);
      sepoch[sl] = cur;
      shi_hi[sl] = 0;
    }
    const uint8_t c8 = (uint8_t)cls[e];
    uint8_t* hi = &scls[(size_t)sl * MAXC];
    int c = -1;
    for (int w = 0; w < W; ++w) {
      // free ride first: slot occupied by the SAME class and lane free
      uint64_t occ = sm[w] & ~lm[w];
      uint64_t ride = 0;
      while (occ) {
        const int b = __builtin_ctzll(occ);
        occ &= occ - 1;
        if (hi[w * 64 + b] == c8) { ride = 1ull << b; break; }
      }
      if (ride) { c = w * 64 + __builtin_ctzll(ride); }
      else {
        const uint64_t freeb = ~(lm[w] | sm[w]);
        if (freeb) c = w * 64 + __builtin_ctzll(freeb);
      }
      if (c >= 0) {
        const uint64_t bit = 1ull << (c & 63);
        lm[w] |= bit;
        sm[w] |= bit;
        hi[c] = c8;
        if (w + 1 > lhi[la]) lhi[la] = w + 1;
        if (w + 1 > shi_hi[sl]) shi_hi[sl] = w + 1;
        break;
      }
    }
    if (c < 0) return -2;
    color_out[e] = c;
    if (c + 1 > maxc) maxc = c + 1;
  }
  return maxc;
}

}  // extern "C"
