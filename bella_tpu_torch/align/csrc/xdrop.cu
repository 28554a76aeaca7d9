// Banded gapped x-drop extension on Hopper (sm_90a): several extensions
// a warp at W <= 256 in the static mode (the grouped tile), a warp per
// extension otherwise (a few warps at W > 512), the band in registers, a
// persistent grid that takes extensions longest first, each extension's
// bases read straight from a flat word stream through its descriptor.
//
// Replaces the Pallas TPU kernel bella_tpu/align/pallas_xdrop.py:_kernel
// (entries extend_batch_pallas_packed and extend_batch_pallas) in the
// static mode (K1), and the lax.while_loop of bella_tpu/align/xdrop.py:
// extend_batch in the adaptive mode (K2); on the main path it also does
// what the extension prep (K3, after its own notes below; bella_tpu's
// _prepare_extensions_packed) did there: each extension's two streams are
// descriptors on the reads' ragged word stream, not materialised rows, so
// a whole cascade level is one launch.
//
// What bounds it on the H100: neither bytes nor operations, but the
// issue slots of the schedulers. Each extension is a chain of dependent
// antidiagonals (up to t_len + q_len of them), each ending in a max
// reduction over the band. A launch holds a whole cascade level (up to
// millions of extensions, taken longest first), so every resident warp
// runs a thousand or more extensions in turn, and the launch ends when
// the schedulers have issued every extension's steps: its time is the
// steps over the rate at which they are issued, not its longest chain.
// Most of a step's instructions do not grow with the lanes a thread
// holds (the key's tree, the reduction, the edge shuffles, the base
// rings, the bounds, the bookkeeping), so the design pays them for as
// many cells as the registers allow. The reads' words (34 MB for a
// 137-Mbp corpus) stay in the 50 MB L2 and are read once per 16 steps of
// a thread's window:
//   * the grouped tile (the static mode's int32-key launches at W <= 256,
//     xdrop_grouped_kernel): each thread holds 16 consecutive band lanes,
//     an extension takes a group of W / 16 threads rounded up to a power
//     of two (at least 4; 8 at W = 128, 16 at W = 256), and a warp runs
//     32 / that many extensions side by side, in lockstep. The group's max
//     key comes by a butterfly of __shfl_xor_sync inside the group, its
//     edge lanes by shuffles of the group's width. A group takes its next
//     extension at the end of a two-antidiagonal turn, so every group of
//     a warp holds the same parity of d, and the static mode's predecessor
//     shifts (which hang on d alone once d > W) agree across the warp: it
//     diverges only while a group is in its first W antidiagonals;
//   * otherwise a group of G = ceil(W / (32 * LPT)) warps runs one
//     extension; each thread holds LPT (4, 8 or 16) consecutive band lanes
//     p = LPT * t + q of antidiagonals d - 2 and d - 1 in registers, and
//     writes d over d - 2 in place (in the lane order that reads each
//     predecessor before it is overwritten). The adaptive mode takes one
//     warp at W = 128 / 256 / 512 (4 / 8 / 16 lanes a thread), the static
//     mode at W = 512; 1024 and 2048 take two and four. Lanes >= W hold
//     NINF, never win the max and read as out of band (both tiles);
//   * the predecessor shifts lo(d) - lo(d-1) and lo(d-1) - lo(d-2) are
//     uniform across the group and each 0 or 1, so each step branches,
//     without divergence, to one of four cell loops whose predecessors are
//     fixed registers; the neighbouring threads' edge lanes come by one
//     __shfl_up_sync and one __shfl_down_sync per row;
//   * cells are kept as w = value + d, which turns the update into one DPX
//     instruction, w = __viaddmax_s32(w_diag, 1 or 3, max(w_gq, w_gt)):
//     the gap cost and the mismatch cost become the shift of d;
//   * the base comparisons of a thread's lanes are one XOR of its T bases
//     against its Q bases, bit-reversed (Q runs backwards along an
//     antidiagonal), from a ring of three packed words per row and thread
//     that loads one word when the thread's window crosses a word;
//   * a stream's word j (its bases 16 j .. 16 j + 15) is loaded as the
//     extension prep wrote it: from the descriptor (flat base address of
//     the stream's base 0, direction +1 or -1, complement flag) two loads
//     of the flat stream (__ldg, indexes clamped to it), a funnel shift, a
//     base reversal on -1 streams and a complement; words at or past the
//     stream's length read 0. A materialised row is the descriptor of
//     address 16 * row * stride, direction +1, no complement;
//   * the antidiagonal's max and its lowest lane come from one
//     __reduce_max_sync (REDUX; the grouped tile: the butterfly) of an
//     int32 key, w * span + (span - 1 - p);
//     while it runs, the next antidiagonal's bases and the new row's
//     neighbouring lanes are prepared. With G > 1 warps, the warps' keys
//     and edge lanes go through shared memory behind one named barrier per
//     antidiagonal over that group's warps only;
//   * the key holds w only while lengths and xdrop stay below 2^17 (see
//     kKeyFloor). Longer extensions take the long-key instantiation
//     (LONGKEY): a REDUX max of w, then a REDUX min of the lane among the
//     lanes that hold it, which is exact while w = value + d fits int32
//     (lengths below 2^29);
//   * a persistent grid of two blocks per SM (three in the grouped tile)
//     takes extensions from a global counter over an order sorted by
//     t_len + q_len, longest first, so the long chains start first and
//     the launch ends on short ones. Results go to the extension's own
//     index.
// The Pallas kernel's feed buffers, rolls and ramp / generic / steady
// step specialisations exist for the TPU's single scalar unit and are not
// carried over.
//
// Semantics held bit for bit against the reference (scores +1 / -1 / -1):
//   * antidiagonal d holds cells (i, j) = (lo(d) + p, d - lo(d) - p), p < W;
//     static mode: lo(d) = max(0, (d - W + 1) >> 1); adaptive mode: lo
//     moves by one after a step whose first argmax lane is > W / 2;
//   * d = 0 holds lane 0 = 0; d = 1 holds lane 0 = gap if q_len >= 1 and
//     lane 1 = gap if t_len >= 1; invalid cells are NINF; the adaptive
//     mode clamps every cell at NINF, the static mode does not;
//   * records (best score, then its first antidiagonal, then its lowest
//     lane) are taken before the liveness test, so the step that kills a
//     pair still records; a pair dies when its antidiagonal max falls
//     below best - xdrop or d reaches t_len + q_len;
//   * cells with i = 0 or j = 0 compare no bases: their diagonal
//     predecessor is NINF, so the substitution score cannot win there;
//     cells past a stream's length are invalid, so the bases a word holds
//     beyond it never count;
//   * bases are 16 per 32-bit word, least significant first.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNinf = -(1 << 20);
// Lane and w share one int32 key for the per-antidiagonal reduction:
// key = w * span + (span - 1 - lane), span = 32 * LPT * G. The max key is
// the antidiagonal max and its lowest lane. w >= kNinf (every cell is the
// max of a predecessor and more), and w < 2^18 + 2^17 (scores < 2^17,
// d < 2^18), so keys fit for span <= 2048; at span 4096 w is floored at
// kKeyFloor + d first. Values below kKeyFloor only occur on antidiagonals
// that kill the pair (xdrop < 2^17), so flooring them changes no result.
// The wrapper takes this key only for launches whose lengths and xdrop are
// below 2^17, and the long-key instantiation for the others.
constexpr int kKeyFloor = -(1 << 18);
constexpr int kBlockThreads = 256;
// Blocks the persistent grid of the one-warp tiles keeps on each SM
// (fewer if the occupancy is lower): 16 warps, 4 a scheduler. Measured on
// the demo corpus at 1, 2, 3 and the occupancy limit when a launch held
// some 8,192 extensions and ended on its longest chain: 2 was fastest at
// every band. Not measured again since a cascade level became one launch
// (the grouped tile's own count is kGroupedBlocksPerSm).
constexpr int kBlocksPerSm = 2;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

__device__ __forceinline__ int lo_static(int d, int W) {
  const int x = (d - (W - 1)) >> 1;
  return x > 0 ? x : 0;
}

// The sixteen 2-bit groups of w in reverse order (_revbase_words).
__device__ __forceinline__ uint32_t reverse_bases(uint32_t w) {
  w = __brev(w);
  return ((w >> 1) & 0x55555555u) | ((w & 0x55555555u) << 1);
}

// One extension stream on a flat word stream of n_words words. Its
// descriptor `at` is 4 a + 2 back + comp: base t of the stream is flat
// base a + t (a - t where back), complemented where comp.
struct Stream {
  long long a0;  // flat address of word 0's lowest flat base
  int s16;       // +16 or -16: flat bases from one word to the next
  int nw;        // words that hold the stream's bases
  uint32_t x;    // 0, or all ones to complement
};

__device__ __forceinline__ Stream stream_of(long long at, int n) {
  Stream s;
  const bool back = (at & 2) != 0;
  s.a0 = (at >> 2) - (back ? 15 : 0);
  s.s16 = back ? -16 : 16;
  s.nw = (n + 15) >> 4;
  s.x = (at & 1) ? 0xffffffffu : 0u;
  return s;
}

// Word j of stream s (its bases 16 j .. 16 j + 15, the first at the least
// significant bits); 0 outside the stream's words. Word indexes are
// clamped to the flat stream: bases read there lie past the stream's
// length.
__device__ __forceinline__ uint32_t word_at(const Stream& s,
                                            const uint32_t* words,
                                            long long n_words, int j) {
  if ((unsigned)j >= (unsigned)s.nw) return 0u;
  const long long a = s.a0 + (long long)s.s16 * j;
  const long long i0 = a >> 4;
  const long long lo = i0 < 0 ? 0 : i0 >= n_words ? n_words - 1 : i0;
  const long long hi =
      i0 + 1 < 0 ? 0 : i0 + 1 >= n_words ? n_words - 1 : i0 + 1;
  uint32_t w = __funnelshift_r(__ldg(words + lo), __ldg(words + hi),
                               2 * (int)(a & 15));
  if (s.s16 < 0) w = reverse_bases(w);
  return w ^ s.x;
}

// Barrier over the G warps of group `grp` only (ids 1.., 0 is the block's).
template <int G>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(32 * G) : "memory");
}

// Antidiagonal d over row d - 2 in place, for the shifts SD = lo(d) -
// lo(d-2) - 1 (diagonal: row[q + SD]) and D1 = lo(d) - lo(d-1) (gaps:
// prv[q + D1 - 1], prv[q + D1]); n1 and n2 are the one lane of row and
// prv beyond the thread's own that the shifts reach. add holds 3 (match)
// or 1 (mismatch) per lane, 2 bits each.
template <int LPT, int SD, int D1>
__device__ __forceinline__ void cells(int (&row)[LPT], const int (&prv)[LPT],
                                      int n1, int n2, uint32_t add) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int q = SD < 0 ? LPT - 1 - k : k;
    const int s = q + SD;
    const int diag =
        s < 0 || s >= LPT ? n1 : row[s < 0 ? 0 : s >= LPT ? 0 : s];
    const int ga = q + D1 - 1;
    const int gb = q + D1;
    const int g0 = ga < 0 ? n2 : prv[ga < 0 ? 0 : ga];
    const int g1 = gb >= LPT ? n2 : prv[gb >= LPT ? 0 : gb];
    row[q] = __viaddmax_s32(diag, (int)((add >> (2 * q)) & 3u), max(g0, g1));
  }
}

// The clamp (adaptive mode), the mask of lanes outside rl..rh (thread
// relative; MASK false when every lane is valid) and the thread's best key.
template <bool ADAPTIVE, int LPT, int kSpan, bool MASK>
__device__ __forceinline__ int finish(int (&row)[LPT], int nd, int d, int p0,
                                      int rl, int rh) {
  int keys[LPT];
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    int w = row[q];
    if (ADAPTIVE) w = max(w, nd);
    if (MASK) w = q >= rl && q <= rh ? w : nd;
    row[q] = w;
    const int kw = kSpan > 2048 ? max(w, kKeyFloor + d) : w;
    keys[q] = kw * kSpan + (kSpan - 1 - p0 - q);
  }
  // a tree of 3-way maxima, not a chain
#pragma unroll
  for (int n = LPT; n > 1; n = (n + 2) / 3) {
#pragma unroll
    for (int i = 0; i < (n + 2) / 3; ++i) {
      const int a = keys[3 * i];
      const int b = 3 * i + 1 < n ? keys[min(3 * i + 1, LPT - 1)] : a;
      const int c = 3 * i + 2 < n ? keys[min(3 * i + 2, LPT - 1)] : a;
      keys[i] = __vimax3_s32(a, b, c);
    }
  }
  return keys[0];
}

// finish for the long key: the thread's max w (x) and the lowest band lane
// that holds it (y).
template <bool ADAPTIVE, int LPT, bool MASK>
__device__ __forceinline__ int2 finish_long(int (&row)[LPT], int nd, int p0,
                                            int rl, int rh) {
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    int w = row[q];
    if (ADAPTIVE) w = max(w, nd);
    if (MASK) w = q >= rl && q <= rh ? w : nd;
    row[q] = w;
  }
  int m = row[0];
#pragma unroll
  for (int q = 1; q < LPT; ++q) m = max(m, row[q]);
  int lane = p0 + LPT - 1;
#pragma unroll
  for (int q = LPT - 2; q >= 0; --q) lane = row[q] == m ? p0 + q : lane;
  return make_int2(m, lane);
}

// One extension's walk, shared by its group's threads.
struct Walk {
  Stream ts, qs;
  int tl, ql;
  int lo_m2, lo_m1, lo;  // lo(d - 2), lo(d - 1), lo(d)
  int d, step;
  int best, best_t, best_q;
  bool alive;
  // words tw .. tw + 2 of T and qw .. qw + 2 of Q around the thread's lanes
  uint32_t t0, t1, t2, q0, q1, q2;
  int tw, qw;
  // antidiagonal d's match word (3 or 1 per lane, 2 bits each)
  uint32_t add;
  // the lanes left and right of the thread's own in rows d - 2 (1) and
  // d - 1 (2): the neighbouring threads', or NINF past the band
  int l1, r1, l2, r2;
};

// 3 (match) or 1 (mismatch) per lane, 2 bits each, from lane q's T base at
// bits 2q of tb and its Q base at bits 2 (LPT - 1 - q) of qb. Bit reversal
// puts Q's base at bits 2q with its two bits swapped, so T's are swapped
// too before the XOR.
template <int LPT>
__device__ __forceinline__ uint32_t match_word(uint32_t tb, uint32_t qb) {
  const uint32_t rq = __brev(qb) >> (32 - 2 * LPT);
  const uint32_t ts = ((tb >> 1) & 0x55555555u) | ((tb << 1) & 0xaaaaaaaau);
  const uint32_t xr = ts ^ rq;
  return ((~(xr | (xr >> 1)) & 0x55555555u) << 1) | 0x55555555u;
}

// The bases of antidiagonal dn, whose lanes q need T[lo(dn) + p0 + q - 1]
// and Q[dn - lo(dn) - p0 - q - 1], with lo(dn) = lp or lp + 1, lp =
// lo(dn - 1): the word rings move on (the windows start at the lowest
// index either lo(dn) can need, and move by at most one base a step), and
// the match words for lo(dn) = lp + e (*a0) and lp + 1 (*a1; BOTH only).
template <int LPT, bool BOTH>
__device__ __forceinline__ void bases(Walk& x, const uint32_t* TW,
                                      long long t_words, const uint32_t* QW,
                                      long long q_words, int lp, int dn,
                                      int p0, int e, uint32_t* a0,
                                      uint32_t* a1) {
  const int sT = lp + p0 - 1;
  if ((sT >> 4) != x.tw) {
    x.t0 = x.t1;
    x.t1 = x.t2;
    ++x.tw;
    x.t2 = word_at(x.ts, TW, t_words, x.tw + 2);
  }
  const int sQ = dn - lp - 1 - p0 - LPT;
  if ((sQ >> 4) != x.qw) {
    x.q0 = x.q1;
    x.q1 = x.q2;
    ++x.qw;
    x.q2 = word_at(x.qs, QW, q_words, x.qw + 2);
  }
  const int ot = 2 * (sT & 15);
  const int oq = 2 * (sQ & 15);
  *a0 = match_word<LPT>(__funnelshift_rc(x.t0, x.t1, ot + 2 * e),
                        __funnelshift_rc(x.q0, x.q1, oq + 2 - 2 * e));
  if (BOTH)
    *a1 = match_word<LPT>(__funnelshift_rc(x.t0, x.t1, ot + 2),
                          __funnelshift_rc(x.q0, x.q1, oq));
}

// Antidiagonal d of walk x: row holds d - 2 and gets d; prv holds d - 1.
// Everything antidiagonal d + 1 needs that does not hang on this one's
// reduction (row d's neighbouring lanes, the bases) is prepared while the
// reduction is in flight.
template <bool ADAPTIVE, int LPT, int G, bool LONGKEY>
__device__ __forceinline__ void advance(Walk& x, int (&row)[LPT],
                                        const int (&prv)[LPT], int lane,
                                        int warp, int wg, int grp, int p0,
                                        int W, int xdrop,
                                        int (*xch)[kBlockWarps][4],
                                        const uint32_t* TW, long long t_words,
                                        const uint32_t* QW,
                                        long long q_words) {
  constexpr int kSpan = 32 * LPT * G;
  constexpr int kLog = log2_of(kSpan);
  const int d = x.d;
  const int lo = x.lo;
  const int dlt0 = x.lo_m1 - x.lo_m2;
  const int dlt1 = lo - x.lo_m1;
  if (dlt1 == 0) {
    if (dlt0 == 0)
      cells<LPT, -1, 0>(row, prv, x.l1, x.l2, x.add);
    else
      cells<LPT, 0, 0>(row, prv, 0, x.l2, x.add);
  } else {
    if (dlt0 == 0)
      cells<LPT, 0, 1>(row, prv, 0, x.r2, x.add);
    else
      cells<LPT, 1, 1>(row, prv, x.r1, x.r2, x.add);
  }

  // invalid cells (and lanes >= W) to NINF, the adaptive clamp, the key;
  // valid lanes are plo..phi, which in mid-extension is the whole tile
  const int nd = kNinf + d;
  const int plo = d - lo - x.ql;
  const int phi = min(W - 1, min(x.tl, d) - lo);
  const bool whole = plo <= 0 && phi >= kSpan - 1;
  // int32 key: the key; long key: the max w, then its lowest lane
  int key, wmax = 0, lmin = 0;
  if constexpr (LONGKEY) {
    const int2 tb =
        whole ? finish_long<ADAPTIVE, LPT, false>(row, nd, p0, 0, 0)
              : finish_long<ADAPTIVE, LPT, true>(row, nd, p0,
                                                 max(0, plo) - p0, phi - p0);
    wmax = __reduce_max_sync(kFull, tb.x);
    lmin = __reduce_min_sync(kFull, tb.x == wmax ? tb.y : INT_MAX);
    key = 0;
  } else {
    const int kbest =
        whole ? finish<ADAPTIVE, LPT, kSpan, false>(row, nd, d, p0, 0, 0)
              : finish<ADAPTIVE, LPT, kSpan, true>(row, nd, d, p0,
                                                   max(0, plo) - p0,
                                                   phi - p0);
    key = __reduce_max_sync(kFull, kbest);
  }

  // while the reduction runs: row d's neighbouring lanes, and the bases of
  // d + 1 (static mode: lo(d + 1) is known; adaptive: both candidates)
  int ln = __shfl_up_sync(kFull, row[LPT - 1], 1);
  int rn = __shfl_down_sync(kFull, row[0], 1);
  if (lane == 0) ln = nd;
  if (lane == 31) rn = nd;
  const int lo_next = ADAPTIVE ? lo : lo_static(d + 1, W);
  uint32_t a0, a1 = 0;
  bases<LPT, ADAPTIVE>(x, TW, t_words, QW, q_words, lo, d + 1, p0,
                       lo_next - lo, &a0, &a1);
  if constexpr (G > 1) {
    // one barrier per antidiagonal publishes the warps' keys and edge
    // lanes; they alternate between two slots so the next step's writes
    // cannot meet a slow reader of this step's
    int(*xs)[4] = xch[x.step & 1];
    if (lane == 0) {
      xs[warp][0] = LONGKEY ? wmax : key;
      xs[warp][1] = row[0];
      if (LONGKEY) xs[warp][3] = lmin;
    }
    if (lane == 31) xs[warp][2] = row[LPT - 1];
    group_sync<G>(grp);
    const int w0 = grp * G;
    if constexpr (LONGKEY) {
      // warps hold increasing lanes: the first warp with the max has the
      // lowest lane
#pragma unroll
      for (int w = 0; w < G; ++w) wmax = max(wmax, xs[w0 + w][0]);
#pragma unroll
      for (int w = G - 1; w >= 0; --w)
        lmin = xs[w0 + w][0] == wmax ? xs[w0 + w][3] : lmin;
    } else {
#pragma unroll
      for (int w = 0; w < G; ++w) key = max(key, xs[w0 + w][0]);
    }
    if (lane == 0 && wg > 0) ln = xs[warp - 1][2];
    if (lane == 31 && wg < G - 1) rn = xs[warp + 1][1];
  }
  const int argp = LONGKEY ? lmin : kSpan - 1 - (key & (kSpan - 1));
  const int cur = LONGKEY ? wmax - d : (key >> kLog) - d;

  if (cur > x.best) {
    x.best = cur;
    x.best_t = lo + argp;
    x.best_q = d - x.best_t;
  }
  x.alive = cur >= x.best - xdrop && d < x.tl + x.ql;
  x.lo_m2 = x.lo_m1;
  x.lo_m1 = lo;
  if (ADAPTIVE) {
    const bool move = x.alive && argp > W / 2;
    x.lo = lo + move;
    x.add = move ? a1 : a0;
  } else {
    x.lo = lo_next;
    x.add = a0;
  }
  x.l1 = x.l2;
  x.r1 = x.r2;
  x.l2 = ln;
  x.r2 = rn;
  ++x.d;
  ++x.step;
}

template <bool ADAPTIVE, int LPT, int G, bool LONGKEY>
__global__ void __launch_bounds__(kBlockThreads)
xdrop_kernel(const uint32_t* __restrict__ TW, long long t_words,
             const long long* __restrict__ t_at,
             const uint32_t* __restrict__ QW, long long q_words,
             const long long* __restrict__ q_at,
             const int* __restrict__ t_len, const int* __restrict__ q_len,
             const int* __restrict__ order, int* __restrict__ next, int B,
             int W, int xdrop, int max_steps,
             int* __restrict__ score_out, int* __restrict__ te_out,
             int* __restrict__ qe_out, int* __restrict__ steps_out) {
  // per step parity and warp: the warp's key (long key: its max w), first
  // lane, last lane and (long key) the lowest lane holding the max
  __shared__ int xch[2][kBlockWarps][4];
  __shared__ int grab[kBlockWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = warp / G;          // extension group within the block
  const int wg = warp % G;           // warp within the group
  const int p0 = LPT * (32 * wg + lane);  // this thread's first band lane

  for (;;) {
    int k;
    if constexpr (G == 1) {
      k = lane == 0 ? atomicAdd(next, 1) : 0;
      k = __shfl_sync(kFull, k, 0);
    } else {
      group_sync<G>(grp);  // every warp has read the last grab
      if (wg == 0 && lane == 0) grab[grp] = atomicAdd(next, 1);
      group_sync<G>(grp);
      k = grab[grp];
    }
    if (k >= B) break;
    const int e = order[k];

    Walk x;
    x.tl = t_len[e];
    x.ql = q_len[e];
    x.ts = stream_of(t_at[e], x.tl);
    x.qs = stream_of(q_at[e], x.ql);
    x.lo_m2 = x.lo_m1 = x.lo = 0;
    x.d = 2;
    x.step = 0;
    x.best = x.best_t = x.best_q = 0;
    x.alive = x.tl + x.ql > 0;
    x.tw = (p0 - 1) >> 4;                 // windows of d = 2
    x.qw = (1 - p0 - LPT) >> 4;
    x.t0 = word_at(x.ts, TW, t_words, x.tw);
    x.t1 = word_at(x.ts, TW, t_words, x.tw + 1);
    x.t2 = word_at(x.ts, TW, t_words, x.tw + 2);
    x.q0 = word_at(x.qs, QW, q_words, x.qw);
    x.q1 = word_at(x.qs, QW, q_words, x.qw + 1);
    x.q2 = word_at(x.qs, QW, q_words, x.qw + 2);
    uint32_t a0, a1;
    bases<LPT, false>(x, TW, t_words, QW, q_words, 0, 2, p0, 0, &a0,
                      &a1);  // lo(2) = 0
    x.add = a0;
    // rows d = 0 and 1 in w = value + d: only lanes 0 and 1 hold values,
    // so every thread's neighbouring lanes are NINF
    x.l1 = x.r1 = kNinf;
    x.l2 = x.r2 = kNinf + 1;
    int ra[LPT], rb[LPT];
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      const int p = p0 + q;
      ra[q] = p == 0 ? 0 : kNinf;
      int v = kNinf + 1;
      if (p == 0 && x.ql >= 1) v = 0;
      if (p == 1 && x.tl >= 1) v = 0;
      rb[q] = v;
    }
    // two antidiagonals a turn, so the rows swap roles without copies
    for (;;) {
      if (!x.alive || x.step >= max_steps) break;
      advance<ADAPTIVE, LPT, G, LONGKEY>(x, ra, rb, lane, warp, wg, grp, p0,
                                         W, xdrop, xch, TW, t_words, QW,
                                         q_words);
      if (!x.alive || x.step >= max_steps) break;
      advance<ADAPTIVE, LPT, G, LONGKEY>(x, rb, ra, lane, warp, wg, grp, p0,
                                         W, xdrop, xch, TW, t_words, QW,
                                         q_words);
    }
    if (wg == 0 && lane == 0) {
      score_out[e] = x.best;
      te_out[e] = x.best_t;
      qe_out[e] = x.best_q;
      if (steps_out) steps_out[e] = x.step;
    }
  }
}

// The grouped tile: the static mode's int32-key launches at W <=
// kGroupedMaxW. A thread holds kGroupedLpt band lanes, an extension takes
// a group of GS threads (W / 16 rounded up to a power of two, at least
// 4), and a warp runs 32 / GS extensions side by side.
constexpr int kGroupedMaxW = 256;
constexpr int kGroupedLpt = 16;
// Blocks the grouped kernel keeps on each SM, and asks ptxas to fit
// (fewer if the occupancy is lower). Measured on an H100 on d6k's first
// level (2.87 M extensions at W = 128) and its W = 256 level, medians
// in ms: 1 block 1,145 / 780; 2 (89 registers, the occupancy limit
// without the bound) 846 / 558; 3 (80 registers, no spills) 800 / 522;
// 4 (64 registers, 216 bytes spilled) 898 / 591.
constexpr int kGroupedBlocksPerSm = 3;

// Walk x of a new extension of lengths tl and ql on the streams of
// descriptors ta and qa, rows d = 0 (ra) and d = 1 (rb) of the thread's
// lanes p0 ..; lengths 0 give a walk that is dead from the start and
// loads nothing. In the grouped tile x.step is -1 while the walk lives
// and its count of antidiagonals once it has ended (x.alive is unused).
template <int LPT>
__device__ __forceinline__ void begin(Walk& x, int (&ra)[LPT],
                                      int (&rb)[LPT], int tl, int ql,
                                      long long ta, long long qa, int p0,
                                      int max_steps, const uint32_t* TW,
                                      long long t_words, const uint32_t* QW,
                                      long long q_words) {
  x.tl = tl;
  x.ql = ql;
  x.ts = stream_of(ta, tl);
  x.qs = stream_of(qa, ql);
  x.lo_m2 = x.lo_m1 = x.lo = 0;
  x.d = 2;
  x.step = tl + ql > 0 && max_steps > 0 ? -1 : 0;
  x.best = x.best_t = x.best_q = 0;
  x.tw = (p0 - 1) >> 4;  // windows of d = 2
  x.qw = (1 - p0 - LPT) >> 4;
  x.t0 = word_at(x.ts, TW, t_words, x.tw);
  x.t1 = word_at(x.ts, TW, t_words, x.tw + 1);
  x.t2 = word_at(x.ts, TW, t_words, x.tw + 2);
  x.q0 = word_at(x.qs, QW, q_words, x.qw);
  x.q1 = word_at(x.qs, QW, q_words, x.qw + 1);
  x.q2 = word_at(x.qs, QW, q_words, x.qw + 2);
  uint32_t a0, a1;
  bases<LPT, false>(x, TW, t_words, QW, q_words, 0, 2, p0, 0, &a0,
                    &a1);  // lo(2) = 0
  x.add = a0;
  // rows d = 0 and 1 in w = value + d: only lanes 0 and 1 hold values,
  // so every thread's neighbouring lanes are NINF
  x.l1 = x.r1 = kNinf;
  x.l2 = x.r2 = kNinf + 1;
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    const int p = p0 + q;
    ra[q] = p == 0 ? 0 : kNinf;
    int v = kNinf + 1;
    if (p == 0 && ql >= 1) v = 0;
    if (p == 1 && tl >= 1) v = 0;
    rb[q] = v;
  }
}

// Antidiagonal d of walk x in the grouped tile (t: the thread's place in
// its group), as advance does it with one warp. The group's max key
// comes by a butterfly of shuffles inside the group, its edge lanes by
// shuffles of width GS. Every thread of the warp runs every step; a walk
// that has ended moves on without recording, so the warp's shuffles never
// wait on a group that has left.
template <int GS>
__device__ __forceinline__ void advance_grouped(
    Walk& x, int (&row)[kGroupedLpt], const int (&prv)[kGroupedLpt], int t,
    int p0, int W, int xdrop, int max_steps, const uint32_t* TW,
    long long t_words, const uint32_t* QW, long long q_words) {
  constexpr int LPT = kGroupedLpt;
  constexpr int kSpan = LPT * GS;
  constexpr int kLog = log2_of(kSpan);
  const int d = x.d;
  const int lo = x.lo;
  const int dlt0 = x.lo_m1 - x.lo_m2;
  const int dlt1 = lo - x.lo_m1;
  if (dlt1 == 0) {
    if (dlt0 == 0)
      cells<LPT, -1, 0>(row, prv, x.l1, x.l2, x.add);
    else
      cells<LPT, 0, 0>(row, prv, 0, x.l2, x.add);
  } else {
    if (dlt0 == 0)
      cells<LPT, 0, 1>(row, prv, 0, x.r2, x.add);
    else
      cells<LPT, 1, 1>(row, prv, x.r1, x.r2, x.add);
  }

  const int nd = kNinf + d;
  const int plo = d - lo - x.ql;
  const int phi = min(W - 1, min(x.tl, d) - lo);
  const bool whole = plo <= 0 && phi >= kSpan - 1;
  int key = whole ? finish<false, LPT, kSpan, false>(row, nd, d, p0, 0, 0)
                  : finish<false, LPT, kSpan, true>(row, nd, d, p0,
                                                    max(0, plo) - p0,
                                                    phi - p0);
#pragma unroll
  for (int m = GS / 2; m > 0; m >>= 1)
    key = max(key, __shfl_xor_sync(kFull, key, m));

  int ln = __shfl_up_sync(kFull, row[LPT - 1], 1, GS);
  int rn = __shfl_down_sync(kFull, row[0], 1, GS);
  if (t == 0) ln = nd;
  if (t == GS - 1) rn = nd;
  const int lo_next = lo_static(d + 1, W);
  uint32_t a0, a1;
  bases<LPT, false>(x, TW, t_words, QW, q_words, lo, d + 1, p0,
                    lo_next - lo, &a0, &a1);

  if (x.step < 0) {  // antidiagonal d is the walk's (d - 1)-th
    const int cur = (key >> kLog) - d;
    if (cur > x.best) {
      x.best = cur;
      x.best_t = lo + kSpan - 1 - (key & (kSpan - 1));
      x.best_q = d - x.best_t;
    }
    if (!(cur >= x.best - xdrop && d < x.tl + x.ql && d - 1 < max_steps))
      x.step = d - 1;
  }
  x.lo_m2 = x.lo_m1;
  x.lo_m1 = lo;
  x.lo = lo_next;
  x.add = a0;
  x.l1 = x.l2;
  x.r1 = x.r2;
  x.l2 = ln;
  x.r2 = rn;
  ++x.d;
}

// The grouped kernel: the persistent grid of xdrop_kernel, each warp's
// 32 / GS groups walking their extensions in lockstep, two antidiagonals
// a turn. A group whose extension ended (died, or reached max_steps or
// t_len + q_len) writes its result at the turn's end and takes the next
// extension there, starting it at d = 2 on the turn's first half: so
// every group of a warp holds an even d on the first half and an odd one
// on the second, the predecessor shifts of the static mode (which hang on
// d alone past the first W antidiagonals) agree across the warp, and the
// rows keep their registers' roles. The groups that take an extension at
// a turn's end share one atomicAdd on the counter. The warp leaves when
// the counter is past B for each of its groups.
template <int GS>
__global__ void __launch_bounds__(kBlockThreads, kGroupedBlocksPerSm)
xdrop_grouped_kernel(const uint32_t* __restrict__ TW, long long t_words,
                     const long long* __restrict__ t_at,
                     const uint32_t* __restrict__ QW, long long q_words,
                     const long long* __restrict__ q_at,
                     const int* __restrict__ t_len,
                     const int* __restrict__ q_len,
                     const int* __restrict__ order, int* __restrict__ next,
                     int B, int W, int xdrop, int max_steps,
                     int* __restrict__ score_out, int* __restrict__ te_out,
                     int* __restrict__ qe_out, int* __restrict__ steps_out) {
  constexpr int LPT = kGroupedLpt;
  const int lane = threadIdx.x & 31;
  const int t = lane & (GS - 1);  // thread within its group
  const int p0 = LPT * t;         // this thread's first band lane

  Walk x;
  int ra[LPT], rb[LPT];
  begin<LPT>(x, ra, rb, 0, 0, 0, 0, p0, max_steps, TW, t_words, QW,
             q_words);    // no extension yet: dead, so the group takes one
  // the group's extension: -1 before the first, -2 once the counter has
  // passed B for the group
  int e = -1;
  for (;;) {
    const bool done = x.step >= 0 && e != -2;
    const unsigned leads = __ballot_sync(kFull, done && t == 0);
    if (leads) {
      // one atomicAdd for every group that takes an extension now
      const int first = __ffs(leads) - 1;
      int k = 0;
      if (lane == first) k = atomicAdd(next, __popc(leads));
      k = __shfl_sync(kFull, k, first) +
          __popc(leads & ((1u << lane) - 1u));
      k = __shfl_sync(kFull, k, 0, GS);
      if (done) {
        if (e >= 0 && t == 0) {
          score_out[e] = x.best;
          te_out[e] = x.best_t;
          qe_out[e] = x.best_q;
          if (steps_out) steps_out[e] = x.step;
        }
        int tl = 0, ql = 0;
        long long ta = 0, qa = 0;
        if (k < B) {
          e = order[k];
          tl = t_len[e];
          ql = q_len[e];
          ta = t_at[e];
          qa = q_at[e];
        } else {
          e = -2;
        }
        begin<LPT>(x, ra, rb, tl, ql, ta, qa, p0, max_steps, TW, t_words,
                   QW, q_words);
      }
      if (__all_sync(kFull, e == -2)) break;
    }
    advance_grouped<GS>(x, ra, rb, t, p0, W, xdrop, max_steps, TW, t_words,
                        QW, q_words);
    advance_grouped<GS>(x, rb, ra, t, p0, W, xdrop, max_steps, TW, t_words,
                        QW, q_words);
  }
}

struct Args {
  const uint32_t* TW;
  long long t_words;
  const long long* t_at;
  const uint32_t* QW;
  long long q_words;
  const long long* q_at;
  const int *t_len, *q_len, *order;
  int* next;
  int B, W, xdrop, max_steps;
  int *score, *t_end, *q_end, *steps;
};

// The kernels of the persistent grid (xdrop_kernel and
// xdrop_grouped_kernel share their parameters).
using Kernel = void (*)(const uint32_t*, long long, const long long*,
                        const uint32_t*, long long, const long long*,
                        const int*, const int*, const int*, int*, int, int,
                        int, int, int*, int*, int*, int*);

// Extensions a persistent grid of `kernel` runs at once: blocks resident
// on the card (at most per_sm_max an SM) times `groups` extension groups
// a block; -1 when a query fails.
int slots_of(Kernel kernel, int groups, int per_sm_max, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kBlockThreads, 0);
  if (rc != cudaSuccess || per_sm <= 0) return -1;
  *blocks = sms * (per_sm < per_sm_max ? per_sm : per_sm_max);
  return *blocks * groups;
}

// slots_of into *slots where slots is given, else the launch of the grid
// on stream s (no more blocks than a.B needs).
int run_grid(Kernel kernel, int groups, int per_sm_max, const Args& a,
             cudaStream_t s, int* slots) {
  int blocks = 0;
  const int n = slots_of(kernel, groups, per_sm_max, &blocks);
  if (slots) return *slots = n;
  if (n < 0) {
    const cudaError_t rc = cudaGetLastError();
    return rc != cudaSuccess ? (int)rc : (int)cudaErrorInvalidConfiguration;
  }
  const long long need = ((long long)a.B + groups - 1) / groups;
  if (blocks > need) blocks = (int)need;
  kernel<<<blocks, kBlockThreads, 0, s>>>(
      a.TW, a.t_words, a.t_at, a.QW, a.q_words, a.q_at, a.t_len, a.q_len,
      a.order, a.next,
      a.B, a.W, a.xdrop, a.max_steps, a.score, a.t_end, a.q_end, a.steps);
  return (int)cudaGetLastError();
}

// Threads an extension takes in the grouped tile at band W (W / 16
// rounded up to a power of two, at least 4), or 0 where the one-warp
// tiles run it: the adaptive mode, the long key and W > kGroupedMaxW.
// pallas_xdrop.grouped_tile is the same rule.
int grouped_threads(int W, bool adaptive, bool long_key) {
  if (adaptive || long_key || W > kGroupedMaxW) return 0;
  int gs = 4;
  while (kGroupedLpt * gs < W) gs *= 2;
  return gs;
}

// The tile for band W: LPT lanes a thread (4, 8 or 16) and G warps an
// extension (1, 2, 4 or 8), chosen from W alone.
void tile(int W, int* lpt, int* g) {
  const int per = (W + 31) / 32;
  *lpt = per <= 4 ? 4 : per <= 8 ? 8 : 16;
  const int warps = (W + 32 * *lpt - 1) / (32 * *lpt);
  *g = warps <= 1 ? 1 : warps <= 2 ? 2 : warps <= 4 ? 4 : 8;
}

// The tile for band W and the mode: the grouped tile where
// grouped_threads says so, else LPT x G warps from tile(). The static
// int32-key launches reach the one-warp tiles only at W > kGroupedMaxW
// (LPT = 16), so they have no LPT = 4 or 8 instantiation.
template <bool A, bool LK>
int dispatch(const Args& a, cudaStream_t s, int* slots) {
  if constexpr (!A && !LK) {
    const int gs = grouped_threads(a.W, A, LK);
    if (gs > 0)
      return run_grid(gs == 4   ? xdrop_grouped_kernel<4>
                      : gs == 8 ? xdrop_grouped_kernel<8>
                                : xdrop_grouped_kernel<16>,
                      kBlockThreads / gs, kGroupedBlocksPerSm, a, s, slots);
  }
  int lpt = 0, g = 0;
  tile(a.W, &lpt, &g);
  Kernel k = g == 1   ? xdrop_kernel<A, 16, 1, LK>
             : g == 2 ? xdrop_kernel<A, 16, 2, LK>
             : g == 4 ? xdrop_kernel<A, 16, 4, LK>
                      : xdrop_kernel<A, 16, 8, LK>;
  if constexpr (A || LK) {
    if (lpt == 4) k = xdrop_kernel<A, 4, 1, LK>;
    if (lpt == 8) k = xdrop_kernel<A, 8, 1, LK>;
  }
  return run_grid(k, kBlockWarps / g, kBlocksPerSm, a, s, slots);
}

}  // namespace

// Launches the persistent x-drop kernel on `stream`. Pointers are device
// pointers; TW and QW are flat uint32 word streams of t_words and q_words
// words (16 bases a word, least significant first); t_at and q_at (B,)
// int64 the extensions' stream descriptors on them (see Stream), t_len
// and q_len (B,) int32 their lengths; `order` is a permutation of 0..B-1
// (the order extensions are taken in) and `next` one int32 that must be
// 0; steps may be null. long_key selects the long-key instantiation
// (needed once a length or xdrop reaches 2^17). Returns
// cudaGetLastError() after the launch.
extern "C" int bella_xdrop_launch(const void* TW, long long t_words,
                                  const void* t_at, const void* QW,
                                  long long q_words, const void* q_at,
                                  const void* t_len, const void* q_len,
                                  const void* order, void* next, int B,
                                  int W, int xdrop, int max_steps,
                                  int adaptive, int long_key, void* score,
                                  void* t_end, void* q_end, void* steps,
                                  void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const Args a{(const uint32_t*)TW, t_words, (const long long*)t_at,
               (const uint32_t*)QW, q_words, (const long long*)q_at,
               (const int*)t_len, (const int*)q_len, (const int*)order,
               (int*)next, B, W, xdrop, max_steps, (int*)score,
               (int*)t_end, (int*)q_end, (int*)steps};
  cudaStream_t s = (cudaStream_t)stream;
  if (long_key)
    return adaptive ? dispatch<true, true>(a, s, nullptr)
                    : dispatch<false, true>(a, s, nullptr);
  return adaptive ? dispatch<true, false>(a, s, nullptr)
                  : dispatch<false, false>(a, s, nullptr);
}

// Extensions in flight at band W on the current device (the persistent
// grid's extension groups: warps, or the grouped tile's thread groups)
// for the int32-key instantiation, or -1 when the occupancy query fails.
extern "C" int bella_xdrop_slots(int W, int adaptive) {
  const Args a{nullptr, 0, nullptr, nullptr, 0, nullptr, nullptr, nullptr,
               nullptr, nullptr, 0, W, 0, 0, nullptr, nullptr, nullptr,
               nullptr};
  int slots = -1;
  if (adaptive)
    dispatch<true, false>(a, nullptr, &slots);
  else
    dispatch<false, false>(a, nullptr, &slots);
  return slots;
}

// Extension prep (kernel K3): the four extension streams of every
// seed of a batch, built as packed words straight from the ragged word
// stream of the reads, one thread per output word.
//
// Off the main path: the x-drop kernel above reads the same words through
// each extension's descriptor (word_at computes what a thread of K3
// writes). K3 stays as the materialised form of the streams, which the
// card's tests and chip_smoke.py hold the descriptor-fed kernel to, and
// for the tools that time a batch's streams apart from its extension.
//
// Replaces the XLA prep that bella_tpu fuses into the Pallas aligner's
// program (bella_tpu/align/xdrop.py: _prepare_extensions_packed with
// _expand_words, _reverse_rows_w and _lshift_rows_w, inside
// _seed_extend_batch_pallas): the strand correction of each seed, then
// left = the reversed prefix up to the seed's end, right = the suffix
// after it, of H (reverse-complemented when the seed is) and of V.
//
// What bounds it on the H100: bytes. An output word costs two loads of
// input words (mostly from L1/L2: neighbouring threads share them), a
// funnel shift, at most a bit reversal, an xor and a mask, against 4
// bytes written; the batch's T and Q words, written once, and the words
// of the batch's distinct reads, read once, set the least time. The TPU
// path's barrel shifts (a log2(L/16)-step cascade of whole-row selects
// per stream) exist because gathers are slow there; here every thread
// computes its own word:
//   * row r of 4B selects the pair p = r mod B and the stream r / B (lt,
//     rt, lq, rq); every thread of the row derives the stream's read,
//     start, step (+1 or -1), complement flag and length n from the
//     (5, B) pair block and the read's length, as the plain version does
//     (seed_h = rc ? len_h - pos_h - k : pos_h);
//   * word j holds stream bases t = 16 j .. 16 j + 15. On a +1 stream they
//     are the 16 bases from a = 16 off_w[read] + start + 16 j:
//     __funnelshift_r(words[a >> 4], words[(a >> 4) + 1], 2 (a & 15)). On
//     a -1 stream, the same funnel over the 16 bases that end at
//     start - 16 j, then its sixteen 2-bit groups reversed (__brev, then
//     the bits of each group swapped back);
//   * complement: xor with 0xFFFFFFFF; bases t >= n are zeroed ('A'), and
//     a word wholly beyond n loads nothing;
//   * index arithmetic in int64; word indexes clamped at both ends of the
//     flat stream (a -1 stream of read 0 reaches below word 0, the last
//     read's tail past the end): those bases lie beyond n and are masked;
//   * the thread of word 0 of each row writes the stream's length (and
//     the seed ends, from rows lt and lq), so one launch gives every input
//     of the x-drop launch and of the batch's combine.
// The grid is (ceil(L/16 / 256), min(4B, 65535)) blocks of 256 threads;
// the second dimension strides over rows beyond 65,535.

namespace {

constexpr int kPrepThreads = 256;
constexpr long long kMaxGridY = 65535;

__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const uint32_t* __restrict__ words, long long n_words,
            const long long* __restrict__ off_w,
            const long long* __restrict__ lens, const int* __restrict__ blk,
            int B, int k, int Wp, uint32_t* __restrict__ T,
            uint32_t* __restrict__ Q, int* __restrict__ t_len,
            int* __restrict__ q_len, int* __restrict__ seed_end_h,
            int* __restrict__ seed_end_v) {
  const long long j = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
  for (long long r = blockIdx.y; r < 4LL * B; r += gridDim.y) {
    const int s = (int)(r / B);  // 0 lt, 1 rt, 2 lq, 3 rq
    const int p = (int)(r - (long long)s * B);
    const bool h_side = s < 2;
    const int rid = blk[(h_side ? 0 : 1) * B + p];
    const long long len = lens[rid];
    long long start, n;
    int step;
    bool comp = false;
    if (h_side) {
      const bool rc = blk[4 * B + p] != 0;
      const long long ph = blk[2 * B + p];
      const long long seh = (rc ? len - ph - k : ph) + k;  // seed end on H
      comp = rc;
      if (s == 0) {
        start = rc ? len - seh : seh - 1;
        step = rc ? 1 : -1;
        n = seh;
      } else {
        start = rc ? len - 1 - seh : seh;
        step = rc ? -1 : 1;
        n = len - seh;
      }
    } else {
      const long long sev = (long long)blk[3 * B + p] + k;  // seed end on V
      start = s == 2 ? sev - 1 : sev;
      step = s == 2 ? -1 : 1;
      n = s == 2 ? sev : len - sev;
    }
    const long long row = (long long)(s & 1) * B + p;  // row of T or Q
    if (j == 0) {
      (h_side ? t_len : q_len)[row] = (int)n;
      if (s == 0) seed_end_h[p] = (int)n;
      if (s == 2) seed_end_v[p] = (int)n;
    }
    if (j >= Wp) continue;
    const long long m = n - 16 * j;  // stream bases in this word
    uint32_t w = 0;
    if (m > 0) {
      const long long a = 16 * off_w[rid] +
                          (step > 0 ? start + 16 * j : start - 16 * j - 15);
      const long long i0 = a >> 4;
      const long long lo = i0 < 0 ? 0 : i0 >= n_words ? n_words - 1 : i0;
      const long long hi =
          i0 + 1 < 0 ? 0 : i0 + 1 >= n_words ? n_words - 1 : i0 + 1;
      w = __funnelshift_r(__ldg(words + lo), __ldg(words + hi),
                          2 * (int)(a & 15));
      if (step < 0) w = reverse_bases(w);
      if (comp) w = ~w;
      if (m < 16) w &= (1u << (2 * (int)m)) - 1u;
    }
    (h_side ? T : Q)[row * Wp + j] = w;
  }
}

}  // namespace

// Launches the prep kernel on `stream`. Pointers are device pointers:
// words (n_words,) uint32, the reads' ragged word stream; off_w and lens
// (R,) int64, each read's first word and length; blk (5, B) int32, rows
// read_h, read_v, pos_h, pos_v, seed_rc. Writes T = [lt; rt] and
// Q = [lq; rq], each (2B, Wp) uint32, t_len and q_len (2B,) int32, and
// seed_end_h, seed_end_v (B,) int32. Returns cudaGetLastError() after
// the launch.
extern "C" int bella_prep_launch(const void* words, long long n_words,
                                 const void* off_w, const void* lens,
                                 const void* blk, int B, int k, int Wp,
                                 void* T, void* Q, void* t_len, void* q_len,
                                 void* seed_end_h, void* seed_end_v,
                                 void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const long long rows = 4LL * B;
  const dim3 grid((unsigned)((Wp + kPrepThreads - 1) / kPrepThreads),
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  prep_kernel<<<grid, kPrepThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const long long*)off_w,
      (const long long*)lens, (const int*)blk, B, k, Wp, (uint32_t*)T,
      (uint32_t*)Q, (int*)t_len, (int*)q_len, (int*)seed_end_h,
      (int*)seed_end_v);
  return (int)cudaGetLastError();
}

// Ragged pack (pack_ragged_kernel): the reads' ragged word stream, built on
// the card from their codes, a byte a base, as the host's
// pack_words_ragged (bella_tpu_torch/align/xdrop.py) builds it: each read
// starts on a word boundary, 16 bases a word least significant first, and
// the bases past its length are 0 ('A'). Each group of four codes
// c0..c3 packs to (c0 | c1 << 2 | c2 << 4 | c3 << 6) & 0xFF, as the
// host's byte combines do, so the words are the same for any byte value.
//
// Replaces no TPU kernel: bella_tpu packs on the host too
// (bella_tpu/align/xdrop.py: pack_words_ragged). Added because the host
// pack (a Python loop over the reads and four strided numpy passes over
// the codes) kept the card idle for a third of a second a pass.
//
// What bounds it on the H100: bytes, the codes read once (a byte a base)
// and the words written once (a quarter of that). One thread an output
// word: it finds its read by a binary search over the word offsets
// (L1-resident: a warp's threads walk the same path), then loads the 16
// bytes from its read's source offset as five aligned 32-bit words (the
// staging buffer is padded so that the last never reads past it), funnel
// shifts them into four words of four codes, masks the bytes past the
// read's length and writes one 32-bit word. Neighbouring threads read
// neighbouring 16-byte runs and write neighbouring words; no shared
// memory.

namespace {

constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kPackThreads)
pack_ragged_kernel(const uint32_t* __restrict__ codes,
                   const long long* __restrict__ off_w,
                   const long long* __restrict__ src,
                   const long long* __restrict__ lens, int R,
                   long long n_words, uint32_t* __restrict__ words) {
  const long long w = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  if (w >= n_words) return;
  // the read whose words hold w: the last r with off_w[r] <= w (reads of
  // no bases own no word, so off_w repeats and the last one is taken)
  int lo = 0, hi = R - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(off_w + mid) <= w) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long j = w - __ldg(off_w + lo);
  const long long m = __ldg(lens + lo) - 16 * j;  // bases of this word, > 0
  const long long a = __ldg(src + lo) + 16 * j;   // byte of its first base
  const long long i = a >> 2;
  const int sh = 8 * (int)(a & 3);
  uint32_t v[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) v[q] = __ldg(codes + i + q);
  uint32_t out = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t x = __funnelshift_r(v[q], v[q + 1], sh);  // bases 4q .. 4q + 3
    const long long left = m - 4 * q;
    if (left < 4) x = left <= 0 ? 0u : x & ((1u << (8 * (int)left)) - 1u);
    const uint32_t b = (x & 0xFFu) | ((x >> 8 & 0xFFu) << 2) |
                       ((x >> 16 & 0xFFu) << 4) | ((x >> 24) << 6);
    out |= (b & 0xFFu) << (8 * q);
  }
  words[w] = out;
}

}  // namespace

// Launches the ragged pack on `stream`. Pointers are device pointers:
// codes, the reads' codes a byte a base, 4-byte aligned, with at least 20
// readable bytes past the last read's last base; meta (3, R + 1) int64,
// rows off_w (each read's first word, then n_words), src (each read's
// first code, then any) and lens (each read's length, then any). Writes
// words (n_words,) uint32. Returns cudaGetLastError() after the launch.
extern "C" int bella_pack_launch(const void* codes, const void* meta, int R,
                                 long long n_words, void* words,
                                 void* stream) {
  if (R <= 0 || n_words <= 0) return (int)cudaSuccess;
  const long long* m = (const long long*)meta;
  const long long blocks = (n_words + kPackThreads - 1) / kPackThreads;
  pack_ragged_kernel<<<(unsigned)blocks, kPackThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)codes, m, m + (R + 1), m + 2 * (R + 1), R, n_words,
      (uint32_t*)words);
  return (int)cudaGetLastError();
}
