// Banded gapped x-drop extension on Hopper (sm_90a): a warp per extension
// (a few warps at W > 512), the band in registers, a persistent grid that
// takes extensions longest first, each extension's bases read straight
// from a flat word stream through its descriptor.
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
// chain of steps. Each extension is a chain of dependent antidiagonals (up
// to t_len + q_len of them), each ending in a max reduction over the band,
// and a launch lasts about as long as its longest extension's chain: one
// step's latency (about 0.2 us at W = 128 on an H100, for an extension
// alone on its SM; chip_smoke.py prints it) times its step count,
// stretched while other warps share the scheduler's issue slots. A launch
// that holds a whole level takes every long chain of the level first and
// ends on its short ones, so the card idles only in the level's one tail.
// The reads' words (34 MB for a 137-Mbp corpus) stay in the 50 MB L2 and
// are read once per 16 steps of a thread's window. The design shortens
// the step and keeps the card's few long chains moving:
//   * a group of G = ceil(W / (32 * LPT)) warps runs one extension; each
//     thread holds LPT (4, 8 or 16) consecutive band lanes p = LPT * t + q
//     of antidiagonals d - 2 and d - 1 in registers, and writes d over
//     d - 2 in place (in the lane order that reads each predecessor before
//     it is overwritten). W = 128 / 256 / 512 take one warp (4 / 8 / 16
//     lanes a thread), 1024 and 2048 two and four. Lanes >= W hold NINF,
//     never win the max and read as out of band;
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
//     __reduce_max_sync (REDUX) of an int32 key, w * span + (span - 1 - p);
//     while it runs, the next antidiagonal's bases and the new row's
//     neighbouring lanes are prepared. With G > 1 warps, the warps' keys
//     and edge lanes go through shared memory behind one named barrier per
//     antidiagonal over that group's warps only;
//   * the key holds w only while lengths and xdrop stay below 2^17 (see
//     kKeyFloor). Longer extensions take the long-key instantiation
//     (LONGKEY): a REDUX max of w, then a REDUX min of the lane among the
//     lanes that hold it, which is exact while w = value + d fits int32
//     (lengths below 2^29);
//   * a persistent grid of two blocks per SM takes extensions from a
//     global counter over an order sorted by t_len + q_len, longest first,
//     so the long chains start first and share their schedulers with few
//     warps. Results go to the extension's own index.
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
// Blocks the persistent grid keeps on each SM (fewer if the occupancy is
// lower): 16 warps, 4 a scheduler. More warps share each scheduler's issue
// slots with a launch's longest extension, whose chain of steps sets the
// launch's end; fewer leave the issue slots idle. Measured on the demo
// corpus at 1, 2, 3 and the occupancy limit, 2 was fastest at every band.
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

// Extensions the persistent grid runs at once: blocks resident on the
// card times extension groups per block.
template <bool A, int LPT, int G, bool LK>
int slots_t(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, xdrop_kernel<A, LPT, G, LK>, kBlockThreads, 0);
  if (rc != cudaSuccess || per_sm <= 0) return -1;
  *blocks = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  return *blocks * (kBlockWarps / G);
}

template <bool A, int LPT, int G, bool LK>
int launch_t(const Args& a, cudaStream_t s) {
  int blocks = 0;
  if (slots_t<A, LPT, G, LK>(&blocks) < 0) {
    const cudaError_t rc = cudaGetLastError();
    return rc != cudaSuccess ? (int)rc : (int)cudaErrorInvalidConfiguration;
  }
  constexpr int groups = kBlockWarps / G;
  const long long need = ((long long)a.B + groups - 1) / groups;
  if (blocks > need) blocks = (int)need;
  xdrop_kernel<A, LPT, G, LK><<<blocks, kBlockThreads, 0, s>>>(
      a.TW, a.t_words, a.t_at, a.QW, a.q_words, a.q_at, a.t_len, a.q_len,
      a.order, a.next,
      a.B, a.W, a.xdrop, a.max_steps, a.score, a.t_end, a.q_end, a.steps);
  return (int)cudaGetLastError();
}

// The tile for band W: LPT lanes a thread (4, 8 or 16) and G warps an
// extension (1, 2, 4 or 8), chosen from W alone.
void tile(int W, int* lpt, int* g) {
  const int per = (W + 31) / 32;
  *lpt = per <= 4 ? 4 : per <= 8 ? 8 : 16;
  const int warps = (W + 32 * *lpt - 1) / (32 * *lpt);
  *g = warps <= 1 ? 1 : warps <= 2 ? 2 : warps <= 4 ? 4 : 8;
}

template <bool A, bool LK>
int dispatch(const Args& a, cudaStream_t s, int* slots) {
  int lpt = 0, g = 0, blocks = 0;
  tile(a.W, &lpt, &g);
  if (slots) {
    if (lpt == 4) return *slots = slots_t<A, 4, 1, LK>(&blocks);
    if (lpt == 8) return *slots = slots_t<A, 8, 1, LK>(&blocks);
    if (g == 1) return *slots = slots_t<A, 16, 1, LK>(&blocks);
    if (g == 2) return *slots = slots_t<A, 16, 2, LK>(&blocks);
    if (g == 4) return *slots = slots_t<A, 16, 4, LK>(&blocks);
    return *slots = slots_t<A, 16, 8, LK>(&blocks);
  }
  if (lpt == 4) return launch_t<A, 4, 1, LK>(a, s);
  if (lpt == 8) return launch_t<A, 8, 1, LK>(a, s);
  if (g == 1) return launch_t<A, 16, 1, LK>(a, s);
  if (g == 2) return launch_t<A, 16, 2, LK>(a, s);
  if (g == 4) return launch_t<A, 16, 4, LK>(a, s);
  return launch_t<A, 16, 8, LK>(a, s);
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
// grid's warp groups) for the int32-key instantiation, or -1 when the
// occupancy query fails.
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
