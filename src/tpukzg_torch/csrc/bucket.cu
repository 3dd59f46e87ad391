// B3: inclusive segmented EC-sum scan over sorted bucket keys.
//
// Replaces tpukzg/pallas/bucket.py::_scan_kernel.  On the TPU the grid
// ran (row, tile) steps in order on one core and carried the trailing
// segment's sum from one tile to the next.  Hopper blocks run in no
// order, so a row is cut into chunks of C = 128 R lanes, one block each,
// and a scan over the chunks' totals joins them:
//   1. scan_local, grid = rows x chunks, 128 threads.  Thread t owns a
//      run of R consecutive lanes and scans it in order (an add only
//      where a lane's key equals its left neighbour's).  The block then
//      scans its 128 run totals (each run's trailing-segment sum),
//      segmented by each run's last key: Hillis-Steele in shared
//      memory, stopped as soon as no run's key equals the key at the
//      distance (keys are sorted, so none will at larger distances).
//      Each run adds the total of the runs before it into the lanes of
//      its leading segment; the block writes its chunk's total (the sum
//      of its trailing segment) and last key.
//   2. scan_carry (rows of several chunks), one block per row: the same
//      segmented scan over the row's chunk totals, keyed by last key,
//      128 chunks at a time with the carry between them in shared
//      memory.  A chunk whose lanes all share a key passes the carry
//      on, so a segment may span any number of chunks.
//   3. scan_fixup, grid = rows x (chunks - 1): chunk c adds the scanned
//      total of chunk c - 1 into the lanes of its leading segment when
//      chunk c - 1 ends with the key chunk c begins with; otherwise it
//      does nothing.
// No atomics: the order of the additions depends on R alone, so two
// launches give the same limbs.  A scan does about two adds a lane (the
// run's scan and its leading segment's fix-up) plus the run-level scan,
// where Hillis-Steele did log2(tile) passes over every lane.
//
// What bounds it on the H100: integer multiplies (12 Fp products an
// add; about 3,600 word products).  Points live in shared memory, 36
// words each, word-major (word w of thread t at w * 128 + t, so a warp
// hits 32 banks); ec_add (ec.cuh) reads them there and keeps only its
// temporaries in registers.  ptxas fits scan_local and scan_fixup in
// 128 registers with no spill, so __launch_bounds__(128, 4) puts 4
// blocks (16 warps, 4 x 49 KB of shared memory) on an SM; scan_carry,
// a few blocks in all, spilled under that cap and is left without it.
// The wrapper (kernels/bucket.py) picks R in {8, 4, 2, 1}, the largest
// that still gives two waves of 4 blocks an SM: the fixed-base rows
// (3 x 98,304 lanes) take R = 2 (1,152 blocks), the verify rows
// (64 x 513 and 64 x 255) R = 1 (320 and 128 blocks), where the depth
// of the add chains and not the count of adds sets the time.
//
// Lanes are not padded: a run or chunk stops at the row's length.
// Offsets into the (24, g, n) coordinates are 64-bit.
//
// G2: every kernel here is a template on the curve (ec.cuh's traits G1,
// G2) under its own name: scan_local, ..., window_sum_join for G1, as
// they were, and scan_local_g2, ..., window_sum_join_g2 for G2, whose
// coordinates are (48, g, n) (c0's 24 limbs, then c1's).  A G2 point is
// 72 words and its add's temporaries 156 more, all in shared memory, so
// a G2 block takes 154 KB (the scans) or 190 KB (the window sum) and an
// SM holds one; its add is about 3.2 G1 adds of products.  In the G2
// window sum, thread k of the block doubles U_k (ec_double_g2, one
// thread a point) where G1 runs quad k of warp 0.
#include "ec.cuh"

namespace {

constexpr int kT = 128;
constexpr int32_t kSentinel = 0x7FFFFFF0;

// Shared memory of every scan kernel here, word-major (word w of thread
// t at w * kT + t): two point buffers of C::kW words a thread, the add's
// scratch, one key per thread, and a carried point with its key.
template <class C>
struct Smem {
  static constexpr int kW = C::kW;
  uint32_t* buf;      // buffer b at buf + b * kW * kT
  uint32_t* scratch;  // C::kScratch words a thread
  int32_t* key;
  uint32_t* carry;    // kW words
  int32_t* carry_key;
  __device__ __forceinline__ explicit Smem(uint32_t* s)
      : buf(s),
        scratch(s + 2 * kW * kT),
        key((int32_t*)(s + (2 * kW + C::kScratch) * kT)),
        carry(s + (2 * kW + C::kScratch + 1) * kT),
        carry_key((int32_t*)(s + (2 * kW + C::kScratch + 1) * kT + kW)) {}
  __device__ __forceinline__ tk::Words point(int b, int t) const {
    return tk::Words{buf + b * kW * kT + t, kT};
  }
  __device__ __forceinline__ tk::Words work() const {
    return tk::Words{scratch + threadIdx.x, kT};
  }
};
template <class C>
constexpr int smem_bytes() {
  return ((2 * C::kW + C::kScratch + 1) * kT + C::kW + 1) * 4;
}

// Segmented inclusive Hillis-Steele over the kT points of buffer 0,
// keyed by sm.key; `live` marks this thread's element as real (dead
// ones sit after every live one).  Returns the buffer that holds the
// result.  Begins and ends with a barrier.
template <class C>
__device__ __forceinline__ int block_scan(const Smem<C>& sm, bool live) {
  const int t = threadIdx.x;
  int cur = 0;
  __syncthreads();
#pragma unroll 1
  for (int d = 1; d < kT; d <<= 1) {
    const bool hit = live && t >= d && sm.key[t - d] == sm.key[t];
    if (!__syncthreads_or(hit)) break;
    const tk::Words src = sm.point(cur, t), dst = sm.point(cur ^ 1, t);
    if (hit)
      C::add(dst, src, sm.point(cur, t - d), sm.work());
    else
      C::copy(dst, src);
    cur ^= 1;
  }
  __syncthreads();
  return cur;
}

// Coordinates are limb-major (24, g, n) int32 16-bit limbs (G2: 48);
// keys (g, n).  agg: (C::kW, g * nch) words, the chunk totals; agg_key:
// (g * nch) their last keys.
#define SCAN_LOCAL_ARGS                                                     \
  int32_t *__restrict__ ox, int32_t *__restrict__ oy,                       \
      int32_t *__restrict__ oz, const int32_t *__restrict__ x,              \
      const int32_t *__restrict__ y, const int32_t *__restrict__ z,         \
      const int32_t *__restrict__ keys, uint32_t *__restrict__ agg,         \
      int32_t *__restrict__ agg_key, long long g, long long n, int runs,    \
      long long nch
#define SCAN_LOCAL_PASS ox, oy, oz, x, y, z, keys, agg, agg_key, g, n, runs, nch

template <class C>
__device__ __forceinline__ void scan_local_body(SCAN_LOCAL_ARGS) {
  using Out = typename C::Out;
  constexpr int kW = C::kW;
  extern __shared__ uint32_t smem[];
  const Smem<C> sm(smem);
  const int t = threadIdx.x;
  const long long b = blockIdx.x, m = g * nch;
  const long long c0 = (b % nch) * kT * runs;
  const long long base = (b / nch) * n + c0;
  const long long ls = g * n;
  const int len = (int)min((long long)kT * runs, n - c0);
  const int l0 = min(t * runs, len), l1 = min(l0 + runs, len);
  const tk::Words acc = sm.point(0, t), lane = sm.point(1, t);

  // 1. this thread's run, in order
  int32_t first = kSentinel, prev = kSentinel;
#pragma unroll 1
  for (int l = l0; l < l1; ++l) {
    const long long off = base + l;
    const int32_t k = keys[off];
    if (l == l0) first = k;
    if (k == prev) {
      C::load(lane, x + off, y + off, z + off, ls);
      C::add(acc, acc, lane, sm.work());
    } else {
      C::load(acc, x + off, y + off, z + off, ls);
    }
    Out{ox + off, oy + off, oz + off, ls}.store(acc);
    prev = k;
  }
  if (l0 == l1) C::set_inf(acc);
  sm.key[t] = prev;

  // 2. the block's run totals, segmented by last key
  const int cur = block_scan(sm, l0 < l1);

  // 3. the lanes of this run's leading segment take the totals of the
  // runs before it (the run's last lane is its scanned total)
  if (t > 0 && l0 < l1 && sm.key[t - 1] == first) {
    const tk::Words pre = sm.point(cur, t - 1), mine = sm.point(cur, t);
    const tk::Words tmp = sm.point(cur ^ 1, t);
#pragma unroll 1
    for (int l = l0; l < l1 && keys[base + l] == first; ++l) {
      const long long off = base + l;
      const Out out{ox + off, oy + off, oz + off, ls};
      if (l == l1 - 1) {
        out.store(mine);
      } else {
        C::load(tmp, ox + off, oy + off, oz + off, ls);
        C::add(out, pre, tmp, sm.work());
      }
    }
  }

  // 4. the chunk's total: the scanned total of its last run
  const int tl = (len - 1) / runs;
  if (t < kW) agg[t * m + b] = sm.buf[cur * kW * kT + t * kT + tl];
  if (t == 0) agg_key[b] = sm.key[tl];
}

__global__ void __launch_bounds__(kT, 4) scan_local(SCAN_LOCAL_ARGS) {
  scan_local_body<tk::G1>(SCAN_LOCAL_PASS);
}

__global__ void __launch_bounds__(kT, 1) scan_local_g2(SCAN_LOCAL_ARGS) {
  scan_local_body<tk::G2>(SCAN_LOCAL_PASS);
}

// One block per row: agg[:, row * nch + c] <- the segmented inclusive
// scan of the row's chunk totals keyed by agg_key.
template <class C>
__device__ __forceinline__ void scan_carry_body(
    uint32_t* __restrict__ agg, const int32_t* __restrict__ agg_key,
    long long g, long long nch) {
  constexpr int kW = C::kW;
  extern __shared__ uint32_t smem[];
  const Smem<C> sm(smem);
  const int t = threadIdx.x;
  const long long m = g * nch;
  const tk::Words cw{sm.carry, 1};
  if (t == 0) {
    C::set_inf(cw);
    *sm.carry_key = kSentinel;
  }
#pragma unroll 1
  for (long long c0 = 0; c0 < nch; c0 += kT) {
    const int len = (int)min((long long)kT, nch - c0);
    const long long i = blockIdx.x * nch + c0 + t;
    if (t < len) {
#pragma unroll 4
      for (int w = 0; w < kW; ++w) sm.buf[w * kT + t] = agg[w * m + i];
      sm.key[t] = agg_key[i];
    } else {
      sm.key[t] = kSentinel;
    }
    const int cur = block_scan(sm, t < len);
    const tk::Words s = sm.point(cur, t);
    if (t < len) {
      if (sm.key[t] == *sm.carry_key) C::add(s, cw, s, sm.work());
#pragma unroll 4
      for (int w = 0; w < kW; ++w)
        agg[w * m + i] = sm.buf[cur * kW * kT + w * kT + t];
    }
    __syncthreads();
    if (t < kW) sm.carry[t] = sm.buf[cur * kW * kT + t * kT + len - 1];
    if (t == 0) *sm.carry_key = sm.key[len - 1];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kT)
scan_carry(uint32_t* __restrict__ agg, const int32_t* __restrict__ agg_key,
           long long g, long long nch) {
  scan_carry_body<tk::G1>(agg, agg_key, g, nch);
}

__global__ void __launch_bounds__(kT)
scan_carry_g2(uint32_t* __restrict__ agg,
              const int32_t* __restrict__ agg_key, long long g,
              long long nch) {
  scan_carry_body<tk::G2>(agg, agg_key, g, nch);
}

// grid = g x (nch - 1): chunk c >= 1 of each row.
#define SCAN_FIXUP_ARGS                                                     \
  int32_t *__restrict__ ox, int32_t *__restrict__ oy,                       \
      int32_t *__restrict__ oz, const int32_t *__restrict__ keys,           \
      const uint32_t *__restrict__ agg,                                     \
      const int32_t *__restrict__ agg_key, long long g, long long n,        \
      int runs, long long nch
#define SCAN_FIXUP_PASS ox, oy, oz, keys, agg, agg_key, g, n, runs, nch

template <class C>
__device__ __forceinline__ void scan_fixup_body(SCAN_FIXUP_ARGS) {
  constexpr int kW = C::kW;
  extern __shared__ uint32_t smem[];
  const Smem<C> sm(smem);
  const int t = threadIdx.x;
  const long long row = blockIdx.x / (nch - 1);
  const long long c = blockIdx.x % (nch - 1) + 1;
  const long long prev = row * nch + c - 1, m = g * nch;
  const long long c0 = c * kT * runs;
  const long long base = row * n + c0;
  const long long ls = g * n;
  const int32_t first = keys[base];
  if (agg_key[prev] != first) return;
  if (t < kW) sm.carry[t] = agg[t * m + prev];
  __syncthreads();
  const int len = (int)min((long long)kT * runs, n - c0);
  const int l0 = min(t * runs, len), l1 = min(l0 + runs, len);
  const tk::Words cw{sm.carry, 1}, tmp = sm.point(0, t);
#pragma unroll 1
  for (int l = l0; l < l1 && keys[base + l] == first; ++l) {
    const long long off = base + l;
    C::load(tmp, ox + off, oy + off, oz + off, ls);
    C::add(typename C::Out{ox + off, oy + off, oz + off, ls}, cw, tmp,
           sm.work());
  }
}

__global__ void __launch_bounds__(kT, 4) scan_fixup(SCAN_FIXUP_ARGS) {
  scan_fixup_body<tk::G1>(SCAN_FIXUP_PASS);
}

__global__ void __launch_bounds__(kT, 1) scan_fixup_g2(SCAN_FIXUP_ARGS) {
  scan_fixup_body<tk::G2>(SCAN_FIXUP_PASS);
}

// ---------------------------------------------------------------------
// The window sum: A = sum_{b=1}^{B-1} b S_b over each row of bucket totals
// S_1..S_{B-1} (lane i holds S_{i+1}).
//
// Replaces tpukzg/pallas/bucket.py::suffix_scan_pallas followed by the
// tree sum over its lanes in msm/pippenger_lm.py: a flip, a scan of the
// whole row as one segment (every lane adds at every level), a flip, and
// log2(B) levels of adds, one launch each.  What bounds it: integer
// products, 2 adds a bucket (B - 1 running sums, B - 1 weighted ones),
// and, at the MSM's two rows of 65,535 buckets, the depth of the chains
// of adds: one ec_add in one thread takes about 12 products in a row.
// So the work is two running sums, and the weights come from doublings
// of a few points, not from adds over every bucket:
//   1. window_sum, grid = rows x blocks, 128 threads.  Thread t owns
//      s = 2^lg consecutive buckets of its row (the last may have fewer)
//      and walks them from the top: R += S_b; A += R.  It ends with the
//      segment's total T_t and A_t, the segment's sum weighted 1..s.
//      A range of buckets is then the pair (T, A); two adjacent ranges
//      join as T = T_L + T_R, A = A_L + A_R + [len L] T_R, so the block's
//      pair is T = sum T_t, A = sum A_t + [s] sum_t t T_t, and
//      sum_t t T_t = sum_k [2^k] U_k with U_k the sum of the T_t whose
//      index has bit k.  block_join forms every U_k in the same tree as
//      the two plain sums, in place (U_k of a node is the P slot of its
//      thread 2^k), one add a thread a level and no doubling; then quad
//      k of warp 0 doubles U_k lg + k times (ec_double_quad: four
//      threads a point, two products deep a doubling), and three levels
//      of adds sum A.  The block writes its (T, A) to device memory.
//   2. window_sum_join, one block a row: the same block_join over the
//      row's block pairs (one a thread; the launcher keeps them at most
//      128), each a range of 128 s buckets -> the row's A.
// No atomics: the order of the additions depends on s alone, so two
// launches give the same limbs, and kernels/bucket.py's
// window_sum_chunked repeats it add for add.  The wrapper picks s from
// the rows, the buckets and the card's SMs (window_segment_for): the
// MSM's two rows of 65,535 take s = 4, a chain of 26 adds and 23 quad
// doublings, 0.93 ms on an H100 against 2.85 ms for the route replaced.
// Shared memory: three point buffers (P, Q, a loaded bucket) and
// ec_add's scratch, 66 KB a block, so __launch_bounds__(128, 3).
template <class C>
constexpr int ws_smem_bytes() {
  return (3 * C::kW + C::kScratch) * kT * 4;
}

template <class C>
struct WsSmem {
  static constexpr int kW = C::kW;
  uint32_t* s;
  __device__ __forceinline__ tk::Words p(int t) const {
    return tk::Words{s + t, kT};
  }
  __device__ __forceinline__ tk::Words q(int t) const {
    return tk::Words{s + kW * kT + t, kT};
  }
  __device__ __forceinline__ tk::Words lane(int t) const {
    return tk::Words{s + 2 * kW * kT + t, kT};
  }
  __device__ __forceinline__ tk::Words work() const {
    return tk::Words{s + 3 * kW * kT + threadIdx.x, kT};
  }
  // the terms of the last sum: Q slot 0, then D_k in P slot 2^k
  __device__ __forceinline__ tk::Words term(int i) const {
    return i == 0 ? q(0) : p(1 << (i - 1));
  }
};

// The block's items t < 2^levels (P slot t: T_t; Q slot t: A_t), item t
// the range of 2^lg buckets from t 2^lg -> P slot 0: sum T_t; Q slot 0:
// sum A_t + [2^lg] sum_t t T_t.  Every thread of the block calls it.
template <class C>
__device__ __forceinline__ void block_join(const WsSmem<C>& sm, int levels,
                                           int lg) {
  const int x = threadIdx.x;
  // 1. level j joins nodes of 2^j items: Q and P of the left node take
  // the right node's, U_k (k < j, P slot 2^k of a node) likewise, and the
  // right node's P stays where it is as the new node's U_j
#pragma unroll 1
  for (int j = 0; j < levels; ++j) {
    __syncthreads();
    const int per = j + 2;
    if (x < (1 << (levels - j - 1)) * per) {
      // one ec_add on both branches: a warp never splits into two adds
      const int a = x % per, o = a < 2 ? 0 : 1 << (a - 2);
      const int t0 = (x / per) << (j + 1), t1 = t0 + (1 << j);
      const tk::Words d = a == 0 ? sm.q(t0) : sm.p(t0 + o);
      C::add(d, d, a == 0 ? sm.q(t1) : sm.p(t1 + o), sm.work());
    }
  }
  __syncthreads();
  // 2. D_k = [2^(lg + k)] U_k in place, quad k of warp 0; the quads past
  // the last U double P slot 0 and keep nothing (G2: thread k, alone)
  const int most = lg + levels - 1;
  if constexpr (!C::kQuad) {
    if (x < levels) {
      const tk::Words u = sm.p(1 << x);
#pragma unroll 1
      for (int i = 0; i < lg + x; ++i) C::dbl(u, sm.work());
    }
  } else if (levels > 0 && most > 0 && x < 32) {
    const int k = x >> 2, r = x & 3;
    const tk::Words u = sm.p(k < levels ? 1 << k : 0);
    uint32_t X[12], Y[12], Z[12];
    u.get(0, X);
    u.get(1, Y);
    u.get(2, Z);
#pragma unroll 1
    for (int i = 1; i <= most; ++i) {
      tk::ec_double_quad(X, Y, Z, r);
      if (k < levels && i == lg + k && r == 0) {
        u.put(0, X);
        u.put(1, Y);
        u.put(2, Z);
      }
    }
  }
  __syncthreads();
  // 3. A = Q_0 + sum_k D_k, a tree over the levels + 1 terms
#pragma unroll 1
  for (int h = 1; h <= levels; h <<= 1) {
    const int i = 2 * h * x;
    if (i + h <= levels)
      C::add(sm.term(i), sm.term(i), sm.term(i + h), sm.work());
    __syncthreads();
  }
}

// Bucket coordinates (24, g, nb) limb-major int32 16-bit limbs (G2: 48);
// agg: (2 C::kW, g * nblk) words, the blocks' T (words 0..kW - 1) and A.
#define WINDOW_SUM_ARGS                                                     \
  const int32_t *__restrict__ x, const int32_t *__restrict__ y,             \
      const int32_t *__restrict__ z, uint32_t *__restrict__ agg,            \
      long long g, long long nb, int lg, long long nblk, int levels
#define WINDOW_SUM_PASS x, y, z, agg, g, nb, lg, nblk, levels

template <class C>
__device__ __forceinline__ void window_sum_body(WINDOW_SUM_ARGS) {
  constexpr int kW = C::kW;
  extern __shared__ uint32_t smem[];
  const WsSmem<C> sm{smem};
  const int t = threadIdx.x;
  const long long row = blockIdx.x / nblk;
  const long long lo = ((blockIdx.x % nblk) * kT + t) << lg;
  const long long hi = min(lo + (1LL << lg), nb), ls = g * nb;
  const tk::Words R = sm.p(t), A = sm.q(t), S = sm.lane(t);
  if (lo < hi) {
    const long long top = row * nb + hi - 1;
    C::load(R, x + top, y + top, z + top, ls);
    C::copy(A, R);
#pragma unroll 1
    for (long long off = top - 1; off >= row * nb + lo; --off) {
      C::load(S, x + off, y + off, z + off, ls);
      C::add(R, R, S, sm.work());
      C::add(A, A, R, sm.work());
    }
  } else {
    C::set_inf(R);
    C::set_inf(A);
  }
  block_join(sm, levels, lg);
  const long long m = g * nblk;
  if (t < kW) {
    agg[t * m + blockIdx.x] = smem[t * kT];
    agg[(kW + t) * m + blockIdx.x] = smem[(kW + t) * kT];
  }
}

__global__ void __launch_bounds__(kT, 3) window_sum(WINDOW_SUM_ARGS) {
  window_sum_body<tk::G1>(WINDOW_SUM_PASS);
}

__global__ void __launch_bounds__(kT, 1) window_sum_g2(WINDOW_SUM_ARGS) {
  window_sum_body<tk::G2>(WINDOW_SUM_PASS);
}

// One block a row: its nblk <= 128 block pairs, each a range of 2^lg
// buckets, -> the row's A in (24, g) limbs (G2: 48).
#define WINDOW_JOIN_ARGS                                                    \
  int32_t *__restrict__ ox, int32_t *__restrict__ oy,                       \
      int32_t *__restrict__ oz, const uint32_t *__restrict__ agg,           \
      long long g, long long nblk, int lg, int levels
#define WINDOW_JOIN_PASS ox, oy, oz, agg, g, nblk, lg, levels

template <class C>
__device__ __forceinline__ void window_sum_join_body(WINDOW_JOIN_ARGS) {
  constexpr int kW = C::kW;
  extern __shared__ uint32_t smem[];
  const WsSmem<C> sm{smem};
  const int t = threadIdx.x;
  const long long m = g * nblk;
  if (t < nblk) {
    const long long i = blockIdx.x * nblk + t;
#pragma unroll 4
    for (int w = 0; w < kW; ++w) {
      smem[w * kT + t] = agg[w * m + i];
      smem[(kW + w) * kT + t] = agg[(kW + w) * m + i];
    }
  } else {
    C::set_inf(sm.p(t));
    C::set_inf(sm.q(t));
  }
  block_join(sm, levels, lg);
  if (t == 0)
    typename C::Out{ox + blockIdx.x, oy + blockIdx.x, oz + blockIdx.x, g}
        .store(sm.q(0));
}

__global__ void __launch_bounds__(kT, 3)
window_sum_join(WINDOW_JOIN_ARGS) {
  window_sum_join_body<tk::G1>(WINDOW_JOIN_PASS);
}

__global__ void __launch_bounds__(kT, 1)
window_sum_join_g2(WINDOW_JOIN_ARGS) {
  window_sum_join_body<tk::G2>(WINDOW_JOIN_PASS);
}

int ceil_log2(long long n) {
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

// The window sums of g rows of nb bucket totals on curve C by the
// kernels `sum` and `join`: two launches (the entry points below).
template <class C, class Sum, class Join>
int window_sum_launch(Sum sum, Join join, void* ox, void* oy, void* oz,
                      const void* x, const void* y, const void* z, void* agg,
                      long long g, long long nb, int lg, int* blocks,
                      void* stream) {
  blocks[0] = blocks[1] = 0;
  const long long segs = (nb + (1LL << lg) - 1) >> lg;
  const long long nblk = (segs + kT - 1) / kT;
  if (g < 1 || nb < 1 || lg < 0 || nblk > kT)
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = ws_smem_bytes<C>();
  const void* kernels[] = {(const void*)sum, (const void*)join};
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  blocks[0] = (int)(g * nblk);
  sum<<<(unsigned)(g * nblk), kT, bytes, st>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
      (uint32_t*)agg, g, nb, lg, nblk,
      ceil_log2(segs < kT ? segs : kT));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blocks[1] = (int)g;
  join<<<(unsigned)g, kT, bytes, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const uint32_t*)agg, g,
      nblk, lg + 7, ceil_log2(nblk));
  return (int)cudaGetLastError();
}

// The bucket scan on curve C by the kernels `local`, `carry` and `fixup`
// (the entry points below).
template <class C, class Local, class Carry, class Fixup>
int seg_scan_launch(Local local, Carry carry, Fixup fixup, void* ox,
                    void* oy, void* oz, const void* x, const void* y,
                    const void* z, const void* keys, void* agg,
                    void* agg_key, long long g, long long n, int runs,
                    int* blocks, void* stream) {
  blocks[0] = blocks[1] = blocks[2] = 0;
  constexpr int bytes = smem_bytes<C>();
  const void* kernels[] = {(const void*)local, (const void*)carry,
                           (const void*)fixup};
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const long long nch = (n + (long long)kT * runs - 1) / ((long long)kT * runs);
  blocks[0] = (int)(g * nch);
  local<<<(unsigned)(g * nch), kT, bytes, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)x,
      (const int32_t*)y, (const int32_t*)z, (const int32_t*)keys,
      (uint32_t*)agg, (int32_t*)agg_key, g, n, runs, nch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nch == 1) return (int)err;
  blocks[1] = (int)g;
  carry<<<(unsigned)g, kT, bytes, st>>>(
      (uint32_t*)agg, (const int32_t*)agg_key, g, nch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blocks[2] = (int)(g * (nch - 1));
  fixup<<<(unsigned)(g * (nch - 1)), kT, bytes, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)keys,
      (const uint32_t*)agg, (const int32_t*)agg_key, g, n, runs, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// The window sums of g rows of nb bucket totals, thread segments of 2^lg
// buckets: two launches.  agg: (72, g * nblk) words of scratch (G2: 144),
// nblk = ceil(ceil(nb / 2^lg) / 128), which must be at most 128.  blocks
// (host memory, 2 ints) receives the grids of window_sum and
// window_sum_join.
extern "C" int tpukzg_window_sum(void* ox, void* oy, void* oz, const void* x,
                                 const void* y, const void* z, void* agg,
                                 long long g, long long nb, int lg,
                                 int* blocks, void* stream) {
  return window_sum_launch<tk::G1>(window_sum, window_sum_join, ox, oy, oz,
                                   x, y, z, agg, g, nb, lg, blocks, stream);
}

extern "C" int tpukzg_window_sum_g2(void* ox, void* oy, void* oz,
                                    const void* x, const void* y,
                                    const void* z, void* agg, long long g,
                                    long long nb, int lg, int* blocks,
                                    void* stream) {
  return window_sum_launch<tk::G2>(window_sum_g2, window_sum_join_g2, ox, oy,
                                   oz, x, y, z, agg, g, nb, lg, blocks,
                                   stream);
}

// Device kernels run: 1 when every row is one chunk, else 3.  blocks
// (host memory, 3 ints) receives the grid of scan_local, scan_carry and
// scan_fixup as launched, 0 for a kernel not launched.  agg: (36, m)
// words of chunk totals (G2: 72), agg_key (m), m = g * chunks a row.
extern "C" int tpukzg_seg_scan(void* ox, void* oy, void* oz, const void* x,
                               const void* y, const void* z, const void* keys,
                               void* agg, void* agg_key, long long g,
                               long long n, int runs, int* blocks,
                               void* stream) {
  return seg_scan_launch<tk::G1>(scan_local, scan_carry, scan_fixup, ox, oy,
                                 oz, x, y, z, keys, agg, agg_key, g, n, runs,
                                 blocks, stream);
}

extern "C" int tpukzg_seg_scan_g2(void* ox, void* oy, void* oz,
                                  const void* x, const void* y,
                                  const void* z, const void* keys, void* agg,
                                  void* agg_key, long long g, long long n,
                                  int runs, int* blocks, void* stream) {
  return seg_scan_launch<tk::G2>(scan_local_g2, scan_carry_g2, scan_fixup_g2,
                                 ox, oy, oz, x, y, z, keys, agg, agg_key, g,
                                 n, runs, blocks, stream);
}
