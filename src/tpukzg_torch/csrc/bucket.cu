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
#include "ec.cuh"

namespace {

constexpr int kT = 128;
constexpr int kW = 36;
constexpr int32_t kSentinel = 0x7FFFFFF0;

// Shared memory of every kernel here, word-major (word w of thread t at
// w * kT + t): two point buffers, ec_add's scratch, one key per thread,
// and a carried point with its key.
struct Smem {
  uint32_t* buf;      // buffer b at buf + b * kW * kT
  uint32_t* scratch;  // 24 words a thread
  int32_t* key;
  uint32_t* carry;    // kW words
  int32_t* carry_key;
  __device__ __forceinline__ explicit Smem(uint32_t* s)
      : buf(s),
        scratch(s + 2 * kW * kT),
        key((int32_t*)(s + (2 * kW + 24) * kT)),
        carry(s + (2 * kW + 25) * kT),
        carry_key((int32_t*)(s + (2 * kW + 25) * kT + kW)) {}
  __device__ __forceinline__ tk::Words point(int b, int t) const {
    return tk::Words{buf + b * kW * kT + t, kT};
  }
  __device__ __forceinline__ tk::Words work() const {
    return tk::Words{scratch + threadIdx.x, kT};
  }
};
constexpr int kSmemBytes = ((2 * kW + 25) * kT + kW + 1) * 4;

// Segmented inclusive Hillis-Steele over the kT points of buffer 0,
// keyed by sm.key; `live` marks this thread's element as real (dead
// ones sit after every live one).  Returns the buffer that holds the
// result.  Begins and ends with a barrier.
__device__ __forceinline__ int block_scan(const Smem& sm, bool live) {
  const int t = threadIdx.x;
  int cur = 0;
  __syncthreads();
#pragma unroll 1
  for (int d = 1; d < kT; d <<= 1) {
    const bool hit = live && t >= d && sm.key[t - d] == sm.key[t];
    if (!__syncthreads_or(hit)) break;
    const tk::Words src = sm.point(cur, t), dst = sm.point(cur ^ 1, t);
    if (hit)
      tk::ec_add(dst, src, sm.point(cur, t - d), sm.work());
    else
      dst.copy_from(src);
    cur ^= 1;
  }
  __syncthreads();
  return cur;
}

// Coordinates are limb-major (24, g, n) int32 16-bit limbs; keys (g, n).
// agg: (36, g * nch) words, the chunk totals; agg_key: (g * nch) their
// last keys.
__global__ void __launch_bounds__(kT, 4)
scan_local(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
           int32_t* __restrict__ oz, const int32_t* __restrict__ x,
           const int32_t* __restrict__ y, const int32_t* __restrict__ z,
           const int32_t* __restrict__ keys, uint32_t* __restrict__ agg,
           int32_t* __restrict__ agg_key, long long g, long long n, int runs,
           long long nch) {
  extern __shared__ uint32_t smem[];
  const Smem sm(smem);
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
      tk::load_point(lane, x + off, y + off, z + off, ls);
      tk::ec_add(acc, acc, lane, sm.work());
    } else {
      tk::load_point(acc, x + off, y + off, z + off, ls);
    }
    tk::Limbs{ox + off, oy + off, oz + off, ls}.store(acc);
    prev = k;
  }
  if (l0 == l1) acc.set_inf();
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
      const tk::Limbs out{ox + off, oy + off, oz + off, ls};
      if (l == l1 - 1) {
        out.store(mine);
      } else {
        tk::load_point(tmp, ox + off, oy + off, oz + off, ls);
        tk::ec_add(out, pre, tmp, sm.work());
      }
    }
  }

  // 4. the chunk's total: the scanned total of its last run
  const int tl = (len - 1) / runs;
  if (t < kW) agg[t * m + b] = sm.buf[cur * kW * kT + t * kT + tl];
  if (t == 0) agg_key[b] = sm.key[tl];
}

// One block per row: agg[:, row * nch + c] <- the segmented inclusive
// scan of the row's chunk totals keyed by agg_key.
__global__ void __launch_bounds__(kT)
scan_carry(uint32_t* __restrict__ agg, const int32_t* __restrict__ agg_key,
           long long g, long long nch) {
  extern __shared__ uint32_t smem[];
  const Smem sm(smem);
  const int t = threadIdx.x;
  const long long m = g * nch;
  const tk::Words cw{sm.carry, 1};
  if (t == 0) {
    cw.set_inf();
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
      if (sm.key[t] == *sm.carry_key) tk::ec_add(s, cw, s, sm.work());
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

// grid = g x (nch - 1): chunk c >= 1 of each row.
__global__ void __launch_bounds__(kT, 4)
scan_fixup(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
           int32_t* __restrict__ oz, const int32_t* __restrict__ keys,
           const uint32_t* __restrict__ agg,
           const int32_t* __restrict__ agg_key, long long g, long long n,
           int runs, long long nch) {
  extern __shared__ uint32_t smem[];
  const Smem sm(smem);
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
    tk::load_point(tmp, ox + off, oy + off, oz + off, ls);
    tk::ec_add(tk::Limbs{ox + off, oy + off, oz + off, ls}, cw, tmp,
               sm.work());
  }
}

}  // namespace

// Device kernels run: 1 when every row is one chunk, else 3.  blocks
// (host memory, 3 ints) receives the grid of scan_local, scan_carry and
// scan_fixup as launched, 0 for a kernel not launched.
extern "C" int tpukzg_seg_scan(void* ox, void* oy, void* oz, const void* x,
                               const void* y, const void* z, const void* keys,
                               void* agg, void* agg_key, long long g,
                               long long n, int runs, int* blocks,
                               void* stream) {
  blocks[0] = blocks[1] = blocks[2] = 0;
  const void* kernels[] = {(const void*)scan_local, (const void*)scan_carry,
                           (const void*)scan_fixup};
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const long long nch = (n + (long long)kT * runs - 1) / ((long long)kT * runs);
  blocks[0] = (int)(g * nch);
  scan_local<<<(unsigned)(g * nch), kT, kSmemBytes, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)x,
      (const int32_t*)y, (const int32_t*)z, (const int32_t*)keys,
      (uint32_t*)agg, (int32_t*)agg_key, g, n, runs, nch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nch == 1) return (int)err;
  blocks[1] = (int)g;
  scan_carry<<<(unsigned)g, kT, kSmemBytes, st>>>(
      (uint32_t*)agg, (const int32_t*)agg_key, g, nch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blocks[2] = (int)(g * (nch - 1));
  scan_fixup<<<(unsigned)(g * (nch - 1)), kT, kSmemBytes, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)keys,
      (const uint32_t*)agg, (const int32_t*)agg_key, g, n, runs, nch);
  return (int)cudaGetLastError();
}
