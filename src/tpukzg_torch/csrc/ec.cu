// B2 launcher: elementwise complete G1 addition, one thread per point;
// B6 launchers: a run of complete G1 doublings, one thread per point or
// four (at the end of this file).
//
// A thin launcher around the device function ec_add of ec.cuh (which
// replaces tpukzg/pallas/ec.py::ec_add inside the bucket-scan kernel),
// so every lane of the formula can be checked alone and so the curve
// code's batched adds take one launch.  ~3,600 word products
// (7,200 multiply-adds) per point against 864 bytes moved, just under the
// card's ~10 multiply-adds a byte, so the bytes bound it on paper; in
// practice the multiply chains do, and registers set how many warps hide
// their latency.  Each thread stages its two points in shared memory
// (2 x 144 bytes, and ec_add's 96 bytes of scratch), where ec_add reads
// them, and keeps only the formula's temporaries in registers: 128
// threads a block, at most 128 registers a thread, so 4 blocks
// (16 warps, 4 x 48 KB of shared memory) fit on an SM.  Layout as
// in montmul.cu: element i, limb j at i * es + j * ls.
//
// Neither kernel asks for more than the 48 KB of dynamic shared memory a
// block gets without cudaFuncSetAttribute, so no launch sets it.
#include "ec.cuh"

namespace {

constexpr int kThreads = 128;
// two points and ec_add's scratch per thread, word-major
constexpr int kSmem = (36 + 36 + 24) * kThreads * 4;
static_assert(kSmem <= 48 * 1024, "ec_add_kernel needs the opt-in");

__global__ void __launch_bounds__(kThreads, 4)
ec_add_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
              int32_t* __restrict__ oz, const int32_t* __restrict__ x1,
              const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
              const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
              const int32_t* __restrict__ z2, long long n, long long es,
              long long ls) {
  extern __shared__ uint32_t smem[];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long off = i * es;
  uint32_t* mine = smem + threadIdx.x;
  const tk::Words p{mine, kThreads}, q{mine + 36 * kThreads, kThreads};
  const tk::Words w{mine + 72 * kThreads, kThreads};
  tk::load_point(p, x1 + off, y1 + off, z1 + off, ls);
  tk::load_point(q, x2 + off, y2 + off, z2 + off, ls);
  tk::ec_add(tk::Limbs{ox + off, oy + off, oz + off, ls}, p, q, w);
}

// B6, one thread a point: each thread doubles its point `times` times
// in a row.  The point stays in shared memory (36 words, and 12 for a
// temporary) from the load to the store, so a run of t doublings reads
// and writes device memory once: 8 t Fp products (~2,400 t word
// products) against 576 bytes, so the multiplies bound it.  On many
// lanes, where the card is full, registers set how many warps hide their
// latency, as for ec_add: 128 threads a block, at most 128 registers a
// thread, 4 blocks an SM.  On few lanes one thread's chain of 8 t
// dependent products sets the time (~20 us a doubling): there the quad
// kernel below runs.  Layout as ec_add_kernel's.
constexpr int kSmemDouble = (36 + 12) * kThreads * 4;
static_assert(kSmemDouble <= 48 * 1024, "ec_double_kernel needs the opt-in");

__global__ void __launch_bounds__(kThreads, 4)
ec_double_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                 int32_t* __restrict__ oz, const int32_t* __restrict__ x,
                 const int32_t* __restrict__ y,
                 const int32_t* __restrict__ z, long long n, long long es,
                 long long ls, int times) {
  extern __shared__ uint32_t smem[];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long off = i * es;
  uint32_t* mine = smem + threadIdx.x;
  const tk::Words p{mine, kThreads}, w{mine + 36 * kThreads, kThreads};
  tk::load_point(p, x + off, y + off, z + off, ls);
#pragma unroll 1
  for (int t = 0; t < times; ++t) tk::ec_double(p, w);
  tk::Limbs{ox + off, oy + off, oz + off, ls}.store(p);
}

// B6, four threads a point (ec.cuh's ec_double_quad): a doubling's chain
// is two products and the small steps, so on few lanes (the Horner
// fold's 2, the subgroup check's 2k, a table window's 4096) a run takes
// about a third of the one-thread kernel's time, and four times as many
// warps share the work.  Each thread of a quad loads the whole
// point into registers and keeps it there for the run; thread q < 3 of
// the quad stores coordinate q.  The threads of a last, partial quad
// (point index >= n) work on point n - 1 and store nothing: every lane
// of a warp must reach the shuffles, so none returns early.  No shared
// memory; at most 128 registers a thread.
__global__ void __launch_bounds__(kThreads, 4)
ec_double_quad_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                      int32_t* __restrict__ oz,
                      const int32_t* __restrict__ x,
                      const int32_t* __restrict__ y,
                      const int32_t* __restrict__ z, long long n,
                      long long es, long long ls, int times) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t >> 2;
  const int q = (int)(t & 3);
  const long long off = (i < n ? i : n - 1) * es;
  uint32_t X[12], Y[12], Z[12];
  tk::load_words<tk::FpT>(X, x + off, ls);
  tk::load_words<tk::FpT>(Y, y + off, ls);
  tk::load_words<tk::FpT>(Z, z + off, ls);
#pragma unroll 1
  for (int r = 0; r < times; ++r) tk::ec_double_quad(X, Y, Z, q);
  if (i >= n || q == 3) return;
  uint32_t w[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) w[j] = q == 0 ? X[j] : (q == 1 ? Y[j] : Z[j]);
  tk::store_limbs<tk::FpT>((q == 0 ? ox : (q == 1 ? oy : oz)) + off, ls, w);
}

}  // namespace

extern "C" int tpukzg_ec_add(void* ox, void* oy, void* oz, const void* x1,
                             const void* y1, const void* z1, const void* x2,
                             const void* y2, const void* z2, long long n,
                             long long es, long long ls, void* stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  ec_add_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)x1,
      (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, n, es, ls);
  return (int)cudaGetLastError();
}

// [2^times] P for n points, by `group` threads a point: 1 (the
// one-thread kernel) or 4 (the quad kernel); the caller picks by lane
// count.
extern "C" int tpukzg_ec_double(void* ox, void* oy, void* oz, const void* x,
                                const void* y, const void* z, long long n,
                                long long es, long long ls, int times,
                                int group, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (group == 4) {
    // blocks of 128 threads (32 points), or one warp's worth of them
    // when the whole run is smaller
    const long long threads = 4 * n < kThreads ? (4 * n + 31) / 32 * 32
                                               : kThreads;
    const unsigned blocks = (unsigned)((4 * n + threads - 1) / threads);
    ec_double_quad_kernel<<<blocks, (unsigned)threads, 0, st>>>(
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)x,
        (const int32_t*)y, (const int32_t*)z, n, es, ls, times);
  } else if (group == 1) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    ec_double_kernel<<<blocks, kThreads, kSmemDouble, st>>>(
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)x,
        (const int32_t*)y, (const int32_t*)z, n, es, ls, times);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
