// B2 launcher: elementwise complete G1 addition, one thread per point.
//
// A thin launcher around the device function ec_add of ec.cuh (which
// replaces tpukzg/pallas/ec.py::ec_add inside the bucket-scan kernel),
// so every lane of the formula can be checked alone and so the curve
// code's batched adds take one launch on the card.  ~3,600 word products
// (7,200 multiply-adds) per point against 864 bytes moved, just under the
// card's ~10 multiply-adds a byte, so the bytes bound it on paper; in
// practice the multiply chains do, and registers set how many warps hide
// their latency.  Each thread stages its two points in shared memory
// (2 x 144 bytes, and ec_add's 96 bytes of scratch), where ec_add reads
// them, and keeps only the formula's temporaries in registers: 128
// threads a block, at most 128 registers a thread, so 4 blocks
// (16 warps, 4 x 48 KB of shared memory) fit on an SM.  Layout as
// in montmul.cu: element i, limb j at i * es + j * ls.
#include "ec.cuh"

namespace {

constexpr int kThreads = 128;
// two points and ec_add's scratch per thread, word-major
constexpr int kSmem = (36 + 36 + 24) * kThreads * 4;

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

}  // namespace

extern "C" int tpukzg_ec_add(void* ox, void* oy, void* oz, const void* x1,
                             const void* y1, const void* z1, const void* x2,
                             const void* y2, const void* z2, long long n,
                             long long es, long long ls, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ec_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  ec_add_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)x1,
      (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, n, es, ls);
  return (int)cudaGetLastError();
}
