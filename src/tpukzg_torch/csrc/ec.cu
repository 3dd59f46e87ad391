// B2 launcher: elementwise complete G1 addition, one thread per point.
//
// A thin launcher around the device function ec_add of ec.cuh (which
// replaces tpukzg/pallas/ec.py::ec_add inside the bucket-scan kernel),
// so every lane of the formula can be checked alone and so the curve
// code's batched adds take one launch on the card.  ~3,600 word products
// (7,200 multiply-adds) per point against 864 bytes moved, just under the
// card's ~10 multiply-adds a byte, so the bytes bound it on paper; in
// practice registers do (two points are 72 words; ptxas gives ~200 a
// thread), which caps occupancy, so each thread holds one point and
// blocks are small.  Layout as in montmul.cu: element i, limb j at
// i * es + j * ls.
#include "ec.cuh"

namespace {

__device__ __forceinline__ void load_point(tk::G1& p, const int32_t* x,
                                           const int32_t* y, const int32_t* z,
                                           long long off, long long ls) {
  tk::load_words<tk::FpT>(p.x, x + off, ls);
  tk::load_words<tk::FpT>(p.y, y + off, ls);
  tk::load_words<tk::FpT>(p.z, z + off, ls);
}

__global__ void __launch_bounds__(128)
ec_add_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
              int32_t* __restrict__ oz, const int32_t* __restrict__ x1,
              const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
              const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
              const int32_t* __restrict__ z2, long long n, long long es,
              long long ls) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tk::G1 p, q;
  load_point(p, x1, y1, z1, i * es, ls);
  load_point(q, x2, y2, z2, i * es, ls);
  tk::ec_add(p, p, q);
  tk::store_limbs<tk::FpT>(ox + i * es, ls, p.x);
  tk::store_limbs<tk::FpT>(oy + i * es, ls, p.y);
  tk::store_limbs<tk::FpT>(oz + i * es, ls, p.z);
}

}  // namespace

extern "C" int tpukzg_ec_add(void* ox, void* oy, void* oz, const void* x1,
                             const void* y1, const void* z1, const void* x2,
                             const void* y2, const void* z2, long long n,
                             long long es, long long ls, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  ec_add_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)x1,
      (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, n, es, ls);
  return (int)cudaGetLastError();
}
