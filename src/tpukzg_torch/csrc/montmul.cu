// B1: elementwise Montgomery product out = a * b * R^-1 mod p.
//
// Replaces tpukzg/pallas/montmul.py::_montmul_kernel (a lane-tiled VMEM
// kernel over limb-major (L, N) tiles).  One thread per element runs the
// CIOS product of field.cuh.
//
// What bounds it on the H100: memory.  An Fp product is 2*12^2 + 12 =
// 300 32x32->64-bit word products (two multiply-adds each) against 288
// bytes of traffic (two inputs and the output as 16-bit limbs in int32):
// about 2 multiply-adds a byte, below the card's ~10 (33.5 T multiply-
// adds/s over 3.35 TB/s).  The design reads each limb once, keeps the
// whole product in registers, one element per thread, fully unrolled,
// and makes limb-major accesses coalesced; the 16-bit-limb format itself
// (twice the bytes of packed words) is the cost it cannot remove.  The
// PTX carry chains (mad.lo.cc / madc.hi) are left for a later version.
//
// Layout: element i, limb j at ptr[i * elem_stride + j * limb_stride],
// so both the trailing (N, L) and the limb-major (L, N) layouts are read
// in place (limb-major gives coalesced accesses).
#include "field.cuh"

namespace {

template <class F>
__global__ void montmul_kernel(int32_t* __restrict__ out,
                               const int32_t* __restrict__ a,
                               const int32_t* __restrict__ b, long long n,
                               long long es, long long ls) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::N], y[F::N];
  tk::load_words<F>(x, a + i * es, ls);
  tk::load_words<F>(y, b + i * es, ls);
  tk::mont_mul<F>(x, x, y);
  tk::store_limbs<F>(out + i * es, ls, x);
}

}  // namespace

extern "C" int tpukzg_montmul(void* out, const void* a, const void* b,
                              long long n, long long es, long long ls,
                              int field, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    montmul_kernel<tk::FpT><<<blocks, threads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, es, ls);
  else
    montmul_kernel<tk::FrT><<<blocks, threads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, es, ls);
  return (int)cudaGetLastError();
}
