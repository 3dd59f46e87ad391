// B1: elementwise Montgomery product out = a * b * R^-1 mod p, and the
// chain launch: out = a^e, a whole square-and-multiply chain in one
// launch.
//
// Replaces tpukzg/pallas/montmul.py::_montmul_kernel (a lane-tiled VMEM
// kernel over limb-major (L, N) tiles).  One thread per element runs
// the CIOS product of field.cuh (mont_mul).
//
// What bounds it on the H100: memory.  An Fp product is 2*12^2 + 12 =
// 300 32x32->64-bit word products (two multiply-adds each) against 288
// bytes of traffic (two inputs and the output as 16-bit limbs in int32):
// about 2 multiply-adds a byte, below the card's ~10 (33.5 T multiply-
// adds/s over 3.35 TB/s).  The design reads each limb once, keeps the
// whole product in registers, one element per thread, fully unrolled,
// and makes limb-major accesses coalesced; the 16-bit-limb format itself
// (twice the bytes of packed words) is the cost it cannot remove.  On
// the card the Fr launch at 2^20 lanes runs at the time of a copy with
// the same loads and stores (chip_smoke.py reports both), and the Fp
// launch ~11 % above it.  ec.cuh's PTX carry-chain rows (fp_mul) with
// both operands in registers were slower than mont_mul<FpT> in this
// launch and no faster in a chain, so B1 keeps mont_mul.
//
// The chain kernel replaces what the JAX package runs as one
// lax.fori_loop (tpukzg/field/mont.py::pow_bits): a Fermat inversion
// (p - 2: 608 Fp products; r - 2: 417 Fr products) or the square root
// ((p + 1) / 4: 606).  Each thread loads its element once, runs the
// chain with the accumulator in registers and stores once, so the chain
// costs one launch instead of one a product.  The exponent comes by
// value in the kernel's arguments (no upload, so no host sync); its bits
// are the same for every thread, so the warps never diverge.  Order:
// most significant bit first, the top bit (always 1) taken as acc = a,
// then for each lower bit a square and, where the bit is 1, a multiply
// by a: the products of the port's per-launch loop, so the result is
// bit-identical to it and to the JAX fori_loop (which squares one and
// selects).  Bound: one thread's chain of dependent products, ~1.5 us
// an Fp product and ~0.7 us an Fr one on the H100; bytes and operations
// say ~0.
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

// An exponent of at most 384 bits, least significant word first.
struct PowExp {
  uint32_t w[12];
  int nbits;
};

template <class F>
__global__ void __launch_bounds__(64)
montmul_pow_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                   long long n, long long es, long long ls,
                   const __grid_constant__ PowExp e) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::N], acc[F::N];
  tk::load_words<F>(x, a + i * es, ls);
  tk::copy<F>(acc, x);
#pragma unroll 1
  for (int k = e.nbits - 2; k >= 0; --k) {
    tk::mont_mul<F>(acc, acc, acc);
    if ((e.w[k >> 5] >> (k & 31)) & 1u) tk::mont_mul<F>(acc, acc, x);
  }
  tk::store_limbs<F>(out + i * es, ls, acc);
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

// out = a^e for n elements; e's nbits (1..384) bits in `words` (host
// memory, least significant word first), copied into the kernel's
// arguments.  Blocks of 64 threads, so a chain on few lanes spreads over
// as many SMs as it has warps.
extern "C" int tpukzg_montmul_pow(void* out, const void* a, long long n,
                                  long long es, long long ls,
                                  const unsigned* words, int nbits,
                                  int field, void* stream) {
  if (nbits < 1 || nbits > 384) return (int)cudaErrorInvalidValue;
  PowExp e{};
  for (int k = 0; k < (nbits + 31) / 32; ++k) e.w[k] = words[k];
  e.nbits = nbits;
  const int threads = 64;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    montmul_pow_kernel<tk::FpT><<<blocks, threads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, n, es, ls, e);
  else
    montmul_pow_kernel<tk::FrT><<<blocks, threads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, n, es, ls, e);
  return (int)cudaGetLastError();
}
