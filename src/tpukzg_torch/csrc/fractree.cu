// B4: fraction-tree bottom of the barycentric evaluation over Fr.
//
// Replaces tpukzg/pallas/fractree.py::_fractree_kernel, which loaded a
// 4096-lane tile of one blob into VMEM and halved it level by level down
// to 128 partials.  Here a block takes CHUNK consecutive elements of one
// blob (grid = blobs x chunks); each thread first folds RUN = 8
// consecutive elements serially in registers,
//     a = e_i w^i,  b = z - w^i,  (A, B) <- (A b + a B, B b),
// then the block merges its threads' fractions in a shared-memory tree
// and writes ONE (A, B) pair per chunk.  Fraction addition is exact in
// the field, so any merge order gives the same numerator, and the
// in-domain case z = w^m (b_m = 0) needs no branch.
//
// What bounds it on the H100: integer multiplies — 4 Fr products per
// element (about 540 word products, twice as many multiply-adds)
// against 64 bytes of e_i read once.  The serial run keeps three quarters of the products in
// registers with no synchronisation; the tree's later levels leave
// threads idle, which a later version can cut with warp shuffles.
#include "field.cuh"

namespace {

constexpr int kRun = 8;

__device__ __forceinline__ void merge(uint32_t* A, uint32_t* B,
                                      const uint32_t* a, const uint32_t* b) {
  uint32_t t1[8], t2[8];
  tk::mont_mul<tk::FrT>(t1, A, b);
  tk::mont_mul<tk::FrT>(t2, a, B);
  tk::add_mod<tk::FrT>(A, t1, t2);
  tk::mont_mul<tk::FrT>(B, B, b);
}

// e (k, n, 16), w (n, 16), z (k, 16) 16-bit limbs; out (k, n/chunk, 16)
__global__ void fractree_kernel(int32_t* __restrict__ oa,
                                int32_t* __restrict__ ob,
                                const int32_t* __restrict__ e,
                                const int32_t* __restrict__ w,
                                const int32_t* __restrict__ z, long long n,
                                int chunk) {
  extern __shared__ uint32_t sm[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long blob = blockIdx.x;
  const long long i0 = (long long)blockIdx.y * chunk + (long long)tid * kRun;

  uint32_t zw[8], A[8], B[8];
  tk::load_words<tk::FrT>(zw, z + blob * 16, 1);
  for (int r = 0; r < kRun; ++r) {
    const long long i = i0 + r;
    uint32_t ew[8], ww[8], a[8], b[8];
    tk::load_words<tk::FrT>(ew, e + (blob * n + i) * 16, 1);
    tk::load_words<tk::FrT>(ww, w + i * 16, 1);
    tk::mont_mul<tk::FrT>(a, ew, ww);
    tk::sub_mod<tk::FrT>(b, zw, ww);
    if (r == 0) {
      tk::copy<tk::FrT>(A, a);
      tk::copy<tk::FrT>(B, b);
    } else {
      merge(A, B, a, b);
    }
  }

  uint32_t* sa = sm;
  uint32_t* sb = sm + 8 * T;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sa[j * T + tid] = A[j];
    sb[j * T + tid] = B[j];
  }
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (tid < s) {
      uint32_t a2[8], b2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a2[j] = sa[j * T + tid + s];
        b2[j] = sb[j * T + tid + s];
      }
      merge(A, B, a2, b2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sa[j * T + tid] = A[j];
        sb[j * T + tid] = B[j];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long long o = (blob * gridDim.y + blockIdx.y) * 16;
    tk::store_limbs<tk::FrT>(oa + o, 1, A);
    tk::store_limbs<tk::FrT>(ob + o, 1, B);
  }
}

}  // namespace

extern "C" int tpukzg_fractree(void* oa, void* ob, const void* e,
                               const void* w, const void* z, long long k,
                               long long n, long long chunk, void* stream) {
  const int threads = (int)(chunk / kRun);
  const dim3 grid((unsigned)k, (unsigned)(n / chunk));
  const size_t smem = 2 * 8 * threads * sizeof(uint32_t);
  fractree_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)oa, (int32_t*)ob, (const int32_t*)e, (const int32_t*)w,
      (const int32_t*)z, n, (int)chunk);
  return (int)cudaGetLastError();
}
