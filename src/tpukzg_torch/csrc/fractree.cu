// B4: fraction-tree bottom of the barycentric evaluation over Fr.
//
// Replaces tpukzg/pallas/fractree.py::_fractree_kernel, which loaded a
// 4096-lane tile of one blob into VMEM and halved it level by level down
// to 128 partials.  Per blob, a_i = e_i w^i and b_i = z - w^i, and two
// fractions merge as (A, B) + (a, b) = (A b + a B, B b).  A blob's pair
// is (A, B) = (sum_i a_i prod_{j != i} b_j, prod_i b_i).
//
// What bounds it on the H100: integer multiplies.  The reference takes
// n + 3 (n - 1) Fr products a blob of n elements (about 540 operations
// each: 136 word products of two multiply-adds), this design 3 n - 1,
// against 64 bytes of e_i read once, so the multiply units set the
// floor.  The design cuts the products and keeps every SM multiplying:
//  * no leaf product: since w^i = z - b_i, a blob's A equals z A' - S B
//    with A' = sum_i e_i prod_{j != i} b_j and S = sum_i e_i, so the
//    threads fold (e_i, b_i) and add up S, and (A', B, S) becomes (A, B)
//    with two products at the very end: 3 products an element where the
//    reference takes 4;
//  * the grid is k x parts blocks, parts (a power of two, chosen by the
//    launcher kernels/fractree.py) such that k parts >= twice the SM
//    count: 32 chunks a blob at the prover's k = 16, 2 at the
//    verifier's k = 256;
//  * thread t of a block takes elements t, t + T, t + 2T, ... of its
//    chunk, so that a warp reads 32 neighbouring elements, each as four
//    16-byte loads (the roots, shared by all blobs, come from L2 the
//    same way), and folds them serially in registers with no
//    synchronisation; the launcher gives a thread 32 elements where the
//    chunk allows, so that the tree below adds few products;
//  * the warp merges its 32 triples (A', B, S) by __shfl_down_sync of
//    their 24 words, 5 levels; the warps' triples meet in shared memory
//    and one warp finishes them, so no level leaves half a block
//    waiting at a barrier.  A thread with no element holds the identity
//    (0, 1, 0);
//  * a block writes its triple, and a second kernel, one warp a blob,
//    folds the blob's parts the same way (strided over the lanes, then
//    by shuffles) and turns the triple left into (A, B): a blob leaves
//    one pair whatever the parts, so the host has no tail to fold.
// Fraction addition is exact in the field and z A' - S B = A is an
// identity, so the pair is the reference's bit for bit, and the
// in-domain case z = w^m (b_m = 0) needs no branch.  Fr products:
// mont_mul<FrT> (field.cuh's CIOS in 64-bit C); the same CIOS as PTX
// carry chains ran slower on the H100 (PERF.md).
#include "field.cuh"

namespace {

constexpr int kMaxThreads = 256;

// (A', B, S) + (a, b, s) = (A' b + a B, B b, S + s)
__device__ __forceinline__ void merge(uint32_t* A, uint32_t* B, uint32_t* S,
                                      const uint32_t* a, const uint32_t* b,
                                      const uint32_t* s) {
  uint32_t t1[8], t2[8];
  tk::mont_mul<tk::FrT>(t1, A, b);
  tk::mont_mul<tk::FrT>(t2, a, B);
  tk::add_mod<tk::FrT>(A, t1, t2);
  tk::mont_mul<tk::FrT>(B, B, b);
  tk::add_mod<tk::FrT>(S, S, s);
}

// Lane l merges lane l + off's triple into its own, off = width/2 .. 1:
// lane 0 ends with the sum of lanes 0 .. width - 1.
__device__ __forceinline__ void warp_merge(uint32_t* A, uint32_t* B,
                                           uint32_t* S, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    uint32_t a[8], b[8], s[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      a[q] = __shfl_down_sync(0xffffffffu, A[q], off);
      b[q] = __shfl_down_sync(0xffffffffu, B[q], off);
      s[q] = __shfl_down_sync(0xffffffffu, S[q], off);
    }
    merge(A, B, S, a, b, s);
  }
}

__device__ __forceinline__ void identity(uint32_t* A, uint32_t* B,
                                         uint32_t* S) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    A[q] = S[q] = 0u;
    B[q] = tk::kFrOne[q];
  }
}

// e (k, n, 16), w (n, 16), z (k, 16) 16-bit limbs; part (k, n/chunk, 24)
// words: each chunk's triple (A', B, S).  blockDim.x: a power of two, at
// least 32.
__global__ void __launch_bounds__(kMaxThreads)
fractree_kernel(uint32_t* __restrict__ part, const int32_t* __restrict__ e,
                const int32_t* __restrict__ w, const int32_t* __restrict__ z,
                long long n, long long chunk) {
  __shared__ uint32_t sm[kMaxThreads / 32][24];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long parts = n / chunk;
  const long long blob = blockIdx.x / parts;
  const long long i0 = (blockIdx.x - blob * parts) * chunk;
  const int32_t* eb = e + (blob * n + i0) * 16;
  const int32_t* wb = w + i0 * 16;

  uint32_t zw[8], A[8], B[8], S[8];
  tk::load_words_v4<tk::FrT>(zw, z + blob * 16);
  if (tid < chunk) {
    tk::load_words_v4<tk::FrT>(A, eb + (long long)tid * 16);   // e_i
    tk::load_words_v4<tk::FrT>(B, wb + (long long)tid * 16);
    tk::sub_mod<tk::FrT>(B, zw, B);                            // z - w^i
    tk::copy<tk::FrT>(S, A);
  } else {
    identity(A, B, S);
  }
  for (long long i = tid + T; i < chunk; i += T) {
    uint32_t a[8], b[8];
    tk::load_words_v4<tk::FrT>(a, eb + i * 16);
    tk::load_words_v4<tk::FrT>(b, wb + i * 16);
    tk::sub_mod<tk::FrT>(b, zw, b);
    merge(A, B, S, a, b, a);
  }

  warp_merge(A, B, S, 32);
  const int nw = T >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  if (nw > 1) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        sm[warp][q] = A[q];
        sm[warp][8 + q] = B[q];
        sm[warp][16 + q] = S[q];
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int from = lane < nw ? lane : 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        A[q] = sm[from][q];
        B[q] = sm[from][8 + q];
        S[q] = sm[from][16 + q];
      }
      warp_merge(A, B, S, nw);
    }
  }
  if (tid == 0) {
    uint32_t* o = part + (long long)blockIdx.x * 24;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      o[q] = A[q];
      o[8 + q] = B[q];
      o[16 + q] = S[q];
    }
  }
}

// One warp a blob: lane l folds the triples of parts l, l + 32, ..., the
// warp merges them by shuffles, and lane 0 writes (A, B) = (z A' - S B,
// B) as 16-bit limbs to oa, ob (k, 16).
__global__ void __launch_bounds__(32)
fractree_fold_kernel(int32_t* __restrict__ oa, int32_t* __restrict__ ob,
                     const uint32_t* __restrict__ part,
                     const int32_t* __restrict__ z, int parts) {
  const int lane = threadIdx.x;
  const uint32_t* pb = part + (long long)blockIdx.x * parts * 24;
  uint32_t A[8], B[8], S[8];
  identity(A, B, S);
  for (int i = lane; i < parts; i += 32) {
    const uint32_t* p = pb + (long long)i * 24;
    uint32_t a[8], b[8], s[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      a[q] = p[q];
      b[q] = p[8 + q];
      s[q] = p[16 + q];
    }
    if (i == lane) {
      tk::copy<tk::FrT>(A, a);
      tk::copy<tk::FrT>(B, b);
      tk::copy<tk::FrT>(S, s);
    } else {
      merge(A, B, S, a, b, s);
    }
  }
  warp_merge(A, B, S, parts < 32 ? parts : 32);
  if (lane == 0) {
    uint32_t zw[8], t[8];
    tk::load_words_v4<tk::FrT>(zw, z + (long long)blockIdx.x * 16);
    tk::mont_mul<tk::FrT>(A, A, zw);       // z A'
    tk::mont_mul<tk::FrT>(t, S, B);        // S B
    tk::sub_mod<tk::FrT>(A, A, t);         // A = z A' - S B
    tk::store_limbs_v4<tk::FrT>(oa + (long long)blockIdx.x * 16, A);
    tk::store_limbs_v4<tk::FrT>(ob + (long long)blockIdx.x * 16, B);
  }
}

}  // namespace

// k blobs of n elements cut into parts = n / chunk chunks of `threads`
// threads each, their triples in part (k, parts, 24) words, then folded
// to one (A, B) pair a blob in oa, ob (k, 16); blocks[0], blocks[1] = the
// blocks of the two kernels launched.
extern "C" int tpukzg_fractree(void* oa, void* ob, void* part, const void* e,
                               const void* w, const void* z, long long k,
                               long long n, long long chunk, int threads,
                               int* blocks, void* stream) {
  blocks[0] = blocks[1] = 0;
  if (chunk < 1 || n % chunk || threads < 32 || threads > kMaxThreads ||
      (threads & (threads - 1)) || n / chunk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long grid = k * (n / chunk);
  if (grid < 1 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  fractree_kernel<<<(unsigned)grid, threads, 0, st>>>(
      (uint32_t*)part, (const int32_t*)e, (const int32_t*)w,
      (const int32_t*)z, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blocks[0] = (int)grid;
  fractree_fold_kernel<<<(unsigned)k, 32, 0, st>>>(
      (int32_t*)oa, (int32_t*)ob, (const uint32_t*)part, (const int32_t*)z,
      (int)(n / chunk));
  err = cudaGetLastError();
  if (err == cudaSuccess) blocks[1] = (int)k;
  return (int)err;
}
