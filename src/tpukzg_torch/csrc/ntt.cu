// B5: radix-2 NTT / iNTT over Fr as a few passes, each a range of stages
// on independent groups of elements, with the inverse's 1/n.
//
// Replaces tpukzg/pallas/ntt.py::_ntt_kernel.  On the TPU one grid step
// held a polynomial in a VMEM tile; each stage paired lanes with two
// rolls and a parity mask and multiplied ALL n lanes by a per-lane
// twiddle table of (log n, 16, n) limbs, and the bit-reversal was a
// gather outside the kernel.
//
// What bounds it on the H100: integer multiplies.  A polynomial takes
// (n/2) log2 n Fr products (about 540 operations each: 136 word
// products of two multiply-adds) against one read and one write of 64
// bytes an element, so the multiply units, not memory, set the floor;
// the kernel's job is to keep all 132 SMs multiplying.  Giving one
// polynomial one block (the first port) held 16 of 132 SMs at the
// prover's batch of 16, through 12 barrier-separated stages.
//
// Design: stages s0 .. s1-1 of a DIT NTT pair only indices that differ
// in bits s0 .. s1-1, so the m = 2^(s1-s0) elements that agree on every
// other bit form an independent group, at stride 2^s0.  One kernel,
// ntt_pass_kernel, runs the stages [s0, s1) of G such groups a block:
//  * groups whose low bits (those below s0) are consecutive, so that for
//    each of the m group positions the block reads G neighbouring
//    elements; each element moves as four 16-byte loads (int4), its
//    16-bit limbs repacked into 8 words in registers;
//  * the words sit in shared memory word-major with rows of G m + 4
//    words, so that the repacking's stores and loads fall in 32
//    distinct banks; each thread takes one butterfly a stage, one
//    barrier between stages;
//  * the first pass (s0 = 0) applies the bit-reversal in its load: its
//    G groups are those whose bit-reversed high bits are consecutive,
//    which again makes each position's G sources neighbours;
//  * the last pass of the inverse multiplies by 1/n on the way out.
// The launcher (kernels/ntt.py) cuts log2 n into passes (n <= 64: one;
// n = 4096: 6 + 6 stages; n = 2^18: 9 + 9) and picks the fewest groups
// that fill a warp: at the prover's (16, 4096) G = 1 and 1,024 blocks a
// pass, 7.8 an SM.
// Later passes read and write the output in place: a block touches only
// its own groups' elements.
//
// Twiddles: one table of n/2 roots (w^j, or w^-j for the inverse), stage
// s taking root j (n >> (s+1)), j = the index's bits below s.  Fr
// products: mont_mul<FrT> (field.cuh's CIOS in 64-bit C); the same CIOS
// as PTX carry chains ran slower on the H100 (PERF.md).
#include "field.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxElems = 4096;   // elements a block holds: 128 KB of words
constexpr int kPad = 4;           // words after each shared-memory row

__device__ __forceinline__ long long brev(long long i, int bits) {
  return bits == 0 ? 0
                   : (long long)(__brevll((unsigned long long)i) >> (64 - bits));
}

// Stages [s0, s1) of k DIT NTTs of size n = 2^log_n, G = 2^log_g groups
// a block.  src, dst (k, n, 16) int32 limbs (dst is src when s0 > 0);
// tw (n/2, 16); scale (16,) = 1/n (Montgomery).
__global__ void __launch_bounds__(kMaxThreads)
ntt_pass_kernel(int32_t* dst, const int32_t* src,
                const int32_t* __restrict__ tw,
                const int32_t* __restrict__ scale, int log_n, int s0, int s1,
                int log_g, int apply_scale) {
  extern __shared__ uint32_t sm[];
  const int log_m = s1 - s0;
  const int G = 1 << log_g;
  const int GM = 1 << (log_m + log_g);
  const int S = GM + kPad;
  const long long n = 1LL << log_n;
  const long long per_poly = n >> (log_m + log_g);
  const long long poly = blockIdx.x / per_poly;
  const long long b = blockIdx.x - poly * per_poly;
  const bool first = s0 == 0;
  // first pass: group g of the block is h = h0 + g, at DIT positions
  // brev(h) 2^s1 + jj, read from brev(jj) 2^(log_n - s1) + h.  Later
  // passes: positions hi 2^s1 + jj 2^s0 + lo0 + g, in place.
  const long long h0 = b << log_g;
  const long long hi = first ? 0 : b >> (s0 - log_g);
  const long long lo0 =
      first ? 0 : (b & ((1LL << (s0 - log_g)) - 1)) << log_g;
  const int32_t* sp = src + poly * n * 16;
  int32_t* dp = dst + poly * n * 16;

  // element e = jj G + g of the block, 16-byte piece c: thread q = 4 e + c
  for (int q = threadIdx.x; q < 4 * GM; q += blockDim.x) {
    const int e = q >> 2, c = q & 3;
    const int jj = e >> log_g, g = e & (G - 1);
    const long long at =
        first ? (brev(jj, log_m) << (log_n - s1)) | (h0 + g)
              : (hi << s1) | ((long long)jj << s0) | (lo0 + g);
    uint32_t w[2];
    tk::int4_words(w, reinterpret_cast<const int4*>(sp + at * 16)[c]);
    sm[(2 * c) * S + e] = w[0];
    sm[(2 * c + 1) * S + e] = w[1];
  }
  uint32_t sc[8];
  if (apply_scale) tk::load_words_v4<tk::FrT>(sc, scale);
  __syncthreads();

  for (int t = 0; t < log_m; ++t) {
    const int tshift = log_n - (s0 + t) - 1;   // n >> (s+1) = 2^tshift
    const bool out_scale = apply_scale && t == log_m - 1;
    for (int bf = threadIdx.x; bf < (GM >> 1); bf += blockDim.x) {
      const int g = bf & (G - 1);
      const int bb = bf >> log_g;
      const int j = bb & ((1 << t) - 1);
      const int e0 = ((((bb >> t) << (t + 1)) | j) << log_g) | g;
      const int e1 = e0 + (G << t);
      // the index's bits below s: j above s0, the group's low bits below
      const long long lo = first ? 0 : lo0 + g;
      const long long ti = ((long long)j << s0 | lo) << tshift;
      uint32_t u[8], v[8], w[8];
      tk::load_words_v4<tk::FrT>(w, tw + ti * 16);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        u[q] = sm[q * S + e0];
        v[q] = sm[q * S + e1];
      }
      tk::mont_mul<tk::FrT>(v, v, w);   // w v
      tk::add_mod<tk::FrT>(w, u, v);    // u + w v
      tk::sub_mod<tk::FrT>(v, u, v);    // u - w v
      if (out_scale) {
        tk::mont_mul<tk::FrT>(w, w, sc);
        tk::mont_mul<tk::FrT>(v, v, sc);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        sm[q * S + e0] = w[q];
        sm[q * S + e1] = v[q];
      }
    }
    __syncthreads();
  }

  for (int q = threadIdx.x; q < 4 * GM; q += blockDim.x) {
    const int e = q >> 2, c = q & 3;
    const int jj = e >> log_g, g = e & (G - 1);
    const long long at =
        first ? (brev(h0 + g, log_n - s1) << s1) | jj
              : (hi << s1) | ((long long)jj << s0) | (lo0 + g);
    reinterpret_cast<int4*>(dp + at * 16)[c] =
        tk::words_int4(sm[(2 * c) * S + e], sm[(2 * c + 1) * S + e]);
  }
}

int log2_exact(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return (1LL << l) == v ? l : -1;
}

bool smem_attr_set[64];

cudaError_t set_smem_attr() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && smem_attr_set[dev])) return err;
  const int bytes = (int)(8 * (kMaxElems + kPad) * sizeof(uint32_t));
  err = cudaFuncSetAttribute(ntt_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) smem_attr_set[dev] = true;
  return err;
}

}  // namespace

// Stages [s0, s1) of k NTTs of size n, 2^log_g groups a block, from src
// (the natural-order input when s0 = 0) into dst; the inverse's 1/n when
// apply_scale.  *blocks = the blocks launched.
extern "C" int tpukzg_ntt_pass(void* dst, const void* src, const void* tw,
                               const void* scale, long long k, long long n,
                               int s0, int s1, int log_g, int apply_scale,
                               int* blocks, void* stream) {
  *blocks = 0;
  const int log_n = log2_exact(n);
  const int log_m = s1 - s0;
  if (log_n < 1 || s0 < 0 || log_m < 1 || s1 > log_n || log_g < 0 ||
      log_g > (s0 == 0 ? log_n - s1 : s0) ||
      (1LL << (log_m + log_g)) > kMaxElems ||
      (s0 == 0) == (src == dst))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_attr();
  if (err != cudaSuccess) return (int)err;
  const long long gm = 1LL << (log_m + log_g);
  const int threads = (int)(gm / 2 < kMaxThreads ? gm / 2 : kMaxThreads);
  const size_t smem = (size_t)8 * (gm + kPad) * sizeof(uint32_t);
  const long long grid = k * (n >> (log_m + log_g));
  if (grid < 1 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ntt_pass_kernel<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)dst, (const int32_t*)src, (const int32_t*)tw,
      (const int32_t*)scale, log_n, s0, s1, log_g, apply_scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *blocks = (int)grid;
  return (int)err;
}
