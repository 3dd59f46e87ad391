// B5: radix-2 NTT / iNTT over Fr, all stages, with the inverse's 1/n.
//
// Replaces tpukzg/pallas/ntt.py::_ntt_kernel.  On the TPU one grid step
// held a polynomial in a VMEM tile; each stage paired lanes with two
// rolls and a parity mask and multiplied ALL n lanes by a per-lane
// twiddle table of (log n, 16, n) limbs, and the bit-reversal was a
// gather outside the kernel.  Here:
//
//  * ntt_block_kernel: one block per chunk of m = min(n, 4096) elements
//    of one polynomial.  The load repacks 16-bit limbs into 8 words and
//    applies the bit-reversal (chunk c holds positions c m .. c m + m - 1
//    of the bit-reversed order).  The words sit in shared memory
//    word-major (sm[w m + i], 32 m bytes: 128 KB at m = 4096), so
//    neighbouring threads touch neighbouring banks.  Stages 0 .. log m - 1
//    stay inside a chunk; each thread does m / (2 T) butterflies a stage,
//    one barrier between stages.  With m = n the whole transform runs
//    here and the inverse's 1/n multiplies on the way out.
//  * ntt_stage_kernel: a stage s >= log m (only for n > 4096) as one pass
//    over device memory, one thread per butterfly, in place.
//
// Twiddles: one table of n/2 roots (w^j, or w^-j for the inverse), stage
// s taking root j (n >> (s+1)) -- n/2 products a stage instead of n.
//
// What bounds it on the H100: integer multiplies, (n/2) log2 n Fr
// products a polynomial (~540 word multiply-adds each) against one read
// and one write of 64 bytes an element.  This first version gives a
// polynomial at n = 4096 one block, so a batch of 16 fills 16 of the 132
// SMs; spreading a polynomial over several blocks is left for later.
#include "field.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ long long bit_reverse(long long i, int log_n) {
  return (long long)(__brevll((unsigned long long)i) >> (64 - log_n));
}

__device__ __forceinline__ void butterfly(uint32_t* u, uint32_t* v,
                                          const uint32_t* w) {
  uint32_t t[8];
  tk::mont_mul<tk::FrT>(v, v, w);  // v <- w v
  tk::add_mod<tk::FrT>(t, u, v);   // u + w v
  tk::sub_mod<tk::FrT>(v, u, v);   // u - w v
  tk::copy<tk::FrT>(u, t);
}

// x, out (k, n, 16) int32 limbs; tw (n/2, 16); scale (16,) = 1/n (mont)
__global__ void __launch_bounds__(kThreads)
ntt_block_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                 const int32_t* __restrict__ tw,
                 const int32_t* __restrict__ scale, long long n, int log_n,
                 int m, int log_m, int apply_scale) {
  extern __shared__ uint32_t sm[];
  const long long chunks = n >> log_m;
  const long long poly = blockIdx.x / chunks;
  const long long base = (blockIdx.x % chunks) * m;
  const int32_t* xp = x + poly * n * 16;

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    uint32_t w[8];
    tk::load_words<tk::FrT>(w, xp + bit_reverse(base + i, log_n) * 16, 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) sm[j * m + i] = w[j];
  }
  __syncthreads();

  for (int s = 0; s < log_m; ++s) {
    const int half = 1 << s;
    const long long tstep = n >> (s + 1);
    for (int b = threadIdx.x; b < (m >> 1); b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b >> s) << (s + 1)) | j;
      const int i1 = i0 + half;
      uint32_t u[8], v[8], w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        u[q] = sm[q * m + i0];
        v[q] = sm[q * m + i1];
      }
      tk::load_words<tk::FrT>(w, tw + (long long)j * tstep * 16, 1);
      butterfly(u, v, w);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        sm[q * m + i0] = u[q];
        sm[q * m + i1] = v[q];
      }
    }
    __syncthreads();
  }

  uint32_t sc[8];
  if (apply_scale) tk::load_words<tk::FrT>(sc, scale, 1);
  int32_t* op = out + (poly * n + base) * 16;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = sm[j * m + i];
    if (apply_scale) tk::mont_mul<tk::FrT>(w, w, sc);
    tk::store_limbs<tk::FrT>(op + (long long)i * 16, 1, w);
  }
}

// one stage s over a (k, n, 16) array in place
__global__ void __launch_bounds__(256)
ntt_stage_kernel(int32_t* __restrict__ a, const int32_t* __restrict__ tw,
                 const int32_t* __restrict__ scale, long long k, long long n,
                 int s, int apply_scale) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = n >> 1;
  if (t >= k * per) return;
  const long long poly = t / per;
  const long long b = t - poly * per;
  const long long half = 1LL << s;
  const long long j = b & (half - 1);
  const long long i0 = ((b >> s) << (s + 1)) | j;
  int32_t* p0 = a + (poly * n + i0) * 16;
  int32_t* p1 = p0 + half * 16;
  uint32_t u[8], v[8], w[8];
  tk::load_words<tk::FrT>(u, p0, 1);
  tk::load_words<tk::FrT>(v, p1, 1);
  tk::load_words<tk::FrT>(w, tw + j * (n >> (s + 1)) * 16, 1);
  butterfly(u, v, w);
  if (apply_scale) {
    tk::load_words<tk::FrT>(w, scale, 1);
    tk::mont_mul<tk::FrT>(u, u, w);
    tk::mont_mul<tk::FrT>(v, v, w);
  }
  tk::store_limbs<tk::FrT>(p0, 1, u);
  tk::store_limbs<tk::FrT>(p1, 1, v);
}

int log2_exact(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return (1LL << l) == v ? l : -1;
}

}  // namespace

// stages 0 .. log2(m) - 1 of k NTTs of size n, chunks of m in shared memory
extern "C" int tpukzg_ntt_block(void* out, const void* x, const void* tw,
                                const void* scale, long long k, long long n,
                                long long m, int apply_scale, void* stream) {
  const int log_n = log2_exact(n);
  const int log_m = log2_exact(m);
  if (log_n < 1 || log_m < 1 || m > n || m > 4096) return (int)cudaErrorInvalidValue;
  const int threads = (int)(m / 2 < kThreads ? m / 2 : kThreads);
  const size_t smem = (size_t)8 * m * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = k * (n / m);
  ntt_block_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const int32_t*)tw,
      (const int32_t*)scale, n, log_n, (int)m, log_m, apply_scale);
  return (int)cudaGetLastError();
}

// stage s of k NTTs of size n, in place in device memory
extern "C" int tpukzg_ntt_stage(void* a, const void* tw, const void* scale,
                                long long k, long long n, int s,
                                int apply_scale, void* stream) {
  const int log_n = log2_exact(n);
  if (log_n < 1 || s < 0 || s >= log_n) return (int)cudaErrorInvalidValue;
  const long long work = k * (n / 2);
  const long long blocks = (work + 255) / 256;
  ntt_stage_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)a, (const int32_t*)tw, (const int32_t*)scale, k, n, s,
      apply_scale);
  return (int)cudaGetLastError();
}
