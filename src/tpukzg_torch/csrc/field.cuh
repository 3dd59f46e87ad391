// Montgomery arithmetic over BLS12-381 Fp and Fr on 32-bit words.
//
// Shared device functions of the port's kernels.  `mont_mul` replaces
// the core `_montmul_lm_core` of tpukzg/pallas/montmul.py (separated
// Montgomery reduction over 16-bit limbs with Kogge-Stone carries); here
// it is CIOS over 32-bit words with 64-bit products: 12 words for Fp
// (R = 2^384), 8 for Fr (R = 2^256).  CIOS computes the same
// t = (a b + m p) / R (m < R is unique with a b + m p = 0 mod R) and the
// same final "subtract p if t >= p", so every result is bit-identical to
// the reference, for canonical inputs and for any inputs below R.
//
// In memory, field elements stay in the JAX package's format: 16-bit
// limbs, little-endian, one per int32.  `load_words` / `store_limbs`
// repack pairs of limbs into 32-bit words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tk {

static __constant__ uint32_t kFpP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod p: the Montgomery form of 1 (the Y of the point at infinity)
static __constant__ uint32_t kFpOne[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
static __constant__ uint32_t kFrP[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// R mod r: the Montgomery form of 1 in Fr
static __constant__ uint32_t kFrOne[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

struct FpT {
  static constexpr int N = 12;
  static constexpr uint32_t INV = 0xfffcfffdu;  // -p^-1 mod 2^32
  __device__ static __forceinline__ uint32_t p(int i) { return kFpP[i]; }
};

struct FrT {
  static constexpr int N = 8;
  static constexpr uint32_t INV = 0xffffffffu;  // -r^-1 mod 2^32
  __device__ static __forceinline__ uint32_t p(int i) { return kFrP[i]; }
};

// r = (carry ? t - p : (t >= p ? t - p : t)), all mod 2^(32 N)
template <class F>
__device__ __forceinline__ void cond_sub(uint32_t* r, const uint32_t* t,
                                         uint32_t carry) {
  constexpr int N = F::N;
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)t[j] - F::p(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = carry != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = ge ? d[j] : t[j];
}

// r = a * b * R^-1 mod p (CIOS).  r may alias a or b.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::INV;
    s = (uint64_t)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  cond_sub<F>(r, t, t[N]);
}

// r = a + b mod p (canonical inputs)
template <class F>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub<F>(r, s, (uint32_t)c);
}

// r = a - b mod p (canonical inputs)
template <class F>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)d[j] + (borrow ? F::p(j) : 0u);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

template <class F>
__device__ __forceinline__ void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = a[j];
}

// 16-bit limbs (int32 each) at p[0], p[ls], p[2 ls], ... -> words
template <class F>
__device__ __forceinline__ void load_words(uint32_t* w, const int32_t* p,
                                           long long ls) {
#pragma unroll
  for (int j = 0; j < F::N; ++j)
    w[j] = ((uint32_t)p[(2 * j) * ls] & 0xffffu) |
           ((uint32_t)p[(2 * j + 1) * ls] << 16);
}

template <class F>
__device__ __forceinline__ void store_limbs(int32_t* p, long long ls,
                                            const uint32_t* w) {
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    p[(2 * j) * ls] = (int32_t)(w[j] & 0xffffu);
    p[(2 * j + 1) * ls] = (int32_t)(w[j] >> 16);
  }
}

// One int4 (four 16-bit limbs, one per int32) <-> two words.
__device__ __forceinline__ void int4_words(uint32_t* w, int4 v) {
  w[0] = ((uint32_t)v.x & 0xffffu) | ((uint32_t)v.y << 16);
  w[1] = ((uint32_t)v.z & 0xffffu) | ((uint32_t)v.w << 16);
}

__device__ __forceinline__ int4 words_int4(uint32_t w0, uint32_t w1) {
  return make_int4((int32_t)(w0 & 0xffffu), (int32_t)(w0 >> 16),
                   (int32_t)(w1 & 0xffffu), (int32_t)(w1 >> 16));
}

// The contiguous limbs of one element at p (16-byte aligned) -> words,
// as F::N / 2 read-only 16-byte loads.  Nothing may write *p while the
// kernel runs.
template <class F>
__device__ __forceinline__ void load_words_v4(uint32_t* w, const int32_t* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int c = 0; c < F::N / 2; ++c) int4_words(w + 2 * c, __ldg(q + c));
}

template <class F>
__device__ __forceinline__ void store_limbs_v4(int32_t* p, const uint32_t* w) {
  int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int c = 0; c < F::N / 2; ++c) q[c] = words_int4(w[2 * c], w[2 * c + 1]);
}

}  // namespace tk
