// B2: complete projective addition on G1: y^2 = x^3 + 4 over Fp, and
// B6: complete projective doubling (ec_double and ec_double_quad, at the end
// of this file).
//
// Replaces the device function tpukzg/pallas/ec.py::ec_add (Renes-
// Costello-Batina 2015, Alg. 7, a = 0, b3 = 3b = 12): 12 Montgomery
// products, no branches, correct for P = Q, P = -Q and infinity.  Every
// field result is canonical and each step computes the same field value
// as pallas/ec.py:71-100, so the output is bit-identical to the
// reference whatever the order of the steps.
//
// What bounds it inside a kernel: integer multiplies (12 Fp products,
// about 3,600 word products per add) and registers, which set how many
// warps an SM holds to hide the long multiply-add chains.  So:
// - the two input points (72 words) stay in shared memory (`Words`);
// - each product's second operand is read from shared memory a word per
//   row, and its row loop stays rolled: one copy of ~60 instructions
//   serves all 12 rows, so the compiler cannot interleave products (and
//   hold several sets of operands) and the code stays small;
// - the steps are ordered so that each temporary dies as soon as it is
//   consumed, and y3, used by two products, waits in shared memory.
// At most five 12-word temporaries, one operand and one product's
// accumulator are live at once (~86 words).
#pragma once

#include "field.cuh"

namespace tk {

// G1 point words in shared memory, X, Y, Z of 12 words each: word w at
// p[w * stride].  Also one or two 12-word field elements (scratch).
struct Words {
  volatile uint32_t* p;
  int stride;
  __device__ __forceinline__ uint32_t word(int c, int j) const {
    return p[(12 * c + j) * stride];
  }
  // coordinate c alone
  __device__ __forceinline__ Words at(int c) const {
    return Words{p + 12 * c * stride, stride};
  }
  __device__ __forceinline__ void get(int c, uint32_t* w) const {
#pragma unroll
    for (int j = 0; j < 12; ++j) w[j] = word(c, j);
  }
  // w = coordinate c0 + coordinate c1 (add_mod, read word by word)
  __device__ __forceinline__ void get_sum(int c0, int c1, uint32_t* w) const {
    uint32_t s[12];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      c += (uint64_t)word(c0, j) + word(c1, j);
      s[j] = (uint32_t)c;
      c >>= 32;
    }
    cond_sub<FpT>(w, s, (uint32_t)c);
  }
  __device__ __forceinline__ void put(int c, const uint32_t* w) const {
#pragma unroll
    for (int j = 0; j < 12; ++j) p[(12 * c + j) * stride] = w[j];
  }
  __device__ __forceinline__ void copy_from(const Words& q) const {
#pragma unroll
    for (int w = 0; w < 36; ++w) p[w * stride] = q.p[w * q.stride];
  }
  __device__ __forceinline__ void set_inf() const {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      p[j * stride] = 0u;
      p[(12 + j) * stride] = kFpOne[j];
      p[(24 + j) * stride] = 0u;
    }
  }
};

// A G1 point in device memory in the JAX package's format: coordinates
// x, y, z of 24 16-bit limbs (one per int32), limb i at i * ls.  The
// limb addresses advance by an opaque pointer step, so that a caller's
// loop keeps no table of the 24 limb offsets in registers.
struct Limbs {
  int32_t* x;
  int32_t* y;
  int32_t* z;
  long long ls;
  __device__ __forceinline__ void put(int c, const uint32_t* w) const {
    int32_t* q = c == 0 ? x : (c == 1 ? y : z);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      q[0] = (int32_t)(w[j] & 0xffffu);
      q[ls] = (int32_t)(w[j] >> 16);
      q += 2 * ls;
      asm volatile("" : "+l"(q));
    }
  }
  __device__ __forceinline__ void store(const Words& s) const {
    uint32_t w[12];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.get(c, w);
      put(c, w);
    }
  }
};

// d = the point whose coordinates' 16-bit limbs are x, y, z (limb i at
// i * ls)
__device__ __forceinline__ void load_point(const Words& d, const int32_t* x,
                                           const int32_t* y, const int32_t* z,
                                           long long ls) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int32_t* q = c == 0 ? x : (c == 1 ? y : z);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      d.p[(12 * c + j) * d.stride] =
          ((uint32_t)q[0] & 0xffffu) | ((uint32_t)q[ls] << 16);
      q += 2 * ls;
      asm volatile("" : "+l"(q));
    }
  }
}

// r = a b R^-1 mod p, b read from shared memory (word i at b.p[i *
// b.stride]).  CIOS as mont_mul<FpT> of field.cuh, each row's products
// and carries as PTX carry chains (mad.lo.cc / madc.hi.cc), the shift by
// a word folded into the reduction's chain.  The same t, m and final
// subtraction as mont_mul, so the result is bit-identical.  r may alias
// a.  With both operands in registers mont_mul<FpT> was as fast or
// faster (PERF.md section 6), so B1 and the quad doubling take it; the
// products whose second operand stays in shared memory take these rows.
__device__ __forceinline__ void fp_mul(uint32_t* r, const uint32_t* a,
                                       const Words& b) {
  uint32_t t[14];
#pragma unroll
  for (int j = 0; j < 14; ++j) t[j] = 0;
#pragma unroll 1
  for (int i = 0; i < 12; ++i) {
    const uint32_t bi = b.p[i * b.stride];
    // t += a bi: the low halves into t[0..11], the high halves into
    // t[1..12], carries up to t[13]
    asm("mad.lo.cc.u32 %0, %14, %26, %0;\n\t"
        "madc.lo.cc.u32 %1, %15, %26, %1;\n\t"
        "madc.lo.cc.u32 %2, %16, %26, %2;\n\t"
        "madc.lo.cc.u32 %3, %17, %26, %3;\n\t"
        "madc.lo.cc.u32 %4, %18, %26, %4;\n\t"
        "madc.lo.cc.u32 %5, %19, %26, %5;\n\t"
        "madc.lo.cc.u32 %6, %20, %26, %6;\n\t"
        "madc.lo.cc.u32 %7, %21, %26, %7;\n\t"
        "madc.lo.cc.u32 %8, %22, %26, %8;\n\t"
        "madc.lo.cc.u32 %9, %23, %26, %9;\n\t"
        "madc.lo.cc.u32 %10, %24, %26, %10;\n\t"
        "madc.lo.cc.u32 %11, %25, %26, %11;\n\t"
        "addc.cc.u32 %12, %12, 0;\n\t"
        "addc.u32 %13, %13, 0;\n\t"
        "mad.hi.cc.u32 %1, %14, %26, %1;\n\t"
        "madc.hi.cc.u32 %2, %15, %26, %2;\n\t"
        "madc.hi.cc.u32 %3, %16, %26, %3;\n\t"
        "madc.hi.cc.u32 %4, %17, %26, %4;\n\t"
        "madc.hi.cc.u32 %5, %18, %26, %5;\n\t"
        "madc.hi.cc.u32 %6, %19, %26, %6;\n\t"
        "madc.hi.cc.u32 %7, %20, %26, %7;\n\t"
        "madc.hi.cc.u32 %8, %21, %26, %8;\n\t"
        "madc.hi.cc.u32 %9, %22, %26, %9;\n\t"
        "madc.hi.cc.u32 %10, %23, %26, %10;\n\t"
        "madc.hi.cc.u32 %11, %24, %26, %11;\n\t"
        "madc.hi.cc.u32 %12, %25, %26, %12;\n\t"
        "addc.u32 %13, %13, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
          "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]),
          "r"(bi));
    // t = (t + m p) / 2^32, m = t[0] (-p^-1) mod 2^32: the low halves
    // land a word down (t[0] + lo(m p0) is 0 mod 2^32; only its carry
    // is kept), then the high halves
    const uint32_t m = t[0] * FpT::INV;
    asm("mad.lo.cc.u32 %0, %14, 0xffffaaab, %0;\n\t"
        "madc.lo.cc.u32 %0, %14, 0xb9feffff, %1;\n\t"
        "madc.lo.cc.u32 %1, %14, 0xb153ffff, %2;\n\t"
        "madc.lo.cc.u32 %2, %14, 0x1eabfffe, %3;\n\t"
        "madc.lo.cc.u32 %3, %14, 0xf6b0f624, %4;\n\t"
        "madc.lo.cc.u32 %4, %14, 0x6730d2a0, %5;\n\t"
        "madc.lo.cc.u32 %5, %14, 0xf38512bf, %6;\n\t"
        "madc.lo.cc.u32 %6, %14, 0x64774b84, %7;\n\t"
        "madc.lo.cc.u32 %7, %14, 0x434bacd7, %8;\n\t"
        "madc.lo.cc.u32 %8, %14, 0x4b1ba7b6, %9;\n\t"
        "madc.lo.cc.u32 %9, %14, 0x397fe69a, %10;\n\t"
        "madc.lo.cc.u32 %10, %14, 0x1a0111ea, %11;\n\t"
        "addc.cc.u32 %11, %12, 0;\n\t"
        "addc.u32 %12, %13, 0;\n\t"
        "mad.hi.cc.u32 %0, %14, 0xffffaaab, %0;\n\t"
        "madc.hi.cc.u32 %1, %14, 0xb9feffff, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, 0xb153ffff, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, 0x1eabfffe, %3;\n\t"
        "madc.hi.cc.u32 %4, %14, 0xf6b0f624, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, 0x6730d2a0, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, 0xf38512bf, %6;\n\t"
        "madc.hi.cc.u32 %7, %14, 0x64774b84, %7;\n\t"
        "madc.hi.cc.u32 %8, %14, 0x434bacd7, %8;\n\t"
        "madc.hi.cc.u32 %9, %14, 0x4b1ba7b6, %9;\n\t"
        "madc.hi.cc.u32 %10, %14, 0x397fe69a, %10;\n\t"
        "madc.hi.cc.u32 %11, %14, 0x1a0111ea, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "mov.u32 %13, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
          "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(m));
  }
  cond_sub<FpT>(r, t, t[12]);
}

__device__ __forceinline__ void fp_mul_small3(uint32_t* r, const uint32_t* a) {
  uint32_t d[12];
  add_mod<FpT>(d, a, a);
  add_mod<FpT>(r, a, d);
}

__device__ __forceinline__ void fp_mul_small8(uint32_t* r, const uint32_t* a) {
  add_mod<FpT>(r, a, a);
  add_mod<FpT>(r, r, r);
  add_mod<FpT>(r, r, r);
}

__device__ __forceinline__ void fp_mul_small12(uint32_t* r, const uint32_t* a) {
  uint32_t d4[12], d8[12];
  add_mod<FpT>(d4, a, a);
  add_mod<FpT>(d4, d4, d4);
  add_mod<FpT>(d8, d4, d4);
  add_mod<FpT>(r, d4, d8);
}

// r = p + q, with w two 12-word field elements of scratch.  Every read
// of p and q comes before the first write of r, so r may be p or q; w
// must be neither.  R is Words or Limbs.
template <class R>
__device__ __forceinline__ void ec_add(const R& r, const Words& p,
                                       const Words& q, const Words& w) {
  const Words y3 = w.at(0), op = w.at(1);
  uint32_t a[12], t0[12], t1[12], t2[12], t3[12];
  p.get(0, a);
  fp_mul(t0, a, q.at(0));           // X1 X2
  p.get(2, a);
  fp_mul(t2, a, q.at(2));           // Z1 Z2
  q.get_sum(0, 2, a);
  op.put(0, a);
  p.get_sum(0, 2, a);
  fp_mul(t3, a, op);
  add_mod<FpT>(a, t0, t2);
  sub_mod<FpT>(t3, t3, a);          // X1 Z2 + X2 Z1
  fp_mul_small12(t3, t3);
  y3.put(0, t3);                    // y3 = 3b (X1 Z2 + X2 Z1)
  p.get(1, a);
  fp_mul(t1, a, q.at(1));           // Y1 Y2
  q.get_sum(0, 1, a);
  op.put(0, a);
  p.get_sum(0, 1, a);
  fp_mul(t3, a, op);
  add_mod<FpT>(a, t0, t1);
  sub_mod<FpT>(t3, t3, a);          // X1 Y2 + X2 Y1
  fp_mul_small3(t0, t0);            // 3 X1 X2
  q.get_sum(1, 2, a);
  op.put(0, a);
  p.get_sum(1, 2, a);
  uint32_t s[12];
  fp_mul(s, a, op);
  add_mod<FpT>(a, t1, t2);
  sub_mod<FpT>(s, s, a);            // s = Y1 Z2 + Y2 Z1
  fp_mul_small12(t2, t2);           // 3b Z1 Z2
  add_mod<FpT>(a, t1, t2);          // z3 = Y1 Y2 + 3b Z1 Z2
  sub_mod<FpT>(t1, t1, t2);         // Y1 Y2 - 3b Z1 Z2
  // live: t0 = 3 X1 X2, t1, a = z3, t3, s; y3 in w
  // X3 = t3 t1 - s y3;  Y3 = t1 z3 + y3 t0;  Z3 = z3 s + t0 t3
  op.put(0, t1);
  fp_mul(t2, t3, op);
  fp_mul(t1, s, y3);                // t1 is in op
  sub_mod<FpT>(t2, t2, t1);
  r.put(0, t2);
  fp_mul(t2, a, op);                // z3 t1
  op.put(0, a);                     // z3
  fp_mul(a, t0, y3);
  add_mod<FpT>(t2, t2, a);
  r.put(1, t2);
  fp_mul(t2, s, op);                // s z3
  op.put(0, t3);
  fp_mul(a, t0, op);                // 3 X1 X2 t3
  add_mod<FpT>(t2, t2, a);
  r.put(2, t2);
}

// B6: p = 2 p in place, with w one 12-word field element of room for a
// temporary.
// Replaces tpukzg/pallas/ec.py::ec_double (RCB15 Alg. 9, a = 0,
// b3 = 12): 8 Montgomery products and products by 8, 12 and 3, no
// branches, correct for infinity and for points of order 2 (none on
// G1).  Each step computes the same field value as pallas/ec.py:103-122,
// so the output is bit-identical to the reference.  Doubling reads its
// inputs more than adding does (Y Y, Y Z, X Y), so X, Y and Z stay in
// shared memory until their last product, then their words take the
// temporaries that two products each read (8 Y^2, Y^2 + 3b Z^2) and the
// results; X Y waits in w.  At most four 12-word temporaries, one
// operand and one product's accumulator are live at once.
__device__ __forceinline__ void ec_double(const Words& p, const Words& w) {
  uint32_t a[12], t0[12], t1[12], t2[12];
  p.get(0, a);
  fp_mul(t0, a, p.at(1));           // X Y
  w.put(0, t0);
  p.get(1, a);
  fp_mul(t1, a, p.at(2));           // Y Z
  fp_mul(t0, a, p.at(1));           // Y^2
  p.get(2, a);
  fp_mul(t2, a, p.at(2));           // Z^2: the last read of X, Y, Z
  fp_mul_small12(t2, t2);           // 3b Z^2
  fp_mul_small8(a, t0);
  p.put(0, a);                      // 8 Y^2 in X's words
  add_mod<FpT>(a, t0, t2);
  p.put(1, a);                      // Y^2 + 3b Z^2 in Y's words
  fp_mul_small3(a, t2);
  sub_mod<FpT>(t0, t0, a);          // t6 = Y^2 - 9b Z^2
  fp_mul(t1, t1, p.at(0));          // Z3 = 8 Y^3 Z
  p.put(2, t1);
  fp_mul(t1, t2, p.at(0));          // 3b Z^2 8 Y^2
  fp_mul(t2, t0, p.at(1));          // t6 (Y^2 + 3b Z^2)
  add_mod<FpT>(t1, t2, t1);
  p.put(1, t1);                     // Y3
  fp_mul(t2, t0, w.at(0));          // t6 X Y
  add_mod<FpT>(t2, t2, t2);
  p.put(0, t2);                     // X3 = 2 t6 X Y
}

// B6 on four threads a point: p = 2 p, the same formula and field
// values as ec_double.  The eight products fall into two layers of four
// independent ones, so each thread of a quad (four neighbouring lanes of
// a warp, q = 0..3 its place in the quad) takes one product of each
// layer, with both operands in registers (field.cuh's mont_mul):
//   layer 1: q0 Y^2, q1 Y Z, q2 Z^2, q3 X Y;
//   layer 2: q0 3b Z^2 8 Y^2, q1 Y Z 8 Y^2 (Z3), q2 t6 (Y^2 + 3b Z^2),
//            q3 t6 X Y (X3 / 2), with t6 = Y^2 - 9b Z^2.
// Y^2 and Z^2 reach the whole quad by warp shuffles, every thread makes
// the small steps between the layers itself, and the four layer-2
// products reach the whole quad the same way, so each thread ends with
// the whole point (X, Y, Z in registers, 12 words each) for the next
// doubling.  A doubling's chain of dependent work is two products and
// the small steps, not eight products.  All 32 lanes of the warp must
// call it together (the shuffles name the whole warp).
__device__ __forceinline__ void ec_double_quad(uint32_t* X, uint32_t* Y,
                                               uint32_t* Z, int q) {
  constexpr unsigned kAll = 0xffffffffu;
  uint32_t a[12], b[12], mine[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    a[j] = q == 2 ? Z[j] : (q == 3 ? X[j] : Y[j]);
    b[j] = (q == 0 || q == 3) ? Y[j] : Z[j];
  }
  mont_mul<FpT>(mine, a, b);        // Y^2, Y Z, Z^2, X Y
  uint32_t t0[12], t2[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    t0[j] = __shfl_sync(kAll, mine[j], 0, 4);     // Y^2
    t2[j] = __shfl_sync(kAll, mine[j], 2, 4);     // Z^2
  }
  fp_mul_small12(t2, t2);           // 3b Z^2
  fp_mul_small8(X, t0);             // 8 Y^2 (X is dead)
  add_mod<FpT>(Y, t0, t2);          // Y^2 + 3b Z^2 (Y is dead)
  fp_mul_small3(Z, t2);
  sub_mod<FpT>(t0, t0, Z);          // t6 = Y^2 - 9b Z^2
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    a[j] = q == 0 ? t2[j] : (q == 1 ? mine[j] : t0[j]);
    b[j] = q <= 1 ? X[j] : (q == 2 ? Y[j] : mine[j]);
  }
  mont_mul<FpT>(mine, a, b);
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    a[j] = __shfl_sync(kAll, mine[j], 0, 4);      // 3b Z^2 8 Y^2
    b[j] = __shfl_sync(kAll, mine[j], 2, 4);      // t6 (Y^2 + 3b Z^2)
    X[j] = __shfl_sync(kAll, mine[j], 3, 4);      // t6 X Y
    Z[j] = __shfl_sync(kAll, mine[j], 1, 4);      // Z3 = 8 Y^3 Z
  }
  add_mod<FpT>(Y, b, a);            // Y3
  add_mod<FpT>(X, X, X);            // X3 = 2 t6 X Y
}

}  // namespace tk
