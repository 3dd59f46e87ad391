// B2: complete projective addition on G1: y^2 = x^3 + 4 over Fp, and
// B6: complete projective doubling (ec_double and ec_double_quad); their
// G2 instances over Fp2 (ec_add_g2, ec_double_g2), and the curve traits
// G1 and G2 that the bucket kernels take (at the end of this file).
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


// ---------------------------------------------------------------------
// G2: y^2 = x^3 + 4 (1 + u) over Fp2 = Fp[u] / (u^2 + 1), b3 = 12 (1 + u).
//
// The same formulas as B2 and B6 (RCB15 Alg. 7 and 9, a = 0), each Fp2
// product by Karatsuba: three Fp products, a0 b0, a1 b1 and
// (a0 + a1)(b0 + b1); a square by two, (a0 + a1)(a0 - a1) and a0 a1.
// Every field result is canonical, so each coordinate equals the plain
// version's (kernels/ec.py over FP2_LM) bit for bit.
//
// A G2 point is 72 words, an add's temporaries six Fp2 values, so
// neither fits in registers beside a product's working set: the point
// lives in shared memory as a Words of six Fp elements (X.c0, X.c1,
// Y.c0, Y.c1, Z.c0, Z.c1; Fp2 coordinate c is the Words at element 2c),
// and so does every Fp2 temporary (kG2Scratch words a thread).
//
// What bounds a G2 kernel is the latency of one thread's chain of
// products: a row of fp_mul is two carry chains of ~26 dependent
// multiply-adds, and an SM holds only four warps of G2 points (their
// shared memory), too few to hide it.  So the three products of an Fp2
// product (two of a square) run as one fp_mul_n: each row issues the
// products' chains together and the scheduler interleaves them, so an
// Fp2 product costs about the latency of one Fp product, not three.
constexpr int kG2Words = 72;
// six Fp2 temporaries and one Fp operand (b0 + b1 of a product)
constexpr int kG2Scratch = 6 * 24 + 12;

// K independent products r[k] = a[k] b[k] R^-1 mod p, b[k] read from
// shared memory: fp_mul's rows (the same PTX, held equal to fp_mul's by
// tests/test_torch_g2_msm.py, so each result is bit-identical to
// fp_mul's and utils/checked.py's shadow of fp_mul holds for it), the K
// products' rows issued together.
template <int K>
__device__ __forceinline__ void fp_mul_n(uint32_t (&r)[K][12],
                                         const uint32_t (&a)[K][12],
                                         const Words (&b)[K]) {
  uint32_t t[K][14];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 14; ++j) t[k][j] = 0;
#pragma unroll 1
  for (int i = 0; i < 12; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t bi = b[k].p[i * b[k].stride];
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
          : "+r"(t[k][0]), "+r"(t[k][1]), "+r"(t[k][2]), "+r"(t[k][3]),
            "+r"(t[k][4]), "+r"(t[k][5]), "+r"(t[k][6]), "+r"(t[k][7]),
            "+r"(t[k][8]), "+r"(t[k][9]), "+r"(t[k][10]), "+r"(t[k][11]),
            "+r"(t[k][12]), "+r"(t[k][13])
          : "r"(a[k][0]), "r"(a[k][1]), "r"(a[k][2]), "r"(a[k][3]),
            "r"(a[k][4]), "r"(a[k][5]), "r"(a[k][6]), "r"(a[k][7]),
            "r"(a[k][8]), "r"(a[k][9]), "r"(a[k][10]), "r"(a[k][11]),
            "r"(bi));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t m = t[k][0] * FpT::INV;
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
          : "+r"(t[k][0]), "+r"(t[k][1]), "+r"(t[k][2]), "+r"(t[k][3]),
            "+r"(t[k][4]), "+r"(t[k][5]), "+r"(t[k][6]), "+r"(t[k][7]),
            "+r"(t[k][8]), "+r"(t[k][9]), "+r"(t[k][10]), "+r"(t[k][11]),
            "+r"(t[k][12]), "+r"(t[k][13])
          : "r"(m));
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) cond_sub<FpT>(r[k], t[k], t[k][12]);
}

// An Fp2 operand read from shared memory: component k (0, 1).
struct Fp2At {
  Words a;
  __device__ __forceinline__ void get(int k, uint32_t* w) const {
    a.get(k, w);
  }
};

// The sum of Fp2 coordinates i and j of a G2 point, read on the fly.
struct Fp2Sum {
  Words p;
  int i, j;
  __device__ __forceinline__ void get(int k, uint32_t* w) const {
    p.get_sum(2 * i + k, 2 * j + k, w);
  }
};

// (c0, c1) = a b in Fp2, b in shared memory (elements 0, 1), k one Fp
// element of scratch, neither a nor b: a0 b0, a1 b1 and
// (a0 + a1)(b0 + b1) as one fp_mul_n.
template <class A>
__device__ __forceinline__ void fp2_mul(uint32_t* c0, uint32_t* c1,
                                        const A& a, const Words& b,
                                        const Words& k) {
  uint32_t x[3][12], y[3][12];
  b.get_sum(0, 1, x[0]);
  k.put(0, x[0]);                   // b0 + b1
  a.get(0, x[0]);
  a.get(1, x[1]);
  add_mod<FpT>(x[2], x[0], x[1]);   // a0 + a1
  const Words bs[3] = {b.at(0), b.at(1), k};
  fp_mul_n<3>(y, x, bs);
  sub_mod<FpT>(y[2], y[2], y[0]);
  sub_mod<FpT>(c1, y[2], y[1]);
  sub_mod<FpT>(c0, y[0], y[1]);
}

// (c0, c1) = a^2 in Fp2: ((a0 + a1)(a0 - a1), 2 a0 a1), as one
// fp_mul_n of two; k as fp2_mul's.
__device__ __forceinline__ void fp2_sqr(uint32_t* c0, uint32_t* c1,
                                        const Words& a, const Words& k) {
  uint32_t x[2][12], y[2][12];
  a.get(0, x[1]);                   // a0
  a.get(1, y[0]);
  sub_mod<FpT>(y[1], x[1], y[0]);
  k.put(0, y[1]);                   // a0 - a1
  add_mod<FpT>(x[0], x[1], y[0]);   // a0 + a1
  const Words bs[2] = {k, a.at(1)};
  fp_mul_n<2>(y, x, bs);
  copy<FpT>(c0, y[0]);
  add_mod<FpT>(c1, y[1], y[1]);     // 2 a0 a1
}

__device__ __forceinline__ void fp2_put(const Words& r, const uint32_t* c0,
                                        const uint32_t* c1) {
  r.put(0, c0);
  r.put(1, c1);
}

// (c0, c1) = 3b (c0, c1) = 12 (c0 - c1) + 12 (c0 + c1) u
__device__ __forceinline__ void fp2_mul_b3(uint32_t* c0, uint32_t* c1) {
  uint32_t t[12];
  sub_mod<FpT>(t, c0, c1);
  add_mod<FpT>(c1, c0, c1);
  fp_mul_small12(c0, t);
  fp_mul_small12(c1, c1);
}

// (c0, c1) -= the Fp2 values a and b in shared memory
__device__ __forceinline__ void fp2_sub2(uint32_t* c0, uint32_t* c1,
                                         const Words& a, const Words& b) {
  uint32_t t[12];
  a.get(0, t);
  sub_mod<FpT>(c0, c0, t);
  b.get(0, t);
  sub_mod<FpT>(c0, c0, t);
  a.get(1, t);
  sub_mod<FpT>(c1, c1, t);
  b.get(1, t);
  sub_mod<FpT>(c1, c1, t);
}

// (c0, c1) += the Fp2 value a in shared memory
__device__ __forceinline__ void fp2_add_from(uint32_t* c0, uint32_t* c1,
                                             const Words& a) {
  uint32_t t[12];
  a.get(0, t);
  add_mod<FpT>(c0, c0, t);
  a.get(1, t);
  add_mod<FpT>(c1, c1, t);
}

// Fp2 r = coordinates i + j of the point p
__device__ __forceinline__ void fp2_put_sum(const Words& r, const Words& p,
                                            int i, int j) {
  uint32_t t[12];
  p.get_sum(2 * i, 2 * j, t);
  r.put(0, t);
  p.get_sum(2 * i + 1, 2 * j + 1, t);
  r.put(1, t);
}

__device__ __forceinline__ void g2_copy(const Words& d, const Words& s) {
#pragma unroll 8
  for (int w = 0; w < kG2Words; ++w) d.p[w * d.stride] = s.p[w * s.stride];
}

__device__ __forceinline__ void g2_set_inf(const Words& d) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    d.p[j * d.stride] = 0u;
    d.p[(12 + j) * d.stride] = 0u;
    d.p[(24 + j) * d.stride] = kFpOne[j];
    d.p[(36 + j) * d.stride] = 0u;
    d.p[(48 + j) * d.stride] = 0u;
    d.p[(60 + j) * d.stride] = 0u;
  }
}

// A G2 point in device memory: coordinates x, y, z of 48 16-bit limbs
// (c0's 24, then c1's), limb i at i * ls.  Element e of the point (as
// in shared memory) is coordinate e / 2, component e % 2.
struct Limbs2 {
  int32_t* x;
  int32_t* y;
  int32_t* z;
  long long ls;
  __device__ __forceinline__ void put(int e, const uint32_t* w) const {
    int32_t* q = (e < 2 ? x : (e < 4 ? y : z)) + (e & 1) * 24 * ls;
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
#pragma unroll 1
    for (int e = 0; e < 6; ++e) {
      s.get(e, w);
      put(e, w);
    }
  }
};

__device__ __forceinline__ void load_point_g2(const Words& d,
                                              const int32_t* x,
                                              const int32_t* y,
                                              const int32_t* z,
                                              long long ls) {
#pragma unroll 1
  for (int e = 0; e < 6; ++e) {
    const int32_t* q = (e < 2 ? x : (e < 4 ? y : z)) + (e & 1) * 24 * ls;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      d.p[(12 * e + j) * d.stride] =
          ((uint32_t)q[0] & 0xffffu) | ((uint32_t)q[ls] << 16);
      q += 2 * ls;
      asm volatile("" : "+l"(q));
    }
  }
}

// r = p + q on G2 (RCB15 Alg. 7), w kG2Scratch words of scratch.  Every
// read of p and q comes before the first write of r, so r may be p or q;
// w must be neither.  R is Words or Limbs2.  The scratch's six Fp2 slots
// hold, in the end, A = 3 X1 X2, B = z3 = Y1 Y2 + 3b Z1 Z2,
// C = y3 = 3b (X1 Z2 + X2 Z1), D = Y1 Y2 - 3b Z1 Z2, E = X1 Y2 + X2 Y1
// and F = Y1 Z2 + Y2 Z1.
template <class R>
__device__ __forceinline__ void ec_add_g2(const R& r, const Words& p,
                                          const Words& q, const Words& w) {
  const Words A = w.at(0), B = w.at(2), C = w.at(4), D = w.at(6);
  const Words E = w.at(8), F = w.at(10), k = w.at(12);
  uint32_t c0[12], c1[12];
  fp2_mul(c0, c1, Fp2At{p.at(0)}, q.at(0), k);
  fp2_put(A, c0, c1);               // X1 X2
  fp2_mul(c0, c1, Fp2At{p.at(4)}, q.at(4), k);
  fp2_put(B, c0, c1);               // Z1 Z2
  fp2_put_sum(D, q, 0, 2);
  fp2_mul(c0, c1, Fp2Sum{p, 0, 2}, D, k);
  fp2_sub2(c0, c1, A, B);           // X1 Z2 + X2 Z1
  fp2_mul_b3(c0, c1);
  fp2_put(C, c0, c1);               // y3
  fp2_mul(c0, c1, Fp2At{p.at(2)}, q.at(2), k);
  fp2_put(D, c0, c1);               // Y1 Y2
  fp2_put_sum(F, q, 0, 1);
  fp2_mul(c0, c1, Fp2Sum{p, 0, 1}, F, k);
  fp2_sub2(c0, c1, A, D);
  fp2_put(E, c0, c1);               // X1 Y2 + X2 Y1
  fp2_put_sum(F, q, 1, 2);
  fp2_mul(c0, c1, Fp2Sum{p, 1, 2}, F, k);   // the last read of p and q
  fp2_sub2(c0, c1, D, B);
  fp2_put(F, c0, c1);               // Y1 Z2 + Y2 Z1
  uint32_t u0[12], u1[12];
#pragma unroll 1
  for (int e = 0; e < 2; ++e) {
    A.get(e, c0);
    fp_mul_small3(c0, c0);
    A.put(e, c0);                   // 3 X1 X2
  }
  B.get(0, c0);
  B.get(1, c1);
  fp2_mul_b3(c0, c1);               // 3b Z1 Z2
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    D.get(e, u0);
    add_mod<FpT>(u1, u0, e ? c1 : c0);
    B.put(e, u1);                   // z3
    sub_mod<FpT>(u0, u0, e ? c1 : c0);
    D.put(e, u0);                   // Y1 Y2 - 3b Z1 Z2
  }
  // X3 = E D - F C;  Y3 = D B + C A;  Z3 = B F + A E
  fp2_mul(u0, u1, Fp2At{E}, D, k);
  fp2_mul(c0, c1, Fp2At{F}, C, k);
  sub_mod<FpT>(u0, u0, c0);
  sub_mod<FpT>(u1, u1, c1);
  r.put(0, u0);
  r.put(1, u1);
  fp2_mul(u0, u1, Fp2At{D}, B, k);
  fp2_mul(c0, c1, Fp2At{C}, A, k);
  add_mod<FpT>(u0, u0, c0);
  add_mod<FpT>(u1, u1, c1);
  r.put(2, u0);
  r.put(3, u1);
  fp2_mul(u0, u1, Fp2At{B}, F, k);
  fp2_mul(c0, c1, Fp2At{A}, E, k);
  add_mod<FpT>(u0, u0, c0);
  add_mod<FpT>(u1, u1, c1);
  r.put(4, u0);
  r.put(5, u1);
}

// p = 2 p on G2 in place (RCB15 Alg. 9), w at least 108 words of
// scratch (four Fp2 slots and one Fp operand), not p.  X, Y and Z are
// read by the first four products; then p's words take 8 Y^2, Y^2 +
// 3b Z^2 and the results.
__device__ __forceinline__ void ec_double_g2(const Words& p,
                                             const Words& w) {
  const Words A = w.at(0), B = w.at(2), C = w.at(4), D = w.at(6);
  const Words k = w.at(8);
  const Words X = p.at(0), Y = p.at(2), Z = p.at(4);
  uint32_t c0[12], c1[12];
  fp2_mul(c0, c1, Fp2At{X}, Y, k);
  fp2_put(A, c0, c1);               // X Y
  fp2_mul(c0, c1, Fp2At{Y}, Z, k);
  fp2_put(B, c0, c1);               // Y Z
  fp2_sqr(c0, c1, Y, k);
  fp2_put(C, c0, c1);               // Y^2
  fp2_sqr(c0, c1, Z, k);            // Z^2: the last read of X, Y, Z
  fp2_mul_b3(c0, c1);
  fp2_put(D, c0, c1);               // 3b Z^2
#pragma unroll 1
  for (int e = 0; e < 2; ++e) {
    uint32_t y2[12], t[12];
    C.get(e, y2);
    fp_mul_small8(t, y2);
    X.put(e, t);                    // 8 Y^2 in X's words
    D.get(e, t);
    add_mod<FpT>(c0, y2, t);
    Y.put(e, c0);                   // Y^2 + 3b Z^2 in Y's words
    fp_mul_small3(t, t);
    sub_mod<FpT>(y2, y2, t);
    C.put(e, y2);                   // t6 = Y^2 - 9b Z^2
  }
  fp2_mul(c0, c1, Fp2At{B}, X, k);
  fp2_put(Z, c0, c1);               // Z3 = 8 Y^3 Z
  fp2_mul(c0, c1, Fp2At{D}, X, k);
  fp2_put(B, c0, c1);               // 3b Z^2 8 Y^2
  fp2_mul(c0, c1, Fp2At{C}, Y, k);  // t6 (Y^2 + 3b Z^2)
  fp2_add_from(c0, c1, B);
  fp2_put(Y, c0, c1);               // Y3
  fp2_mul(c0, c1, Fp2At{C}, A, k);  // t6 X Y
  add_mod<FpT>(c0, c0, c0);
  add_mod<FpT>(c1, c1, c1);
  fp2_put(X, c0, c1);               // X3 = 2 t6 X Y
}

// The curves the bucket kernels (bucket.cu) take: a point's words in
// shared memory, the scratch its add takes, and its add, load, store,
// copy and infinity.  G1 is B2 and B6 as above, G2 their Fp2 instances.
struct G1 {
  static constexpr int kW = 36;
  static constexpr int kScratch = 24;
  static constexpr bool kQuad = true;   // doublings by ec_double_quad
  using Out = Limbs;
  template <class R>
  __device__ static __forceinline__ void add(const R& r, const Words& p,
                                             const Words& q,
                                             const Words& w) {
    ec_add(r, p, q, w);
  }
  __device__ static __forceinline__ void load(const Words& d,
                                              const int32_t* x,
                                              const int32_t* y,
                                              const int32_t* z,
                                              long long ls) {
    load_point(d, x, y, z, ls);
  }
  __device__ static __forceinline__ void copy(const Words& d,
                                              const Words& s) {
    d.copy_from(s);
  }
  __device__ static __forceinline__ void set_inf(const Words& d) {
    d.set_inf();
  }
};

struct G2 {
  static constexpr int kW = kG2Words;
  static constexpr int kScratch = kG2Scratch;
  static constexpr bool kQuad = false;  // doublings by ec_double_g2
  using Out = Limbs2;
  template <class R>
  __device__ static __forceinline__ void add(const R& r, const Words& p,
                                             const Words& q,
                                             const Words& w) {
    ec_add_g2(r, p, q, w);
  }
  __device__ static __forceinline__ void load(const Words& d,
                                              const int32_t* x,
                                              const int32_t* y,
                                              const int32_t* z,
                                              long long ls) {
    load_point_g2(d, x, y, z, ls);
  }
  __device__ static __forceinline__ void copy(const Words& d,
                                              const Words& s) {
    g2_copy(d, s);
  }
  __device__ static __forceinline__ void set_inf(const Words& d) {
    g2_set_inf(d);
  }
  __device__ static __forceinline__ void dbl(const Words& p,
                                             const Words& w) {
    ec_double_g2(p, w);
  }
};

}  // namespace tk
