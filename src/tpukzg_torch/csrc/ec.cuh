// B2: complete projective addition on G1: y^2 = x^3 + 4 over Fp.
//
// Replaces the device function tpukzg/pallas/ec.py::ec_add (Renes-
// Costello-Batina 2015, Alg. 7, a = 0, b3 = 3b = 12): 12 Montgomery
// products, no branches, correct for P = Q, P = -Q and infinity.  The
// steps follow pallas/ec.py:71-100 one for one; every field result is
// canonical, so the output is bit-identical to the reference.
//
// What bounds it inside a kernel: integer multiplies (12 Fp products,
// about 3,600 word products per add) and register pressure: two input
// points are 72 words.  The formula is ordered so that few 12-word
// temporaries are live at once.
#pragma once

#include "field.cuh"

namespace tk {

struct G1 {
  uint32_t x[12], y[12], z[12];
};

__device__ __forceinline__ void fp_mul_small3(uint32_t* r, const uint32_t* a) {
  uint32_t d[12];
  add_mod<FpT>(d, a, a);
  add_mod<FpT>(r, a, d);
}

__device__ __forceinline__ void fp_mul_small12(uint32_t* r, const uint32_t* a) {
  uint32_t d4[12], d8[12];
  add_mod<FpT>(d4, a, a);
  add_mod<FpT>(d4, d4, d4);
  add_mod<FpT>(d8, d4, d4);
  add_mod<FpT>(r, d4, d8);
}

// r = p + q.  r may alias p or q.
__device__ __forceinline__ void ec_add(G1& r, const G1& p, const G1& q) {
  uint32_t t0[12], t1[12], t2[12], t3[12], t4[12], t5[12], u[12], v[12];
  mont_mul<FpT>(t0, p.x, q.x);
  mont_mul<FpT>(t1, p.y, q.y);
  mont_mul<FpT>(t2, p.z, q.z);
  add_mod<FpT>(u, p.x, p.y);
  add_mod<FpT>(v, q.x, q.y);
  mont_mul<FpT>(t3, u, v);
  add_mod<FpT>(u, p.y, p.z);
  add_mod<FpT>(v, q.y, q.z);
  mont_mul<FpT>(t4, u, v);
  add_mod<FpT>(u, p.x, p.z);
  add_mod<FpT>(v, q.x, q.z);
  mont_mul<FpT>(t5, u, v);
  add_mod<FpT>(u, t0, t1);
  sub_mod<FpT>(t3, t3, u);          // X1 Y2 + X2 Y1
  add_mod<FpT>(u, t1, t2);
  sub_mod<FpT>(t4, t4, u);          // Y1 Z2 + Y2 Z1
  add_mod<FpT>(u, t0, t2);
  sub_mod<FpT>(t5, t5, u);          // X1 Z2 + X2 Z1
  fp_mul_small3(t0, t0);            // 3 X1 X2
  fp_mul_small12(t2, t2);           // 3b Z1 Z2
  uint32_t z3[12], y3[12];
  add_mod<FpT>(z3, t1, t2);         // Y1 Y2 + 3b Z1 Z2
  sub_mod<FpT>(t1, t1, t2);         // Y1 Y2 - 3b Z1 Z2
  fp_mul_small12(y3, t5);           // 3b (X1 Z2 + X2 Z1)
  // X3 = t3 t1 - t4 y3;  Y3 = t1 z3 + y3 t0;  Z3 = z3 t4 + t0 t3
  mont_mul<FpT>(u, t4, y3);
  mont_mul<FpT>(v, t3, t1);
  sub_mod<FpT>(r.x, v, u);
  mont_mul<FpT>(u, y3, t0);
  mont_mul<FpT>(v, t1, z3);
  add_mod<FpT>(r.y, v, u);
  mont_mul<FpT>(u, t0, t3);
  mont_mul<FpT>(v, z3, t4);
  add_mod<FpT>(r.z, v, u);
}

}  // namespace tk
