// secp256k1 field arithmetic and the per-lane math of the BSGS walk
// kernels (native/walk_kernels.cu). Plain C++ with 32-bit limbs and
// 64-bit products; compiled for the device by nvcc and for the host by
// the C++ compiler (native/keyhunt_host.cpp exports a host reference of
// both kernels, which the CPU tests compare with python's ecref).
//
// Field elements: 8 little-endian uint32 limbs, canonical (< p).
// Multi-element arrays are limb-major: limb k of element i at k*n + i.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define KH_HD __host__ __device__ __forceinline__
#define KH_UNROLL _Pragma("unroll")
#else
#define KH_HD static inline
#define KH_UNROLL
#endif

namespace khw {

typedef uint32_t u32;
typedef uint64_t u64;

// p = 2^256 - 2^32 - 977, so 2^256 = 2^32 + 977 (mod p)
static const u32 FOLD = 977u;

KH_HD void copy(u32 r[8], const u32 a[8]) {
KH_UNROLL
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

KH_HD void set_one(u32 r[8]) {
  r[0] = 1;
KH_UNROLL
  for (int i = 1; i < 8; i++) r[i] = 0;
}

KH_HD bool is_zero(const u32 a[8]) {
  u32 acc = 0;
KH_UNROLL
  for (int i = 0; i < 8; i++) acc |= a[i];
  return acc == 0;
}

KH_HD void select(u32 r[8], bool take_a, const u32 a[8], const u32 b[8]) {
KH_UNROLL
  for (int i = 0; i < 8; i++) r[i] = take_a ? a[i] : b[i];
}

// r (< 2^256) -> r mod p, given the carry-out `top` of the sum that
// produced r (top = 1 means the value was r + 2^256).
KH_HD void finish(u32 r[8], u32 top) {
  // r + 2^256 - p = r + (2^32 + 977): carry-out <=> r >= p
  u32 d[8];
  u64 c = (u64)r[0] + FOLD;
  d[0] = (u32)c;
  c = (c >> 32) + (u64)r[1] + 1u;
  d[1] = (u32)c;
  c >>= 32;
KH_UNROLL
  for (int i = 2; i < 8; i++) {
    c += r[i];
    d[i] = (u32)c;
    c >>= 32;
  }
  bool take = (top | (u32)c) != 0;
  select(r, take, d, r);
}

// 512-bit product t -> t mod p
KH_HD void reduce512(u32 r[8], const u32 t[16]) {
  // fold 1: s = L + H*977 + H*2^32 (9 limbs; top < 2^34)
  u32 s[8];
  u64 c = 0;
KH_UNROLL
  for (int i = 0; i < 8; i++) {
    c += (u64)t[i] + (u64)t[8 + i] * FOLD;
    if (i > 0) c += t[7 + i];
    s[i] = (u32)c;
    c >>= 32;
  }
  u64 h = c + t[15];
  // fold 2: r = s + h*(2^32 + 977); h*977 < 2^44
  u64 hm = h * FOLD;
  c = (u64)s[0] + (u32)hm;
  r[0] = (u32)c;
  c = (c >> 32) + (u64)s[1] + (hm >> 32) + (u32)h;
  r[1] = (u32)c;
  c = (c >> 32) + (u64)s[2] + (h >> 32);
  r[2] = (u32)c;
  c >>= 32;
KH_UNROLL
  for (int i = 3; i < 8; i++) {
    c += s[i];
    r[i] = (u32)c;
    c >>= 32;
  }
  // a carry here leaves r < 2^67: folding it once more cannot carry
  u32 top = (u32)c;
  c = (u64)r[0] + (top ? FOLD : 0u);
  r[0] = (u32)c;
  c = (c >> 32) + (u64)r[1] + top;
  r[1] = (u32)c;
  c >>= 32;
KH_UNROLL
  for (int i = 2; i < 8; i++) {
    c += r[i];
    r[i] = (u32)c;
    c >>= 32;
  }
  finish(r, 0);
}

KH_HD void mul(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[16];
KH_UNROLL
  for (int i = 0; i < 16; i++) t[i] = 0;
KH_UNROLL
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
KH_UNROLL
    for (int j = 0; j < 8; j++) {
      c += (u64)a[i] * b[j] + t[i + j];
      t[i + j] = (u32)c;
      c >>= 32;
    }
    t[i + 8] = (u32)c;
  }
  reduce512(r, t);
}

KH_HD void sqr(u32 r[8], const u32 a[8]) { mul(r, a, a); }

KH_HD void add(u32 r[8], const u32 a[8], const u32 b[8]) {
  u64 c = 0;
KH_UNROLL
  for (int i = 0; i < 8; i++) {
    c += (u64)a[i] + b[i];
    r[i] = (u32)c;
    c >>= 32;
  }
  finish(r, (u32)c);
}

KH_HD void sub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u64 br = 0;
KH_UNROLL
  for (int i = 0; i < 8; i++) {
    u64 t = (u64)a[i] - b[i] - br;
    r[i] = (u32)t;
    br = t >> 63;
  }
  // on borrow the wrap added 2^256; adding p back = subtracting 2^32+977
  u32 d[8];
  u64 t = (u64)r[0] - FOLD;
  d[0] = (u32)t;
  u64 b2 = t >> 63;
  t = (u64)r[1] - 1u - b2;
  d[1] = (u32)t;
  b2 = t >> 63;
KH_UNROLL
  for (int i = 2; i < 8; i++) {
    t = (u64)r[i] - b2;
    d[i] = (u32)t;
    b2 = t >> 63;
  }
  select(r, br != 0, d, r);
}

KH_HD void sqr_n(u32 r[8], const u32 a[8], int n) {
  copy(r, a);
  for (int i = 0; i < n; i++) sqr(r, r);
}

// a^(p-2): the standard secp256k1 addition chain (255 squarings, 15
// multiplies); maps 0 -> 0.
KH_HD void inv(u32 r[8], const u32 a[8]) {
  u32 x2[8], x3[8], x6[8], x9[8], x11[8], x22[8], x44[8], x88[8], t[8];
  sqr_n(t, a, 1);    mul(x2, t, a);
  sqr_n(t, x2, 1);   mul(x3, t, a);
  sqr_n(t, x3, 3);   mul(x6, t, x3);
  sqr_n(t, x6, 3);   mul(x9, t, x3);
  sqr_n(t, x9, 2);   mul(x11, t, x2);
  sqr_n(t, x11, 11); mul(x22, t, x11);
  sqr_n(t, x22, 22); mul(x44, t, x22);
  sqr_n(t, x44, 44); mul(x88, t, x44);
  sqr_n(t, x88, 88); mul(t, t, x88);     // x176
  sqr_n(t, t, 44);   mul(t, t, x44);     // x220
  sqr_n(t, t, 3);    mul(t, t, x3);      // x223
  // p - 2 = (2^223 - 1)*2^33 + 0x1_FFFFFC2D
  sqr_n(t, t, 23);   mul(t, t, x22);
  sqr_n(t, t, 5);    mul(t, t, a);
  sqr_n(t, t, 3);    mul(t, t, x2);
  sqr_n(t, t, 2);    mul(r, t, a);
}

KH_HD void load(u32 r[8], const u32* src, long n, long i) {
KH_UNROLL
  for (int k = 0; k < 8; k++) r[k] = src[k * n + i];
}

KH_HD void store(u32* dst, long n, long i, const u32 a[8]) {
KH_UNROLL
  for (int k = 0; k < 8; k++) dst[k * n + i] = a[k];
}

// Kernel A lane: (x3, y3) = P + Q with its own inversion. P == Q takes
// the doubling slope 3x^2 / 2y; P == -Q is the point at infinity
// (returned true; x3, y3 are then meaningless).
KH_HD bool add_full(u32 x3[8], u32 y3[8], const u32 px[8], const u32 py[8],
                    const u32 qx[8], const u32 qy[8]) {
  u32 dx[8], dy[8], xx[8], t[8], den[8], num[8], one[8], lam[8];
  sub(dx, qx, px);
  sub(dy, qy, py);
  bool dx0 = is_zero(dx);
  bool dbl = dx0 && is_zero(dy);
  set_one(one);
  select(den, dx0, one, dx);
  add(t, py, py);
  select(den, dbl, t, den);
  sqr(xx, px);
  add(t, xx, xx);
  add(t, t, xx);
  select(num, dbl, t, dy);
  inv(t, den);
  mul(lam, num, t);
  sqr(t, lam);
  sub(t, t, px);
  sub(x3, t, qx);
  sub(t, px, x3);
  mul(t, lam, t);
  sub(y3, t, py);
  return dx0 && !dbl;
}

// Kernel B lane: offsets tx/ty (one table entry u) against bases
// b0 .. b0+chain-1; one Montgomery chain, one inversion. Writes the
// 64-bit x truncation of base_b + u*S and the degenerate flag (x(base)
// == x(u*S): denominator zero, masked to 1, x meaningless) at row b.
// pre: chain x 8 scratch words for the exclusive prefix products.
KH_HD void walk_chain(const u32* bx, const u32* by, long nb, const u32 tx[8],
                      const u32 ty[8], long u, long lane, long b0, int chain,
                      u32 (*pre)[8], u32* qlo, u32* qhi, uint8_t* deg) {
  u32 acc[8], bxl[8], dx[8], one[8];
  set_one(one);
  set_one(acc);
  for (int g = 0; g < chain; g++) {
    long b = b0 + g;
    load(bxl, bx, nb, b);
    sub(dx, tx, bxl);
    bool d0 = is_zero(dx);
    select(dx, d0, one, dx);
    deg[b * u + lane] = d0 ? 1 : 0;
    copy(pre[g], acc);
    mul(acc, acc, dx);
  }
  u32 run[8], byl[8], invb[8], lam[8], t[8];
  inv(run, acc);
  for (int g = chain - 1; g >= 0; g--) {
    long b = b0 + g;
    load(bxl, bx, nb, b);
    load(byl, by, nb, b);
    sub(dx, tx, bxl);
    select(dx, is_zero(dx), one, dx);
    mul(invb, run, pre[g]);
    mul(run, run, dx);
    sub(t, ty, byl);
    mul(lam, t, invb);
    sqr(t, lam);
    sub(t, t, bxl);
    sub(t, t, tx);
    qlo[b * u + lane] = t[0];
    qhi[b * u + lane] = t[1];
  }
}

}  // namespace khw
