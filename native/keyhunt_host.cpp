// Native host-side support library (C++17, no external deps).
//
// The framework keeps its device compute in JAX/XLA and the CUDA walk
// kernels (walk_kernels.cu); this library is the
// native runtime around it — the role the reference's C++ layers play on
// host: exact secp256k1 verification (reference secp256k1/Int*.cpp,
// SECP256K1.cpp), SHA-256 / RIPEMD-160 (reference hash/), and base58
// (reference base58/base58.c). All code written from the public
// specifications; nothing is translated from the reference sources.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image):
//   kh_sha256(msg, len, out32)
//   kh_hash160_batch(msgs, stride, count, out20s)
//   kh_b58check_decode(str, out25) -> payload length or -1
//   kh_verify_candidates(keys_be32[], n, mode, target20/32, results[])
//   kh_scalar_mult(key_be32, out_x32, out_y32)
//
// Build: make -C native   (produces libkeyhunt_host.so)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "walk_math.h"

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4)
// ---------------------------------------------------------------------------

namespace sha {

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static void compress(uint32_t h[8], const uint8_t block[64]) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(block[4 * i]) << 24) | (uint32_t(block[4 * i + 1]) << 16) |
           (uint32_t(block[4 * i + 2]) << 8) | uint32_t(block[4 * i + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6],
           hh = h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = hh + s1 + ch + K[i] + w[i];
    uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = s0 + maj;
    hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

static void sha256(const uint8_t* msg, size_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t off = 0;
  for (; off + 64 <= len; off += 64) compress(h, msg + off);
  uint8_t block[128] = {0};
  size_t rem = len - off;
  memcpy(block, msg + off, rem);
  block[rem] = 0x80;
  size_t total = (rem + 9 <= 64) ? 64 : 128;
  uint64_t bits = uint64_t(len) * 8;
  for (int i = 0; i < 8; i++) block[total - 1 - i] = uint8_t(bits >> (8 * i));
  compress(h, block);
  if (total == 128) compress(h, block + 64);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 4; j++) out[4 * i + j] = uint8_t(h[i] >> (24 - 8 * j));
}

}  // namespace sha

// ---------------------------------------------------------------------------
// RIPEMD-160 (Dobbertin/Bosselaers/Preneel 1996)
// ---------------------------------------------------------------------------

namespace rmd {

static const int R1[80] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
static const int R2[80] = {
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
static const int S1[80] = {
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
static const int S2[80] = {
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};
static const uint32_t KK1[5] = {0x00000000, 0x5a827999, 0x6ed9eba1, 0x8f1bbcdc, 0xa953fd4e};
static const uint32_t KK2[5] = {0x50a28be6, 0x5c4dd124, 0x6d703ef3, 0x7a6d76e9, 0x00000000};

static inline uint32_t rol(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

static inline uint32_t f(int j, uint32_t x, uint32_t y, uint32_t z) {
  if (j < 16) return x ^ y ^ z;
  if (j < 32) return (x & y) | (~x & z);
  if (j < 48) return (x | ~y) ^ z;
  if (j < 64) return (x & z) | (y & ~z);
  return x ^ (y | ~z);
}

// RIPEMD-160 of exactly 32 bytes (one padded block) — the only size the
// hash160 pipeline needs.
static void ripemd160_32(const uint8_t msg[32], uint8_t out[20]) {
  uint32_t x[16] = {0};
  for (int i = 0; i < 8; i++)
    x[i] = uint32_t(msg[4 * i]) | (uint32_t(msg[4 * i + 1]) << 8) |
           (uint32_t(msg[4 * i + 2]) << 16) | (uint32_t(msg[4 * i + 3]) << 24);
  x[8] = 0x80;
  x[14] = 256;
  uint32_t h[5] = {0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476, 0xc3d2e1f0};
  uint32_t a1 = h[0], b1 = h[1], c1 = h[2], d1 = h[3], e1 = h[4];
  uint32_t a2 = h[0], b2 = h[1], c2 = h[2], d2 = h[3], e2 = h[4];
  for (int j = 0; j < 80; j++) {
    uint32_t t = rol(a1 + f(j, b1, c1, d1) + x[R1[j]] + KK1[j / 16], S1[j]) + e1;
    a1 = e1; e1 = d1; d1 = rol(c1, 10); c1 = b1; b1 = t;
    t = rol(a2 + f(79 - j, b2, c2, d2) + x[R2[j]] + KK2[j / 16], S2[j]) + e2;
    a2 = e2; e2 = d2; d2 = rol(c2, 10); c2 = b2; b2 = t;
  }
  uint32_t r[5];
  r[0] = h[1] + c1 + d2;
  r[1] = h[2] + d1 + e2;
  r[2] = h[3] + e1 + a2;
  r[3] = h[4] + a1 + b2;
  r[4] = h[0] + b1 + c2;
  for (int i = 0; i < 5; i++)
    for (int j = 0; j < 4; j++) out[4 * i + j] = uint8_t(r[i] >> (8 * j));
}

}  // namespace rmd

// ---------------------------------------------------------------------------
// secp256k1 over 4x64 limbs (unsigned __int128 products)
// ---------------------------------------------------------------------------

namespace ec {

typedef unsigned __int128 u128;

struct U256 {
  uint64_t v[4];  // little-endian limbs
};

static const U256 P = {{0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
                        0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL}};
static const U256 GX = {{0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL,
                         0x55A06295CE870B07ULL, 0x79BE667EF9DCBBACULL}};
static const U256 GY = {{0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL,
                         0x5DA4FBFC0E1108A8ULL, 0x483ADA7726A3C465ULL}};

static inline bool is_zero(const U256& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}
static inline int cmp(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; i--) {
    if (a.v[i] < b.v[i]) return -1;
    if (a.v[i] > b.v[i]) return 1;
  }
  return 0;
}

static inline void add_raw(const U256& a, const U256& b, U256& r, uint64_t& carry) {
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a.v[i] + b.v[i] + c;
    r.v[i] = (uint64_t)s;
    c = s >> 64;
  }
  carry = (uint64_t)c;
}
static inline void sub_raw(const U256& a, const U256& b, U256& r, uint64_t& borrow) {
  u128 br = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a.v[i] - b.v[i] - br;
    r.v[i] = (uint64_t)d;
    br = (d >> 64) & 1;
  }
  borrow = (uint64_t)br;
}

static inline void add_mod(const U256& a, const U256& b, U256& r) {
  uint64_t c, br;
  add_raw(a, b, r, c);
  if (c || cmp(r, P) >= 0) {
    U256 t;
    sub_raw(r, P, t, br);
    r = t;
  }
}
static inline void sub_mod(const U256& a, const U256& b, U256& r) {
  uint64_t br, c;
  sub_raw(a, b, r, br);
  if (br) {
    U256 t;
    add_raw(r, P, t, c);
    r = t;
  }
}

// (a * b) mod p via 2^256 = 2^32 + 0x3D1 folding.
static void mul_mod(const U256& a, const U256& b, U256& r) {
  uint64_t lo[8] = {0};
  // schoolbook 4x4
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 cur = (u128)a.v[i] * b.v[j] + lo[i + j] + carry;
      lo[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    lo[i + 4] += (uint64_t)carry;
  }
  // fold: r = low + high * (2^32 + 0x3D1)
  const u128 F = ((u128)1 << 32) + 0x3D1;
  uint64_t acc[5] = {lo[0], lo[1], lo[2], lo[3], 0};
  u128 carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)lo[4 + i] * (uint64_t)0x3D1 + acc[i] + carry;
    acc[i] = (uint64_t)cur;
    carry = cur >> 64;
    // + high[i] << 32 handled below via 128-bit adds
  }
  acc[4] += (uint64_t)carry;
  // add high << 32
  carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 shifted = (u128)lo[4 + i] << 32;
    u128 cur = (u128)acc[i] + (uint64_t)shifted + carry;
    acc[i] = (uint64_t)cur;
    carry = (cur >> 64) + (uint64_t)(shifted >> 64);
  }
  acc[4] += (uint64_t)carry;
  // second fold of acc[4] (< 2^34): value = low256 + acc[4]*F
  u128 top = (u128)acc[4] * F;  // < 2^67
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)acc[i] + (uint64_t)top + c;
    acc[i] = (uint64_t)cur;
    c = cur >> 64;
    top >>= 64;
  }
  // c in {0,1}: one more fold (the result is then tiny; cannot carry again)
  if (c) {
    u128 t2 = F;
    u128 cc = 0;
    for (int i = 0; i < 4; i++) {
      u128 cur = (u128)acc[i] + (uint64_t)t2 + cc;
      acc[i] = (uint64_t)cur;
      cc = cur >> 64;
      t2 >>= 64;
    }
  }
  U256 res = {{acc[0], acc[1], acc[2], acc[3]}};
  if (cmp(res, P) >= 0) {
    uint64_t br;
    U256 t;
    sub_raw(res, P, t, br);
    res = t;
  }
  r = res;
}

static void sqr_mod(const U256& a, U256& r) { mul_mod(a, a, r); }

// a^(p-2) mod p (Fermat) — fixed ladder over the exponent bits.
static void inv_mod(const U256& a, U256& r) {
  // p - 2
  static const U256 E = {{0xFFFFFFFEFFFFFC2DULL, 0xFFFFFFFFFFFFFFFFULL,
                          0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL}};
  U256 result = {{1, 0, 0, 0}};
  U256 base = a;
  for (int i = 0; i < 256; i++) {
    if ((E.v[i / 64] >> (i % 64)) & 1) {
      U256 t;
      mul_mod(result, base, t);
      result = t;
    }
    U256 s;
    sqr_mod(base, s);
    base = s;
  }
  r = result;
}

struct Point {
  U256 x, y;
  bool inf;
};

static void point_add(const Point& p, const Point& q, Point& r) {
  if (p.inf) { r = q; return; }
  if (q.inf) { r = p; return; }
  U256 dx, dy;
  sub_mod(q.x, p.x, dx);
  sub_mod(q.y, p.y, dy);
  U256 num, den;
  if (is_zero(dx)) {
    if (!is_zero(dy) || is_zero(p.y)) { r.inf = true; return; }
    // tangent
    U256 x2, t3;
    sqr_mod(p.x, x2);
    add_mod(x2, x2, t3);
    add_mod(t3, x2, num);  // 3x^2
    add_mod(p.y, p.y, den);
  } else {
    num = dy;
    den = dx;
  }
  U256 inv, lam, lam2, x3, y3, t;
  inv_mod(den, inv);
  mul_mod(num, inv, lam);
  sqr_mod(lam, lam2);
  sub_mod(lam2, p.x, t);
  sub_mod(t, q.x, x3);
  sub_mod(p.x, x3, t);
  mul_mod(lam, t, y3);
  sub_mod(y3, p.y, r.y);
  r.x = x3;
  r.inf = false;
}

// k * G, double-and-add (host verification rates only).
static void scalar_mult(const U256& k, Point& r) {
  Point acc;
  acc.inf = true;
  Point addend = {GX, GY, false};
  for (int i = 0; i < 256; i++) {
    if ((k.v[i / 64] >> (i % 64)) & 1) {
      Point t;
      point_add(acc, addend, t);
      acc = t;
    }
    Point d;
    point_add(addend, addend, d);
    addend = d;
  }
  r = acc;
}

static void u256_from_be(const uint8_t be[32], U256& r) {
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    for (int j = 0; j < 8; j++) v = (v << 8) | be[(3 - i) * 8 + j];
    r.v[i] = v;
  }
}
static void u256_to_be(const U256& a, uint8_t be[32]) {
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) be[(3 - i) * 8 + j] = uint8_t(a.v[i] >> (56 - 8 * j));
}

}  // namespace ec

// ---------------------------------------------------------------------------
// base58 (bitcoin alphabet)
// ---------------------------------------------------------------------------

namespace b58 {

static const char* ALPHA = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz";

static int decode(const char* str, size_t len, uint8_t* out, size_t out_cap) {
  // big integer base conversion; returns number of bytes or -1
  static int8_t map[128];
  static bool init = false;
  if (!init) {
    memset(map, -1, sizeof(map));
    for (int i = 0; i < 58; i++) map[(int)ALPHA[i]] = (int8_t)i;
    init = true;
  }
  uint8_t buf[64] = {0};
  size_t buflen = 0;
  size_t zeros = 0;
  bool leading = true;
  for (size_t i = 0; i < len; i++) {
    unsigned char ch = str[i];
    if (ch >= 128 || map[ch] < 0) return -1;
    if (leading && ch == '1') { zeros++; continue; }
    leading = false;
    int carry = map[ch];
    for (size_t j = 0; j < buflen; j++) {
      int v = buf[j] * 58 + carry;
      buf[j] = uint8_t(v & 0xFF);
      carry = v >> 8;
    }
    while (carry) {
      if (buflen >= sizeof(buf)) return -1;
      buf[buflen++] = uint8_t(carry & 0xFF);
      carry >>= 8;
    }
  }
  size_t total = zeros + buflen;
  if (total > out_cap) return -1;
  for (size_t i = 0; i < zeros; i++) out[i] = 0;
  for (size_t i = 0; i < buflen; i++) out[zeros + i] = buf[buflen - 1 - i];
  return (int)total;
}

}  // namespace b58

// ---------------------------------------------------------------------------
// BSGS baby-table builder (host exact-resolution table).
//
// Host/device split of the reference's bP table (capability of
// keyhunt.cpp:4404-4592 thread_bPload + :1366-1371 bPtable): the DEVICE keeps
// only the probabilistic filters (bitmap + hashed bloom, filter/bitmap.py);
// the exact 64-bit-truncation -> baby-index table lives on the HOST, built
// here and resolved with np.searchsorted per chunk. The builder is the same
// batched group walk as the device kernels — one modular inversion per block
// of BB lanes via the Montgomery trick (reference analog IntGroup::ModInv,
// secp256k1/IntGroup.cpp:36-57) — producing x(j*G) low-64 truncations for
// j = 1..m, sorted by key with j-1 as the u32 payload.
// ---------------------------------------------------------------------------

namespace babytable {

using ec::U256;
using ec::Point;

static const uint32_t BB = 1024;  // walk lanes per batched inversion

#pragma pack(push, 1)
struct Rec {
  uint64_t k;   // low 64 bits of x(j*G), canonical mod p
  uint32_t j0;  // j - 1
};
#pragma pack(pop)

// x(j*G) for j in [from, from+count): incremental exact walk (point_add per
// step — test/cross-check rates only; build() below is the fast path).
static int keys_range(uint64_t from, uint64_t count, uint64_t* out) {
  if (from == 0) return -1;
  U256 k = {{from, 0, 0, 0}};
  Point p;
  ec::scalar_mult(k, p);
  Point g = {ec::GX, ec::GY, false};
  for (uint64_t i = 0; i < count; i++) {
    if (p.inf) return -1;  // j*G == infinity cannot happen for j < n
    out[i] = p.x.v[0];
    Point t;
    ec::point_add(p, g, t);
    p = t;
  }
  return 0;
}

// Fills recs[0..m) with {key=trunc64(x(j*G)), j0=j-1}. The first 2*BB keys
// come from exact sequential adds; blocks t >= 2 walk base = (t*BB)*G with
// lanes u = 1..BB and ONE inversion per block. Lane BB doubles as the
// advance (base + BB*G), so the chain costs nothing extra. Degenerate lanes
// (dx == 0 <=> t*BB == +-u) are impossible for t >= 2, u <= BB; asserted.
static int fill_keys(uint64_t m, Rec* recs, int progress) {
  // offset table u*G for u = 1..BB (x, y) and the first 2*BB keys exactly
  std::vector<U256> gx(BB), gy(BB);
  Point p = {ec::GX, ec::GY, false};
  Point g = {ec::GX, ec::GY, false};
  for (uint32_t u = 1; u <= 2 * BB && u <= m + 1; u++) {
    if (u <= BB) {
      gx[u - 1] = p.x;
      gy[u - 1] = p.y;
    }
    if (u <= m) recs[u - 1] = {p.x.v[0], u - 1};
    Point t;
    ec::point_add(p, g, t);
    p = t;  // after the loop: p = (2*BB + 1)*G (unused; base derives below)
  }
  if (m <= 2 * BB) return 0;

  // base = (2*BB)*G exactly
  U256 k2 = {{2 * (uint64_t)BB, 0, 0, 0}};
  Point base;
  ec::scalar_mult(k2, base);

  std::vector<U256> dx(BB), pref(BB);
  uint64_t done = 2 * BB;
  while (done < m) {
    uint32_t lanes = (uint32_t)std::min<uint64_t>(BB, m - done);
    // the advance needs lane BB even when fewer keys remain
    uint32_t nb = (done + BB <= m) ? BB : lanes;
    uint32_t nwalk = std::max(nb, lanes);
    // dx[u] = x(g_{u+1}) - base.x ; batched inverse via prefix products
    for (uint32_t u = 0; u < nwalk; u++) {
      ec::sub_mod(gx[u], base.x, dx[u]);
      if (ec::is_zero(dx[u])) return -2;  // impossible by construction
      if (u == 0)
        pref[0] = dx[0];
      else
        ec::mul_mod(pref[u - 1], dx[u], pref[u]);
    }
    U256 inv_all;
    ec::inv_mod(pref[nwalk - 1], inv_all);
    Point next_base = base;
    bool have_next = false;
    for (int u = (int)nwalk - 1; u >= 0; u--) {
      U256 inv_u;
      if (u == 0)
        inv_u = inv_all;
      else
        ec::mul_mod(inv_all, pref[u - 1], inv_u);
      ec::mul_mod(inv_all, dx[u], inv_all);
      U256 dy, lam, lam2, x3, t;
      ec::sub_mod(gy[u], base.y, dy);
      ec::mul_mod(dy, inv_u, lam);
      ec::sqr_mod(lam, lam2);
      ec::sub_mod(lam2, base.x, t);
      ec::sub_mod(t, gx[u], x3);
      if ((uint32_t)u < lanes)
        recs[done + u] = {x3.v[0], (uint32_t)(done + u)};
      if ((uint32_t)u == BB - 1) {  // advance: base + BB*G
        U256 y3;
        ec::sub_mod(base.x, x3, t);
        ec::mul_mod(lam, t, y3);
        ec::sub_mod(y3, base.y, next_base.y);
        next_base.x = x3;
        have_next = true;
      }
    }
    done += lanes;
    if (done < m && !have_next) return -3;
    base = next_base;
    if (progress && (done & ((1ULL << 24) - 1)) == 0) {
      fprintf(stderr, "[native] baby keys %llu/%llu\n",
              (unsigned long long)done, (unsigned long long)m);
      fflush(stderr);
    }
  }
  return 0;
}

static int write_chunked(FILE* f, const void* buf, size_t total) {
  const char* pc = (const char*)buf;
  while (total) {
    size_t n = std::min<size_t>(total, 1 << 24);
    if (fwrite(pc, 1, n, f) != n) return -1;
    pc += n;
    total -= n;
  }
  return 0;
}

// Build the sorted host table for m baby keys and write it as two planes:
// keys_path = u64-LE sorted truncations, idx_path = u32-LE payloads (j-1).
// Returns 0, or <0 on failure. Peak RAM: 12 bytes/key.
static int build(uint64_t m, const char* keys_path, const char* idx_path,
                 int progress) {
  if (m == 0 || m > (1ULL << 33)) return -10;
  Rec* recs = (Rec*)malloc(sizeof(Rec) * m);
  if (!recs) return -11;
  int rc = fill_keys(m, recs, progress);
  if (rc != 0) {
    free(recs);
    return rc;
  }
  if (progress) {
    fprintf(stderr, "[native] sorting %llu keys\n", (unsigned long long)m);
    fflush(stderr);
  }
  std::sort(recs, recs + m, [](const Rec& a, const Rec& b) {
    return a.k < b.k || (a.k == b.k && a.j0 < b.j0);
  });
  // stream out the two planes in bounded buffers
  FILE* fk = fopen(keys_path, "wb");
  FILE* fi = fopen(idx_path, "wb");
  if (!fk || !fi) {
    if (fk) fclose(fk);
    if (fi) fclose(fi);
    free(recs);
    return -12;
  }
  const size_t CH = 1 << 21;
  std::vector<uint64_t> kb(CH);
  std::vector<uint32_t> ib(CH);
  rc = 0;
  for (uint64_t s = 0; s < m && rc == 0; s += CH) {
    size_t n = (size_t)std::min<uint64_t>(CH, m - s);
    for (size_t i = 0; i < n; i++) {
      kb[i] = recs[s + i].k;
      ib[i] = recs[s + i].j0;
    }
    if (write_chunked(fk, kb.data(), n * 8) != 0 ||
        write_chunked(fi, ib.data(), n * 4) != 0)
      rc = -13;
  }
  free(recs);
  if (fclose(fk) != 0) rc = rc ? rc : -13;
  if (fclose(fi) != 0) rc = rc ? rc : -13;
  return rc;
}

}  // namespace babytable

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Sorted baby table -> two raw planes on disk (see babytable::build).
int kh_baby_build(uint64_t m, const char* keys_path, const char* idx_path,
                  int progress) {
  return babytable::build(m, keys_path, idx_path, progress);
}

// trunc64(x(j*G)) for j in [from, from+count) — exact incremental walk
// (cross-check path for tests; build() is the production path).
int kh_baby_keys_range(uint64_t from, uint64_t count, uint64_t* out) {
  return babytable::keys_range(from, count, out);
}

void kh_sha256(const uint8_t* msg, uint64_t len, uint8_t out[32]) {
  sha::sha256(msg, len, out);
}

void kh_hash160(const uint8_t* msg, uint64_t len, uint8_t out[20]) {
  uint8_t digest[32];
  sha::sha256(msg, len, digest);
  rmd::ripemd160_32(digest, out);
}

// msgs: count messages of fixed `stride` bytes, hashing first `len` bytes.
void kh_hash160_batch(const uint8_t* msgs, uint64_t stride, uint64_t len,
                      uint64_t count, uint8_t* out20s) {
  for (uint64_t i = 0; i < count; i++)
    kh_hash160(msgs + i * stride, len, out20s + i * 20);
}

// Decodes base58check; writes payload (version + body) to out, returns its
// length (without the 4 checksum bytes) or -1 on bad encoding/checksum.
int kh_b58check_decode(const char* str, uint64_t len, uint8_t* out, uint64_t cap) {
  uint8_t raw[64];
  int n = b58::decode(str, len, raw, sizeof(raw));
  if (n < 5) return -1;
  uint8_t digest[32], digest2[32];
  sha::sha256(raw, n - 4, digest);
  sha::sha256(digest, 32, digest2);
  if (memcmp(digest2, raw + n - 4, 4) != 0) return -1;
  if ((uint64_t)(n - 4) > cap) return -1;
  memcpy(out, raw, n - 4);
  return n - 4;
}

// Batch-decode newline-separated base58check addresses into 20-byte
// hash160s. Returns number decoded; bad lines get 20 zero bytes.
uint64_t kh_parse_addresses(const char* text, uint64_t text_len,
                            uint8_t* out20s, uint64_t max_count) {
  uint64_t count = 0;
  uint64_t i = 0;
  while (i < text_len && count < max_count) {
    uint64_t start = i;
    while (i < text_len && text[i] != '\n' && text[i] != '\r') i++;
    uint64_t linelen = i - start;
    while (i < text_len && (text[i] == '\n' || text[i] == '\r')) i++;
    if (linelen == 0) continue;
    // trim trailing spaces / take first token
    uint64_t tok = 0;
    while (tok < linelen && text[start + tok] != ' ' && text[start + tok] != '\t')
      tok++;
    uint8_t payload[64];
    int n = kh_b58check_decode(text + start, tok, payload, sizeof(payload));
    if (n == 21) {
      memcpy(out20s + count * 20, payload + 1, 20);
    } else {
      memset(out20s + count * 20, 0, 20);
    }
    count++;
  }
  return count;
}

// k*G -> 32-byte big-endian x and y. Returns 0, or -1 for k == 0 (infinity).
int kh_scalar_mult(const uint8_t key_be[32], uint8_t out_x[32], uint8_t out_y[32]) {
  ec::U256 k;
  ec::u256_from_be(key_be, k);
  if (ec::is_zero(k)) return -1;
  ec::Point r;
  ec::scalar_mult(k, r);
  if (r.inf) return -1;
  ec::u256_to_be(r.x, out_x);
  ec::u256_to_be(r.y, out_y);
  return 0;
}

// Verify candidate private keys against a 20-byte hash160 target.
// mode: 0 = compressed, 1 = uncompressed. results[i] = 1 on match.
void kh_verify_h160(const uint8_t* keys_be, uint64_t n, int mode,
                    const uint8_t target[20], uint8_t* results) {
  for (uint64_t i = 0; i < n; i++) {
    results[i] = 0;
    uint8_t x[32], y[32];
    if (kh_scalar_mult(keys_be + 32 * i, x, y) != 0) continue;
    uint8_t msg[65];
    uint64_t len;
    if (mode == 0) {
      msg[0] = 2 + (y[31] & 1);
      memcpy(msg + 1, x, 32);
      len = 33;
    } else {
      msg[0] = 4;
      memcpy(msg + 1, x, 32);
      memcpy(msg + 33, y, 32);
      len = 65;
    }
    uint8_t h[20];
    kh_hash160(msg, len, h);
    results[i] = memcmp(h, target, 20) == 0 ? 1 : 0;
  }
}

// Host reference of the GPU walk kernels (walk_kernels.cu): the same
// per-lane code, looped over lanes on one core.
void kh_walk_bases_ref(const uint32_t* px, const uint32_t* py,
                       const uint32_t* qx, const uint32_t* qy, uint32_t* ox,
                       uint32_t* oy, uint8_t* inf, uint64_t n) {
  for (uint64_t i = 0; i < n; i++) {
    uint32_t a[8], b[8], c[8], d[8], x3[8], y3[8];
    khw::load(a, px, n, i);
    khw::load(b, py, n, i);
    khw::load(c, qx, n, i);
    khw::load(d, qy, n, i);
    inf[i] = khw::add_full(x3, y3, a, b, c, d) ? 1 : 0;
    khw::store(ox, n, i, x3);
    khw::store(oy, n, i, y3);
  }
}

int kh_walk_blocks_ref(const uint32_t* bx, const uint32_t* by,
                       const uint32_t* tx, const uint32_t* ty, uint32_t* qlo,
                       uint32_t* qhi, uint8_t* deg, uint64_t nb, uint64_t u,
                       int chain) {
  if (chain < 1 || nb % (uint64_t)chain != 0) return -1;
  std::vector<uint32_t> pre((size_t)chain * 8);
  for (uint64_t lane = 0; lane < u; lane++) {
    uint32_t txl[8], tyl[8];
    khw::load(txl, tx, u, lane);
    khw::load(tyl, ty, u, lane);
    for (uint64_t b0 = 0; b0 < nb; b0 += chain)
      khw::walk_chain(bx, by, nb, txl, tyl, u, lane, b0, chain,
                      reinterpret_cast<uint32_t(*)[8]>(pre.data()), qlo, qhi,
                      deg);
  }
  return 0;
}

}  // extern "C"
