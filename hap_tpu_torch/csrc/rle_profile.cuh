// Static facts of the structured (RLE) Snappy profile for a (S, G) chunk
// shape, computed on the device from S and G: the same numbers as
// hap_tpu_torch/snappy/device.py:profile, and the bytes of its static tag
// patterns, so that kernels E and D(ii) need no pattern tables.

#pragma once

#include <cstdint>

namespace rle {

constexpr int kUnit = 4096;

// Literal tag of a literal of `len` bytes: its length and its k-th byte.
__host__ __device__ inline int lit_tag_len(int len) {
  const int n = len - 1;
  return n < 60 ? 1 : n < 256 ? 2 : 3;
}

__host__ __device__ inline uint8_t lit_tag_byte(int len, int k) {
  const int n = len - 1;
  if (n < 60) return (uint8_t)(n << 2);
  if (n < 256) return k == 0 ? (uint8_t)(60 << 2) : (uint8_t)n;
  return k == 0 ? (uint8_t)(61 << 2) : k == 1 ? (uint8_t)(n & 0xFF)
                                              : (uint8_t)(n >> 8);
}

// copy-2 elements (offset G) covering L bytes: 64-byte elements, the last
// one shorter. Length in bytes, and the k-th byte.
__host__ __device__ inline int copy_run_len(int L) { return 3 * ((L + 63) / 64); }

__host__ __device__ inline uint8_t copy_run_byte(int L, int G, int k) {
  const int e = k / 3, r = k - 3 * e;
  const int nel = (L + 63) / 64;
  const int n = e < nel - 1 ? 64 : L - 64 * (nel - 1);
  return r == 0 ? (uint8_t)(2 | ((n - 1) << 2))
                : r == 1 ? (uint8_t)(G & 0xFF) : (uint8_t)(G >> 8);
}

struct Profile {
  int S, G, n_full, tail, n_units;
  int P;               // varint(S) length
  int emit_max;        // literal unit: 3-byte tag + 4096 bytes
  int copy_len;        // copy unit: 192
  int seed_size;       // seeded unit: tag + G seed bytes + copies
  int tail_hdr;        // tail literal tag length (0 without a tail)
  int tail_lit_size;
  int tail_copy_len;
  bool tail_seeded;    // the tail is the whole chunk and longer than G
  int tail_seed_size;
  int bound;           // worst-case stream length
};

__host__ __device__ inline Profile make_profile(int S, int G) {
  Profile p;
  p.S = S;
  p.G = G;
  p.n_full = S / kUnit;
  p.tail = S - p.n_full * kUnit;
  p.n_units = p.n_full + (p.tail ? 1 : 0);
  p.P = 0;
  for (unsigned v = (unsigned)S;; v >>= 7) {
    ++p.P;
    if (v < 0x80) break;
  }
  p.emit_max = kUnit + lit_tag_len(kUnit);
  p.copy_len = copy_run_len(kUnit);
  p.seed_size = 1 + G + copy_run_len(kUnit - G);
  p.tail_hdr = p.tail ? lit_tag_len(p.tail) : 0;
  p.tail_lit_size = p.tail ? p.tail_hdr + p.tail : 0;
  p.tail_copy_len = p.tail ? copy_run_len(p.tail) : 0;
  p.tail_seeded = p.n_full == 0 && p.tail > G;
  p.tail_seed_size = p.tail_seeded ? 1 + G + copy_run_len(p.tail - G) : 0;
  p.bound = p.P + p.n_full * p.emit_max + p.tail_lit_size;
  return p;
}

// k-th byte of varint(S).
__host__ __device__ inline uint8_t varint_byte(int S, int k) {
  const unsigned v = (unsigned)S >> (7 * k);
  return (uint8_t)((v & 0x7F) | (v >= 0x80 ? 0x80 : 0));
}

}  // namespace rle
