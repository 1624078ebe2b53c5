// Generated by `python -m repro_torch.kernels.networks` from
// src/repro_torch/kernels/networks.py, which says how the networks are
// made; do not edit by hand.
//
// Network<W, MEDIAN>::apply sorts W int32 keys in registers in place
// (MEDIAN: only wires 0..W/2 come out sorted); MedianNetwork<C>::apply
// sorts only wires (C-1)/2 and C/2 of C keys.  REPRO_EXACT_WIDTHS lists
// the (nb, s) pairs that have an exact-width kernel.
#pragma once

namespace repro {

__device__ __forceinline__ void cx(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}
__device__ __forceinline__ void cx_min(int& a, int b) { a = min(a, b); }
__device__ __forceinline__ void cx_max(int a, int& b) { b = max(a, b); }

template <int W, bool MEDIAN>
struct Network;

// W = 20, sort: 103 comparators, 206 min/max
template <>
struct Network<20, false> {
  static __device__ __forceinline__ void apply(int (&v)[20]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[16], v[17]); cx(v[18], v[19]);
    cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]);
    cx(v[9], v[11]); cx(v[12], v[14]); cx(v[13], v[15]); cx(v[16], v[18]); cx(v[17], v[19]);
    cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[13], v[14]); cx(v[17], v[18]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]);
    cx(v[9], v[13]); cx(v[10], v[14]); cx(v[11], v[15]); cx(v[2], v[4]); cx(v[3], v[5]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx(v[17], v[18]); cx(v[0], v[8]);
    cx(v[1], v[9]); cx(v[2], v[10]); cx(v[3], v[11]); cx(v[4], v[12]); cx(v[5], v[13]);
    cx(v[6], v[14]); cx(v[7], v[15]); cx(v[4], v[8]); cx(v[5], v[9]); cx(v[6], v[10]);
    cx(v[7], v[11]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[7], v[8]); cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx(v[17], v[18]);
    cx(v[0], v[16]); cx(v[1], v[17]); cx(v[2], v[18]); cx(v[3], v[19]); cx(v[8], v[16]);
    cx(v[9], v[17]); cx(v[10], v[18]); cx(v[11], v[19]); cx(v[4], v[8]); cx(v[5], v[9]);
    cx(v[6], v[10]); cx(v[7], v[11]); cx(v[12], v[16]); cx(v[13], v[17]); cx(v[14], v[18]);
    cx(v[15], v[19]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[14], v[16]); cx(v[15], v[17]); cx(v[1], v[2]);
    cx(v[3], v[4]); cx(v[5], v[6]); cx(v[7], v[8]); cx(v[9], v[10]); cx(v[11], v[12]);
    cx(v[13], v[14]); cx(v[15], v[16]); cx(v[17], v[18]);
  }
};

// W = 20, median: wires 0..10: 92 comparators, 175 min/max
template <>
struct Network<20, true> {
  static __device__ __forceinline__ void apply(int (&v)[20]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[16], v[17]); cx(v[18], v[19]);
    cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]);
    cx(v[9], v[11]); cx(v[12], v[14]); cx(v[13], v[15]); cx(v[16], v[18]); cx(v[17], v[19]);
    cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[13], v[14]); cx(v[17], v[18]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]);
    cx(v[9], v[13]); cx(v[10], v[14]); cx(v[11], v[15]); cx(v[2], v[4]); cx(v[3], v[5]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx(v[17], v[18]); cx(v[0], v[8]);
    cx(v[1], v[9]); cx(v[2], v[10]); cx(v[3], v[11]); cx(v[4], v[12]); cx(v[5], v[13]);
    cx_min(v[6], v[14]); cx_min(v[7], v[15]); cx(v[4], v[8]); cx(v[5], v[9]); cx(v[6], v[10]);
    cx(v[7], v[11]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]);
    cx(v[10], v[12]); cx_min(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[7], v[8]); cx(v[9], v[10]); cx(v[11], v[12]); cx(v[17], v[18]); cx(v[0], v[16]);
    cx(v[1], v[17]); cx(v[2], v[18]); cx(v[3], v[19]); cx(v[8], v[16]); cx_min(v[9], v[17]);
    cx_min(v[10], v[18]); cx_min(v[11], v[19]); cx(v[4], v[8]); cx(v[5], v[9]); cx(v[6], v[10]);
    cx_min(v[7], v[11]); cx_min(v[12], v[16]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]);
    cx(v[7], v[9]); cx_min(v[10], v[12]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[7], v[8]); cx(v[9], v[10]);
  }
};

// W = 16, sort: 63 comparators, 126 min/max
template <>
struct Network<16, false> {
  static __device__ __forceinline__ void apply(int (&v)[16]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[0], v[2]); cx(v[1], v[3]);
    cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]); cx(v[9], v[11]); cx(v[12], v[14]);
    cx(v[13], v[15]); cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[13], v[14]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]);
    cx(v[9], v[13]); cx(v[10], v[14]); cx(v[11], v[15]); cx(v[2], v[4]); cx(v[3], v[5]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx(v[0], v[8]); cx(v[1], v[9]);
    cx(v[2], v[10]); cx(v[3], v[11]); cx(v[4], v[12]); cx(v[5], v[13]); cx(v[6], v[14]);
    cx(v[7], v[15]); cx(v[4], v[8]); cx(v[5], v[9]); cx(v[6], v[10]); cx(v[7], v[11]);
    cx(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]); cx(v[10], v[12]);
    cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]); cx(v[7], v[8]);
    cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]);
  }
};

// W = 16, median: wires 0..8: 58 comparators, 109 min/max
template <>
struct Network<16, true> {
  static __device__ __forceinline__ void apply(int (&v)[16]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[0], v[2]); cx(v[1], v[3]);
    cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]); cx(v[9], v[11]); cx(v[12], v[14]);
    cx(v[13], v[15]); cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[13], v[14]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]);
    cx(v[9], v[13]); cx(v[10], v[14]); cx(v[11], v[15]); cx(v[2], v[4]); cx(v[3], v[5]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx(v[0], v[8]); cx(v[1], v[9]);
    cx(v[2], v[10]); cx(v[3], v[11]); cx_min(v[4], v[12]); cx_min(v[5], v[13]); cx_min(v[6], v[14]);
    cx_min(v[7], v[15]); cx(v[4], v[8]); cx(v[5], v[9]); cx_min(v[6], v[10]); cx_min(v[7], v[11]);
    cx(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]); cx_min(v[7], v[9]); cx(v[1], v[2]);
    cx(v[3], v[4]); cx(v[5], v[6]); cx(v[7], v[8]);
  }
};

// W = 10, sort: 32 comparators, 64 min/max
template <>
struct Network<10, false> {
  static __device__ __forceinline__ void apply(int (&v)[10]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[1], v[2]);
    cx(v[5], v[6]); cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]);
    cx(v[2], v[4]); cx(v[3], v[5]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[0], v[8]); cx(v[1], v[9]); cx(v[4], v[8]); cx(v[5], v[9]); cx(v[2], v[4]);
    cx(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]); cx(v[1], v[2]); cx(v[3], v[4]);
    cx(v[5], v[6]); cx(v[7], v[8]);
  }
};

// W = 10, median: wires 0..5: 30 comparators, 56 min/max
template <>
struct Network<10, true> {
  static __device__ __forceinline__ void apply(int (&v)[10]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[1], v[2]);
    cx(v[5], v[6]); cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx_min(v[3], v[7]);
    cx(v[2], v[4]); cx(v[3], v[5]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[0], v[8]); cx(v[1], v[9]); cx(v[4], v[8]); cx_min(v[5], v[9]); cx(v[2], v[4]);
    cx(v[3], v[5]); cx_min(v[6], v[8]); cx(v[1], v[2]); cx(v[3], v[4]); cx_min(v[5], v[6]);
  }
};

// W = 8, sort: 19 comparators, 38 min/max
template <>
struct Network<8, false> {
  static __device__ __forceinline__ void apply(int (&v)[8]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[0], v[2]);
    cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[1], v[2]); cx(v[5], v[6]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]); cx(v[2], v[4]);
    cx(v[3], v[5]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
  }
};

// W = 8, median: wires 0..4: 18 comparators, 33 min/max
template <>
struct Network<8, true> {
  static __device__ __forceinline__ void apply(int (&v)[8]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[0], v[2]);
    cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[1], v[2]); cx(v[5], v[6]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx_min(v[2], v[6]); cx_min(v[3], v[7]); cx(v[2], v[4]);
    cx_min(v[3], v[5]); cx(v[1], v[2]); cx(v[3], v[4]);
  }
};

// W = 6, sort: 12 comparators, 24 min/max
template <>
struct Network<6, false> {
  static __device__ __forceinline__ void apply(int (&v)[6]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[0], v[2]); cx(v[1], v[3]);
    cx(v[1], v[2]); cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[4]); cx(v[3], v[5]);
    cx(v[1], v[2]); cx(v[3], v[4]);
  }
};

// W = 6, median: wires 0..3: 12 comparators, 22 min/max
template <>
struct Network<6, true> {
  static __device__ __forceinline__ void apply(int (&v)[6]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[0], v[2]); cx(v[1], v[3]);
    cx(v[1], v[2]); cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[4]); cx_min(v[3], v[5]);
    cx(v[1], v[2]); cx_min(v[3], v[4]);
  }
};

template <int C>
struct MedianNetwork;

// C = 1, wires 0: 0 comparators, 0 min/max
template <>
struct MedianNetwork<1> {
  static __device__ __forceinline__ void apply(int (&v)[1]) {
  }
};

// C = 2, wires 0 and 1: 1 comparators, 2 min/max
template <>
struct MedianNetwork<2> {
  static __device__ __forceinline__ void apply(int (&v)[2]) {
    cx(v[0], v[1]);
  }
};

// C = 3, wires 1: 3 comparators, 4 min/max
template <>
struct MedianNetwork<3> {
  static __device__ __forceinline__ void apply(int (&v)[3]) {
    cx(v[0], v[1]); cx_max(v[0], v[2]); cx_min(v[1], v[2]);
  }
};

// C = 4, wires 1 and 2: 5 comparators, 8 min/max
template <>
struct MedianNetwork<4> {
  static __device__ __forceinline__ void apply(int (&v)[4]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx_max(v[0], v[2]); cx_min(v[1], v[3]); cx(v[1], v[2]);
  }
};

// C = 5, wires 2: 8 comparators, 12 min/max
template <>
struct MedianNetwork<5> {
  static __device__ __forceinline__ void apply(int (&v)[5]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[0], v[2]); cx_min(v[1], v[3]); cx(v[1], v[2]);
    cx_max(v[0], v[4]); cx_min(v[2], v[4]); cx_max(v[1], v[2]);
  }
};

// C = 6, wires 2 and 3: 12 comparators, 20 min/max
template <>
struct MedianNetwork<6> {
  static __device__ __forceinline__ void apply(int (&v)[6]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[0], v[2]); cx(v[1], v[3]);
    cx(v[1], v[2]); cx_max(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[4]); cx_min(v[3], v[5]);
    cx_max(v[1], v[2]); cx_min(v[3], v[4]);
  }
};

// C = 7, wires 3: 14 comparators, 22 min/max
template <>
struct MedianNetwork<7> {
  static __device__ __forceinline__ void apply(int (&v)[7]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[0], v[2]); cx(v[1], v[3]);
    cx(v[4], v[6]); cx(v[1], v[2]); cx(v[5], v[6]); cx_max(v[0], v[4]); cx_max(v[1], v[5]);
    cx_min(v[2], v[6]); cx_max(v[2], v[4]); cx_min(v[3], v[5]); cx_min(v[3], v[4]);
  }
};

// C = 8, wires 3 and 4: 17 comparators, 28 min/max
template <>
struct MedianNetwork<8> {
  static __device__ __forceinline__ void apply(int (&v)[8]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[0], v[2]);
    cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[1], v[2]); cx(v[5], v[6]);
    cx_max(v[0], v[4]); cx_max(v[1], v[5]); cx_min(v[2], v[6]); cx_min(v[3], v[7]); cx_max(v[2], v[4]);
    cx_min(v[3], v[5]); cx(v[3], v[4]);
  }
};

// C = 9, wires 4: 24 comparators, 40 min/max
template <>
struct MedianNetwork<9> {
  static __device__ __forceinline__ void apply(int (&v)[9]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[0], v[2]);
    cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[1], v[2]); cx(v[5], v[6]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx_min(v[3], v[7]); cx(v[2], v[4]);
    cx(v[3], v[5]); cx_max(v[1], v[2]); cx(v[3], v[4]); cx_min(v[5], v[6]); cx_max(v[0], v[8]);
    cx_min(v[4], v[8]); cx_max(v[2], v[4]); cx_min(v[3], v[5]); cx_max(v[3], v[4]);
  }
};

// C = 10, wires 4 and 5: 29 comparators, 50 min/max
template <>
struct MedianNetwork<10> {
  static __device__ __forceinline__ void apply(int (&v)[10]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[1], v[2]);
    cx(v[5], v[6]); cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx_min(v[3], v[7]);
    cx(v[2], v[4]); cx(v[3], v[5]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx_max(v[0], v[8]); cx_max(v[1], v[9]); cx(v[4], v[8]); cx_min(v[5], v[9]); cx_max(v[2], v[4]);
    cx(v[3], v[5]); cx_min(v[6], v[8]); cx_max(v[3], v[4]); cx_min(v[5], v[6]);
  }
};

// C = 11, wires 5: 32 comparators, 54 min/max
template <>
struct MedianNetwork<11> {
  static __device__ __forceinline__ void apply(int (&v)[11]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]);
    cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[0], v[4]); cx(v[1], v[5]);
    cx(v[2], v[6]); cx_min(v[3], v[7]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[1], v[2]);
    cx(v[3], v[4]); cx(v[5], v[6]); cx(v[9], v[10]); cx_max(v[0], v[8]); cx_max(v[1], v[9]);
    cx_max(v[2], v[10]); cx_max(v[4], v[8]); cx_min(v[5], v[9]); cx_min(v[6], v[10]); cx_max(v[3], v[5]);
    cx_min(v[6], v[8]); cx_min(v[5], v[6]);
  }
};

// C = 12, wires 5 and 6: 35 comparators, 60 min/max
template <>
struct MedianNetwork<12> {
  static __device__ __forceinline__ void apply(int (&v)[12]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]);
    cx(v[8], v[10]); cx(v[9], v[11]); cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx_min(v[3], v[7]); cx(v[2], v[4]);
    cx(v[3], v[5]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]); cx(v[9], v[10]);
    cx_max(v[0], v[8]); cx_max(v[1], v[9]); cx_max(v[2], v[10]); cx_min(v[3], v[11]); cx_max(v[4], v[8]);
    cx_min(v[5], v[9]); cx_min(v[6], v[10]); cx_max(v[3], v[5]); cx_min(v[6], v[8]); cx(v[5], v[6]);
  }
};

// C = 13, wires 6: 39 comparators, 66 min/max
template <>
struct MedianNetwork<13> {
  static __device__ __forceinline__ void apply(int (&v)[13]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]);
    cx(v[8], v[10]); cx(v[9], v[11]); cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx_min(v[3], v[7]); cx(v[8], v[12]);
    cx(v[2], v[4]); cx(v[3], v[5]); cx(v[10], v[12]); cx(v[1], v[2]); cx(v[3], v[4]);
    cx(v[5], v[6]); cx(v[9], v[10]); cx(v[11], v[12]); cx_max(v[0], v[8]); cx_max(v[1], v[9]);
    cx_max(v[2], v[10]); cx_min(v[3], v[11]); cx_min(v[4], v[12]); cx_max(v[4], v[8]); cx_min(v[5], v[9]);
    cx_min(v[6], v[10]); cx_max(v[3], v[5]); cx_min(v[6], v[8]); cx_max(v[5], v[6]);
  }
};

// C = 14, wires 6 and 7: 46 comparators, 80 min/max
template <>
struct MedianNetwork<14> {
  static __device__ __forceinline__ void apply(int (&v)[14]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]);
    cx(v[5], v[7]); cx(v[8], v[10]); cx(v[9], v[11]); cx(v[1], v[2]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]);
    cx(v[8], v[12]); cx(v[9], v[13]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[10], v[12]);
    cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]); cx(v[9], v[10]);
    cx(v[11], v[12]); cx_max(v[0], v[8]); cx_max(v[1], v[9]); cx_max(v[2], v[10]); cx(v[3], v[11]);
    cx_min(v[4], v[12]); cx_min(v[5], v[13]); cx_max(v[4], v[8]); cx(v[5], v[9]); cx_min(v[6], v[10]);
    cx_min(v[7], v[11]); cx_max(v[3], v[5]); cx(v[6], v[8]); cx_min(v[7], v[9]); cx_max(v[5], v[6]);
    cx_min(v[7], v[8]);
  }
};

// C = 15, wires 7: 49 comparators, 84 min/max
template <>
struct MedianNetwork<15> {
  static __device__ __forceinline__ void apply(int (&v)[15]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]);
    cx(v[5], v[7]); cx(v[8], v[10]); cx(v[9], v[11]); cx(v[12], v[14]); cx(v[1], v[2]);
    cx(v[5], v[6]); cx(v[9], v[10]); cx(v[13], v[14]); cx(v[0], v[4]); cx(v[1], v[5]);
    cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]); cx(v[9], v[13]); cx(v[10], v[14]);
    cx(v[2], v[4]); cx(v[3], v[5]); cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]);
    cx(v[3], v[4]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]);
    cx_max(v[0], v[8]); cx_max(v[1], v[9]); cx_max(v[2], v[10]); cx_max(v[3], v[11]); cx_min(v[4], v[12]);
    cx_min(v[5], v[13]); cx_min(v[6], v[14]); cx_max(v[4], v[8]); cx_max(v[5], v[9]); cx_min(v[6], v[10]);
    cx_min(v[7], v[11]); cx_max(v[6], v[8]); cx_min(v[7], v[9]); cx_min(v[7], v[8]);
  }
};

// C = 16, wires 7 and 8: 53 comparators, 92 min/max
template <>
struct MedianNetwork<16> {
  static __device__ __forceinline__ void apply(int (&v)[16]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[0], v[2]); cx(v[1], v[3]);
    cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]); cx(v[9], v[11]); cx(v[12], v[14]);
    cx(v[13], v[15]); cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[13], v[14]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]);
    cx(v[9], v[13]); cx(v[10], v[14]); cx(v[11], v[15]); cx(v[2], v[4]); cx(v[3], v[5]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx_max(v[0], v[8]); cx_max(v[1], v[9]);
    cx_max(v[2], v[10]); cx_max(v[3], v[11]); cx_min(v[4], v[12]); cx_min(v[5], v[13]); cx_min(v[6], v[14]);
    cx_min(v[7], v[15]); cx_max(v[4], v[8]); cx_max(v[5], v[9]); cx_min(v[6], v[10]); cx_min(v[7], v[11]);
    cx_max(v[6], v[8]); cx_min(v[7], v[9]); cx(v[7], v[8]);
  }
};

// C = 17, wires 8: 70 comparators, 124 min/max
template <>
struct MedianNetwork<17> {
  static __device__ __forceinline__ void apply(int (&v)[17]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[0], v[2]); cx(v[1], v[3]);
    cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]); cx(v[9], v[11]); cx(v[12], v[14]);
    cx(v[13], v[15]); cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[13], v[14]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]);
    cx(v[9], v[13]); cx(v[10], v[14]); cx(v[11], v[15]); cx(v[2], v[4]); cx(v[3], v[5]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx(v[0], v[8]); cx_max(v[1], v[9]);
    cx(v[2], v[10]); cx(v[3], v[11]); cx(v[4], v[12]); cx(v[5], v[13]); cx_min(v[6], v[14]);
    cx_min(v[7], v[15]); cx(v[4], v[8]); cx(v[5], v[9]); cx(v[6], v[10]); cx(v[7], v[11]);
    cx_max(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]); cx(v[10], v[12]);
    cx_min(v[11], v[13]); cx_max(v[3], v[4]); cx(v[5], v[6]); cx(v[7], v[8]); cx(v[9], v[10]);
    cx_min(v[11], v[12]); cx_max(v[0], v[16]); cx_min(v[8], v[16]); cx_max(v[4], v[8]); cx_max(v[5], v[9]);
    cx_min(v[6], v[10]); cx_min(v[7], v[11]); cx_max(v[6], v[8]); cx_min(v[7], v[9]); cx_max(v[7], v[8]);
  }
};

// C = 18, wires 8 and 9: 77 comparators, 138 min/max
template <>
struct MedianNetwork<18> {
  static __device__ __forceinline__ void apply(int (&v)[18]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[16], v[17]); cx(v[0], v[2]);
    cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]); cx(v[9], v[11]);
    cx(v[12], v[14]); cx(v[13], v[15]); cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]);
    cx(v[13], v[14]); cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]);
    cx(v[8], v[12]); cx(v[9], v[13]); cx(v[10], v[14]); cx(v[11], v[15]); cx(v[2], v[4]);
    cx(v[3], v[5]); cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]);
    cx(v[5], v[6]); cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx(v[0], v[8]);
    cx(v[1], v[9]); cx(v[2], v[10]); cx(v[3], v[11]); cx(v[4], v[12]); cx(v[5], v[13]);
    cx_min(v[6], v[14]); cx_min(v[7], v[15]); cx(v[4], v[8]); cx(v[5], v[9]); cx(v[6], v[10]);
    cx(v[7], v[11]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]);
    cx(v[10], v[12]); cx_min(v[11], v[13]); cx_min(v[1], v[2]); cx_max(v[3], v[4]); cx(v[5], v[6]);
    cx(v[7], v[8]); cx(v[9], v[10]); cx(v[11], v[12]); cx_max(v[0], v[16]); cx_max(v[1], v[17]);
    cx(v[8], v[16]); cx_min(v[9], v[17]); cx_max(v[4], v[8]); cx_max(v[5], v[9]); cx(v[6], v[10]);
    cx_min(v[7], v[11]); cx_min(v[12], v[16]); cx_max(v[6], v[8]); cx(v[7], v[9]); cx_min(v[10], v[12]);
    cx_max(v[7], v[8]); cx_min(v[9], v[10]);
  }
};

// C = 19, wires 9: 79 comparators, 140 min/max
template <>
struct MedianNetwork<19> {
  static __device__ __forceinline__ void apply(int (&v)[19]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[16], v[17]); cx(v[0], v[2]);
    cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]); cx(v[9], v[11]);
    cx(v[12], v[14]); cx(v[13], v[15]); cx(v[16], v[18]); cx(v[1], v[2]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[13], v[14]); cx(v[17], v[18]); cx(v[0], v[4]); cx(v[1], v[5]);
    cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]); cx(v[9], v[13]); cx(v[10], v[14]);
    cx(v[11], v[15]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[10], v[12]); cx(v[11], v[13]);
    cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[11], v[12]);
    cx(v[13], v[14]); cx(v[17], v[18]); cx(v[0], v[8]); cx(v[1], v[9]); cx(v[2], v[10]);
    cx(v[3], v[11]); cx(v[4], v[12]); cx(v[5], v[13]); cx_min(v[6], v[14]); cx_min(v[7], v[15]);
    cx(v[4], v[8]); cx(v[5], v[9]); cx(v[6], v[10]); cx(v[7], v[11]); cx_min(v[2], v[4]);
    cx_max(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]); cx(v[10], v[12]); cx_min(v[11], v[13]);
    cx(v[1], v[2]); cx(v[5], v[6]); cx(v[7], v[8]); cx(v[9], v[10]); cx(v[11], v[12]);
    cx(v[17], v[18]); cx_max(v[0], v[16]); cx_max(v[1], v[17]); cx_max(v[2], v[18]); cx_max(v[8], v[16]);
    cx_min(v[9], v[17]); cx_min(v[10], v[18]); cx_max(v[5], v[9]); cx_max(v[6], v[10]); cx_min(v[7], v[11]);
    cx_min(v[12], v[16]); cx_max(v[7], v[9]); cx_min(v[10], v[12]); cx_min(v[9], v[10]);
  }
};

// C = 20, wires 9 and 10: 84 comparators, 150 min/max
template <>
struct MedianNetwork<20> {
  static __device__ __forceinline__ void apply(int (&v)[20]) {
    cx(v[0], v[1]); cx(v[2], v[3]); cx(v[4], v[5]); cx(v[6], v[7]); cx(v[8], v[9]);
    cx(v[10], v[11]); cx(v[12], v[13]); cx(v[14], v[15]); cx(v[16], v[17]); cx(v[18], v[19]);
    cx(v[0], v[2]); cx(v[1], v[3]); cx(v[4], v[6]); cx(v[5], v[7]); cx(v[8], v[10]);
    cx(v[9], v[11]); cx(v[12], v[14]); cx(v[13], v[15]); cx(v[16], v[18]); cx(v[17], v[19]);
    cx(v[1], v[2]); cx(v[5], v[6]); cx(v[9], v[10]); cx(v[13], v[14]); cx(v[17], v[18]);
    cx(v[0], v[4]); cx(v[1], v[5]); cx(v[2], v[6]); cx(v[3], v[7]); cx(v[8], v[12]);
    cx(v[9], v[13]); cx(v[10], v[14]); cx(v[11], v[15]); cx(v[2], v[4]); cx(v[3], v[5]);
    cx(v[10], v[12]); cx(v[11], v[13]); cx(v[1], v[2]); cx(v[3], v[4]); cx(v[5], v[6]);
    cx(v[9], v[10]); cx(v[11], v[12]); cx(v[13], v[14]); cx(v[17], v[18]); cx(v[0], v[8]);
    cx(v[1], v[9]); cx(v[2], v[10]); cx(v[3], v[11]); cx(v[4], v[12]); cx(v[5], v[13]);
    cx_min(v[6], v[14]); cx_min(v[7], v[15]); cx(v[4], v[8]); cx(v[5], v[9]); cx(v[6], v[10]);
    cx(v[7], v[11]); cx(v[2], v[4]); cx(v[3], v[5]); cx(v[6], v[8]); cx(v[7], v[9]);
    cx(v[10], v[12]); cx_min(v[11], v[13]); cx(v[1], v[2]); cx_min(v[3], v[4]); cx(v[5], v[6]);
    cx(v[7], v[8]); cx(v[9], v[10]); cx(v[11], v[12]); cx(v[17], v[18]); cx_max(v[0], v[16]);
    cx_max(v[1], v[17]); cx_max(v[2], v[18]); cx_max(v[3], v[19]); cx_max(v[8], v[16]); cx_min(v[9], v[17]);
    cx_min(v[10], v[18]); cx_min(v[11], v[19]); cx_max(v[5], v[9]); cx_max(v[6], v[10]); cx_min(v[7], v[11]);
    cx_min(v[12], v[16]); cx_max(v[7], v[9]); cx_min(v[10], v[12]); cx(v[9], v[10]);
  }
};

#define REPRO_EXACT_WIDTHS(X) X(20, 1) X(16, 1) X(10, 2) X(8, 2) X(6, 3)

}  // namespace repro
