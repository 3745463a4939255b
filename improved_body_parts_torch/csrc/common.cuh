// Shared helpers of the decode kernels (peaks.cu, limbs.cu).
//
// The maps arrive as strided NHWC float32 views (a channel slice of the
// ensembled (N, H, W, 50) maps, never copied), so every kernel addresses
// them through element strides.  Offsets are 32-bit: the wrappers refuse a
// view whose largest element offset reaches 2^31 (the serve lane's whole
// (8, 640, 896, 50) batch is 229.4 M elements), so an address costs 32-bit
// multiply-adds, not 64-bit products.
#pragma once

#include <cuda_runtime.h>

struct MapView {
  const float* p;
  int sn, sh, sw, sc;  // element strides of (N, H, W, C)
  int h, w;
};

__device__ __forceinline__ float map_at(const MapView& m, int n, int c,
                                        int y, int x) {
  return __ldg(m.p + (n * m.sn + y * m.sh + x * m.sw + c * m.sc));
}

// The largest element offset of an (N, H, W, C) view fits a signed 32-bit
// int (the launchers' guard; the wrappers raise before it is reached).
inline bool offsets_fit_int32(long long sn, long long sh, long long sw,
                              long long sc, int N, int H, int W, int C) {
  if (sn < 0 || sh < 0 || sw < 0 || sc < 0) return false;
  const long long last = (N - 1LL) * sn + (H - 1LL) * sh + (W - 1LL) * sw +
                         (C - 1LL) * sc;
  return last < (1LL << 31);
}
