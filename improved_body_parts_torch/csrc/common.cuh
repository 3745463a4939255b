// Shared helpers of the decode kernels (peaks.cu, limbs.cu).
//
// The maps arrive as strided NHWC float32 views (a channel slice of the
// ensembled (N, H, W, 50) maps, never copied), so every kernel addresses
// them through element strides.
#pragma once

#include <cuda_runtime.h>

struct MapView {
  const float* p;
  long long sn, sh, sw, sc;  // element strides of (N, H, W, C)
  int h, w;
};

__device__ __forceinline__ float map_at(const MapView& m, int n, int c,
                                        int y, int x) {
  return __ldg(m.p + n * m.sn + y * m.sh + x * m.sw + c * m.sc);
}
