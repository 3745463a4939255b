// Peak NMS + top-K + sub-pixel refinement on Hopper (sm_90a).
//
// Replaces the TPU kernel topk_peaks_pallas / _peaks_kernel
// (improved_body_parts_tpu/ops/pallas_peaks.py:53, pallas_call at l.150),
// which holds one keypoint channel's whole (H, W) map in VMEM for NMS,
// top-K and refinement.  At serve size one channel is 640x896x4 B =
// 2.3 MB, ten times the 227 KB of shared memory a block can use, so the
// map cannot stay resident here.  Two launches instead:
//
//  (a) peaks_nms_kernel, grid (tile of 8x64 pixels, image): the block
//      first stages the tile and a one-pixel halo of every channel in
//      shared memory (masked to the valid region, reflect-padded at the
//      map's border), neighbouring threads reading neighbouring channels
//      of one NHWC pixel record, so the strided maps are read in a few
//      sectors per pixel and never again.  Then, channel by channel, each
//      thread decides one pixel's keep flag (the 3x3 max equals the value,
//      value >= thre) from shared memory, the block adds its keep count
//      to the channel's true count (integer atomics: deterministic) and
//      writes its kept (value, flat index) pairs -- or, when more than K
//      were kept, its own top K after a shared-memory bitonic sort -- to
//      a per-(channel, tile) slot.
//  (b) peaks_select_kernel, one block per (channel, image): gathers the
//      tiles' candidates into shared memory, sorts them by (value desc,
//      index asc) -- lax.top_k's order -- and, when fewer than K peaks
//      exist, fills the remaining slots with the lowest non-kept flat
//      indices at value -1e9, exactly what top_k over the masked score
//      map returns.  Then one thread per slot refines with the
//      (2r+1)^2 weighted centroid read from the raw map in global memory.
//      More candidates than the shared buffer holds are merged in rounds.
//
// Bound on this card: bytes.  The kernel must read the keypoint slice of
// the maps once (N x H x W x 18 x 4 B; 41.3 MB per 640x896 image, ~12 us
// at 3.35 TB/s); everything else is O(C K).  The slice is 72 B of each
// 200-B pixel record, so pass (a) moves 3-4 sectors per pixel, not the
// 2.25 its bytes need.  The refinement sums its
// window one term at a time in row-major order, as the plain version and
// XLA do, so every output equals the plain version's bit for bit.
#include <climits>
#include <math.h>

#include "common.cuh"

#define TILE_H 8
#define TILE_W 64
#define TILE (TILE_H * TILE_W)  // pixels per NMS block, one per thread
#define HALO_W (TILE_W + 2)
#define HALO_PX ((TILE_H + 2) * HALO_W)
#define HALO_PITCH (HALO_PX | 1)  // odd: staging stores spread over banks
#define SEL_BUF 4096   // shared candidate buffer of the select block
#define SEL_THREADS 256
#define NEG_MASK -1e9f

__device__ __forceinline__ int reflect_index(int i, int size) {
  if (size == 1) return 0;
  if (i < 0) return -i;
  if (i >= size) return 2 * size - 2 - i;
  return i;
}

__device__ __forceinline__ float masked_at(const MapView& m, int n, int c,
                                           int y, int x, int vh, int vw) {
  return (y < vh && x < vw) ? map_at(m, n, c, y, x) : NEG_MASK;
}

// keep flag of one pixel: the masked value is the 3x3 max of the
// reflect-padded masked map and clears the threshold
__device__ bool pixel_kept(const MapView& m, int n, int c, int y, int x,
                           int vh, int vw, float thre, float* value) {
  float v = masked_at(m, n, c, y, x, vh, vw);
  float hmax = v;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx)
      hmax = fmaxf(hmax, masked_at(m, n, c, reflect_index(y + dy, m.h),
                                   reflect_index(x + dx, m.w), vh, vw));
  *value = v;
  return hmax == v && v >= thre;
}

// (value desc, index asc): lax.top_k's order
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// in-place bitonic sort of n (a power of two) entries into `before`
// order; the caller has synchronised the block after filling the arrays
__device__ void bitonic_sort(float* v, int* id, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        int lo = 2 * t - (t & (stride - 1));
        int hi = lo + stride;
        bool up = (lo & size) == 0;
        bool swap = up ? before(v[hi], id[hi], v[lo], id[lo])
                       : before(v[lo], id[lo], v[hi], id[hi]);
        if (swap) {
          float tv = v[lo]; v[lo] = v[hi]; v[hi] = tv;
          int ti = id[lo]; id[lo] = id[hi]; id[hi] = ti;
        }
      }
      __syncthreads();
    }
  }
}

// dynamic shared memory of peaks_nms_kernel: the C-channel halo tile,
// then the sort buffers
__host__ __device__ inline size_t nms_smem_bytes(int C) {
  return ((size_t)C * HALO_PITCH + TILE) * sizeof(float) + TILE * sizeof(int);
}

__global__ void __launch_bounds__(TILE)
peaks_nms_kernel(MapView m, const int* __restrict__ valid_h,
                 const int* __restrict__ valid_w, int C, float thre, int K,
                 int tiles_x, int ntiles, int* __restrict__ count,
                 float* __restrict__ tile_val, int* __restrict__ tile_idx,
                 int* __restrict__ tile_n) {
  extern __shared__ float smem[];
  float* halo = smem;                         // [C][HALO_PITCH]
  float* sv = smem + (size_t)C * HALO_PITCH;  // [TILE]
  int* si = (int*)(sv + TILE);                // [TILE]
  __shared__ int fill;
  const int t = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x;
  const int y0 = (t / tiles_x) * TILE_H, x0 = (t % tiles_x) * TILE_W;
  const int vh = valid_h[n], vw = valid_w[n];

  // halo entries beyond the map's far edge + 1 are no pixel's neighbour;
  // the clamp only keeps their reads inside the map
  for (int e = tid; e < HALO_PX * C; e += TILE) {
    const int p = e / C, c = e % C;
    const int y = min(max(reflect_index(y0 - 1 + p / HALO_W, m.h), 0),
                      m.h - 1);
    const int x = min(max(reflect_index(x0 - 1 + p % HALO_W, m.w), 0),
                      m.w - 1);
    halo[c * HALO_PITCH + p] = masked_at(m, n, c, y, x, vh, vw);
  }
  __syncthreads();

  const int ty = tid / TILE_W, tx = tid % TILE_W;
  const int y = y0 + ty, x = x0 + tx;
  const bool in_map = y < m.h && x < m.w;
  const int idx = y * m.w + x;
  for (int c = 0; c < C; ++c) {
    const float* w3 = halo + c * HALO_PITCH + ty * HALO_W + tx;  // 3x3 corner
    const float v = w3[HALO_W + 1];
    float hmax = v;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) hmax = fmaxf(hmax, w3[dy * HALO_W + dx]);
    const bool keep = in_map && hmax == v && v >= thre;
    // also the barrier that ends the previous channel's use of fill, sv, si
    const int nk = __syncthreads_count(keep);
    const long long nc = (long long)n * C + c;
    const long long slot = nc * ntiles + t;
    if (tid == 0) {
      if (nk) atomicAdd(count + nc, nk);
      tile_n[slot] = min(nk, K);
      fill = 0;
    }
    if (nk == 0) continue;  // uniform over the block
    float* ov = tile_val + slot * K;
    int* oi = tile_idx + slot * K;
    if (nk <= K) {
      __syncthreads();
      if (keep) {
        int p = atomicAdd(&fill, 1);  // any order: the select block sorts
        ov[p] = v;
        oi[p] = idx;
      }
      continue;
    }
    sv[tid] = keep ? v : -INFINITY;
    si[tid] = keep ? idx : INT_MAX;
    __syncthreads();
    bitonic_sort(sv, si, TILE);
    if (tid < K) {
      ov[tid] = sv[tid];
      oi[tid] = si[tid];
    }
  }
}

__global__ void __launch_bounds__(SEL_THREADS)
peaks_select_kernel(MapView m, const int* __restrict__ valid_h,
                    const int* __restrict__ valid_w, int C, float thre,
                    int K, int radius, int ntiles,
                    const int* __restrict__ count,
                    const float* __restrict__ tile_val,
                    const int* __restrict__ tile_idx,
                    const int* __restrict__ tile_n, int* __restrict__ xs,
                    int* __restrict__ ys, float* __restrict__ x_ref,
                    float* __restrict__ y_ref, float* __restrict__ score,
                    int* __restrict__ valid) {
  __shared__ float sv[SEL_BUF];
  __shared__ int si[SEL_BUF];
  __shared__ int fill, got, warp_off[SEL_THREADS / 32];
  const int c = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long nc = (long long)n * C + c;
  const int cnt = count[nc];
  const int vh = valid_h[n], vw = valid_w[n];
  const int hw = m.h * m.w;
  const int* tn = tile_n + nc * ntiles;
  const float* tv = tile_val + nc * ntiles * K;
  const int* ti = tile_idx + nc * ntiles * K;

  if (cnt <= SEL_BUF) {
    // every tile's candidates fit: gather (any order), sort once
    if (tid == 0) fill = 0;
    __syncthreads();
    for (int t = tid; t < ntiles; t += nthr) {
      int k = tn[t];
      if (k) {
        int b = atomicAdd(&fill, k);
        for (int j = 0; j < k; ++j) {
          sv[b + j] = tv[(long long)t * K + j];
          si[b + j] = ti[(long long)t * K + j];
        }
      }
    }
    __syncthreads();
    const int total = fill;
    int p = 1;
    while (p < total) p <<= 1;
    for (int i = total + tid; i < p; i += nthr) {
      sv[i] = -INFINITY;
      si[i] = INT_MAX;
    }
    __syncthreads();
    bitonic_sort(sv, si, p);
  } else {
    // more candidates than the buffer: keep the best K in [0, K) and
    // merge the tiles in rounds of g tiles through [K, SEL_BUF)
    const int g = (SEL_BUF - K) / K;
    for (int i = tid; i < K; i += nthr) {
      sv[i] = -INFINITY;
      si[i] = INT_MAX;
    }
    for (int g0 = 0; g0 < ntiles; g0 += g) {
      for (int e = tid; e < SEL_BUF - K; e += nthr) {
        int t = g0 + e / K, j = e % K;
        bool ok = e / K < g && t < ntiles && j < tn[t];
        sv[K + e] = ok ? tv[(long long)t * K + j] : -INFINITY;
        si[K + e] = ok ? ti[(long long)t * K + j] : INT_MAX;
      }
      __syncthreads();
      bitonic_sort(sv, si, SEL_BUF);
    }
  }

  // fewer kept peaks than K: top_k continues with the -1e9 entries of
  // the score map in ascending flat-index order
  const int nkept = min(cnt, K);
  const int need = K - nkept;
  if (tid == 0) got = 0;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int base = 0; got < need && base < hw; base += nthr) {
    const int j = base + tid;
    float v;
    const bool free_slot =
        j < hw && !pixel_kept(m, n, c, j / m.w, j % m.w, vh, vw, thre, &v);
    const unsigned ballot = __ballot_sync(0xffffffffu, free_slot);
    if (lane == 0) warp_off[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int w = 0; w < nthr / 32; ++w) {
        int s = warp_off[w];
        warp_off[w] = acc;
        acc += s;
      }
      fill = acc;
    }
    __syncthreads();
    if (free_slot) {
      int r = got + warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));
      if (r < need) {
        sv[nkept + r] = NEG_MASK;
        si[nkept + r] = j;
      }
    }
    __syncthreads();
    if (tid == 0) got += fill;
    __syncthreads();
  }

  // weighted-centroid refinement from the raw map; windows crossing the
  // valid border keep the raw coordinates and score
  const int r = radius;
  // the window mean as sum * (1/area), the reciprocal rounded to float
  // first: XLA's arithmetic for the mean
  const float area_inv = 1.0f / (float)((2 * r + 1) * (2 * r + 1));
  for (int s = tid; s < K; s += nthr) {
    const float val = sv[s];
    const int id = si[s];
    const int y = id / m.w, x = id % m.w;
    float total = 0.0f, sx = 0.0f, sy = 0.0f;
    for (int oy = -r; oy <= r; ++oy) {
      const int yy = min(max(y + oy, 0), m.h - 1);
      for (int ox = -r; ox <= r; ++ox) {
        const int xx = min(max(x + ox, 0), m.w - 1);
        const float b = map_at(m, n, c, yy, xx);
        total += b;
        sx += b * (float)ox;
        sy += b * (float)oy;
      }
    }
    const float denom = total == 0.0f ? 1.0f : total;
    const bool inside = x - r >= 0 && x + r + 1 <= vw && y - r >= 0 &&
                        y + r + 1 <= vh;
    const long long o = nc * K + s;
    xs[o] = x;
    ys[o] = y;
    x_ref[o] = inside ? (float)x + sx / denom : (float)x;
    y_ref[o] = inside ? (float)y + sy / denom : (float)y;
    score[o] = inside ? total * area_inv : val;
    valid[o] = val >= thre;
  }
}

// Number of NMS tiles of an H x W map: the caller sizes the scratch by it.
extern "C" int ibp_topk_peaks_tiles(int H, int W) {
  return ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
}

// Launch both passes on `stream`.  Scratch (count zeroed; tile buffers of
// N*C*ntiles*K entries and tile_n of N*C*ntiles, ntiles from
// ibp_topk_peaks_tiles) comes from the caller.  Returns the cudaError_t
// of the launches (0 = success).
extern "C" int ibp_topk_peaks(const float* heat, long long sn, long long sh,
                              long long sw, long long sc, int N, int H,
                              int W, int C, const int* valid_h,
                              const int* valid_w, float thre, int K,
                              int radius, int* count, float* tile_val,
                              int* tile_idx, int* tile_n, int* xs, int* ys,
                              float* x_ref, float* y_ref, float* score,
                              int* valid, void* stream) {
  const size_t smem = nms_smem_bytes(C);
  if (K < 1 || K > TILE || K > SEL_BUF / 2 || K > H * W || radius < 0 ||
      C < 1 || smem > 200 * 1024)  // C <= 73 channels
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MapView m{heat, sn, sh, sw, sc, H, W};
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int ntiles = ibp_topk_peaks_tiles(H, W);
  cudaError_t e = cudaFuncSetAttribute(
      peaks_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  peaks_nms_kernel<<<dim3(ntiles, N), TILE, smem, st>>>(
      m, valid_h, valid_w, C, thre, K, tiles_x, ntiles, count, tile_val,
      tile_idx, tile_n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  peaks_select_kernel<<<dim3(C, N), SEL_THREADS, 0, st>>>(
      m, valid_h, valid_w, C, thre, K, radius, ntiles, count, tile_val,
      tile_idx, tile_n, xs, ys, x_ref, y_ref, score, valid);
  return (int)cudaGetLastError();
}
