// Peak NMS + top-K + sub-pixel refinement on Hopper (sm_90a).
//
// Replaces the TPU kernel topk_peaks_pallas / _peaks_kernel
// (improved_body_parts_tpu/ops/pallas_peaks.py:53, pallas_call at l.150),
// which holds one keypoint channel's whole (H, W) map in VMEM for NMS,
// top-K and refinement.  At serve size one channel is 640x896x4 B =
// 2.3 MB, ten times the 227 KB of shared memory a block can use, so the
// map cannot stay resident here.  Two launches instead.
//
// What bounds it on this card: bytes.  The kernel must read the keypoint
// slice of the maps once (N x H x W x C x 4 B); everything else is
// O(C K).  On the serve lane the slice is 18 channels, 72 B at byte 120 of
// each 200-B NHWC pixel record.  Device memory moves 64-B atoms, and the
// slice always spans two of them, so the card moves 128 B a pixel, 1.78x
// the bytes the bound counts; peaks_read_probe below, which reads the
// slices once and computes nothing, measures that floor.  The record
// stride is not a multiple of 16 B, so TMA cannot load the maps; both the
// offset and the stride are multiples of 8 B.
//
//  (a) peaks_nms_kernel, grid (band of 64x32 pixels, image), one warp per
//      pair of channels, one lane per column.  The block streams its band
//      plus a one-pixel halo (66x34 pixels, 1.10x the band; bands are
//      numbered along the row, so a halo column's other reader runs at
//      the same time and may find it in L2) through a double-buffered
//      ring in shared memory, six input rows a stage, with 8-byte
//      cp.async copies of the pixels' channel slices: nine a pixel for
//      C = 18, a compile-time channel count whose copy offsets each
//      thread makes once; a generic instantiation copies 4-byte elements
//      for any other C or layout.  The next stage's load overlaps this
//      stage's NMS.  Each lane walks its column down the band and keeps
//      the 3-row window of its two channels' row maxima in registers:
//      three shared-memory reads and four fmaxf a row and channel.
//      Masking (-1e9 outside the valid region) and the
//      reflect padding come from per-block row and column tables, so the
//      copies stay raw.  Kept pixels are compacted by warp ballot into the
//      warp's own candidate list in shared memory (no atomics, no block
//      barrier per channel: a warp owns its channels); a list that would
//      overflow is cut to its top K by a warp bitonic sort.  At the end
//      each warp writes each channel's kept count and at most K
//      candidates -- the band's own top K when it kept more -- to a
//      per-(channel, band) slot.
//  (b) peaks_select_kernel, one block per (channel, image): sums the
//      bands' counts into the channel's true count, gathers their
//      candidates into shared memory, sorts them by (value desc, index
//      asc) -- lax.top_k's order -- and, when fewer than K peaks exist,
//      fills the remaining slots with the lowest non-kept flat indices at
//      value -1e9, exactly what top_k over the masked score map returns.
//      Then one thread per slot refines with the (2r+1)^2 weighted
//      centroid read from the raw map in global memory (r = 2 is a
//      compile-time radius, so a slot's 25 loads are all in flight
//      together).  More candidates than the shared buffer holds are
//      merged in rounds.
//
// The refinement sums its window one term at a time in row-major order,
// as the plain version and XLA do, and the NMS takes maxima, which are
// exact in any order, so every output equals the plain version's bit for
// bit.
#include <climits>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define BAND_H 64                     // output rows of an NMS block
#define BAND_W 32                     // output columns: one warp's lanes
#define HALO_W (BAND_W + 2)
#define IN_ROWS (BAND_H + 2)          // input rows of a band
#define STAGE_ROWS 6                  // input rows a cp.async stage brings
#define NSTAGES (IN_ROWS / STAGE_ROWS)
#define NBUF 2                        // stages in the ring
#define MAX_PAIRS 32                  // channel pairs of a block: C <= 64
#define MAX_K 512
#define SEL_BUF 4096                  // shared candidate buffer of select
#define SEL_THREADS 256
#define NEG_MASK -1e9f
#define FULL_MASK 0xffffffffu
#define SERVE_C 18                    // the serve lane's keypoint channels
#define SERVE_R 2                     // and refinement radius

static_assert(IN_ROWS % STAGE_ROWS == 0, "stages must tile the band");

__host__ __device__ __forceinline__ int reflect_index(int i, int size) {
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

__device__ __forceinline__ void compare_swap(float* v, int* id, int t,
                                             int size, int stride) {
  const int lo = 2 * t - (t & (stride - 1));
  const int hi = lo + stride;
  const bool up = (lo & size) == 0;
  const bool swap = up ? before(v[hi], id[hi], v[lo], id[lo])
                       : before(v[lo], id[lo], v[hi], id[hi]);
  if (swap) {
    const float tv = v[lo]; v[lo] = v[hi]; v[hi] = tv;
    const int ti = id[lo]; id[lo] = id[hi]; id[hi] = ti;
  }
}

// in-place bitonic sort of n (a power of two) entries into `before`
// order by the whole block; the caller has synchronised the block after
// filling the arrays
__device__ void bitonic_sort(float* v, int* id, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x)
        compare_swap(v, id, t, size, stride);
      __syncthreads();
    }
}

// the same by one warp, on a list only that warp touches
__device__ void warp_bitonic_sort(float* v, int* id, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n / 2; t += 32) compare_swap(v, id, t, size, stride);
      __syncwarp();
    }
}

// cut a warp's candidate list of nb entries (capacity cap, a power of
// two) to its top K, in order; returns the new length
__device__ int warp_keep_top(float* v, int* id, int nb, int cap, int K) {
  for (int i = nb + (threadIdx.x & 31); i < cap; i += 32) {
    v[i] = -INFINITY;
    id[i] = INT_MAX;
  }
  warp_bitonic_sort(v, id, cap);
  return K;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct NmsArgs {
  MapView m;
  const int* valid_h;
  const int* valid_w;
  int C, K, cap;  // cap: a candidate list's capacity, pow2 >= K + 32
  float thre;
  int tiles_x, ntiles;
  float* tile_val;  // [N][C][ntiles][K]
  int* tile_idx;    // [N][C][ntiles][K]
  int* tile_n;      // [N][C][ntiles]: kept count of the band
};

// channels padded to an even count: a warp reads float2 channel pairs
__host__ __device__ __forceinline__ int padded_channels(int C) {
  return (C + 1) & ~1;
}

// dynamic shared memory of peaks_nms_kernel: the two stages, the
// candidate lists, the row and column tables
__host__ __device__ inline size_t nms_smem_bytes(int C, int cap) {
  const int cp = padded_channels(C);
  return (size_t)NBUF * STAGE_ROWS * HALO_W * cp * sizeof(float) +
         (size_t)cp * cap * (sizeof(float) + sizeof(int)) +
         (size_t)2 * (IN_ROWS + HALO_W) * sizeof(int);
}

// One warp's channel: append this row's kept pixels (ballot) to the
// channel's candidate list, cutting the list to its top K first when the
// row would overflow it.
__device__ __forceinline__ void append_kept(float* v, int* id, int& nb,
                                            int& tot, unsigned ballot,
                                            bool keep, float val, int idx,
                                            int cap, int K) {
  const int cnt = __popc(ballot);
  if (nb + cnt > cap) nb = warp_keep_top(v, id, nb, cap, K);
  if (keep) {
    const int lane = threadIdx.x & 31;
    const int p = nb + __popc(ballot & ((1u << lane) - 1u));
    v[p] = val;
    id[p] = idx;
  }
  nb += cnt;
  tot += cnt;
}

// One warp's channel at the end of the band: its count and at most K
// candidates (its top K when it kept more) to the band's slot.
__device__ __forceinline__ void write_band(const NmsArgs& a, float* v,
                                           int* id, int nb, int tot, int n,
                                           int c) {
  if (nb > a.K) nb = warp_keep_top(v, id, nb, a.cap, a.K);
  __syncwarp();
  const long long slot = ((long long)n * a.C + c) * a.ntiles + blockIdx.x;
  for (int i = threadIdx.x & 31; i < nb; i += 32) {
    a.tile_val[slot * a.K + i] = v[i];
    a.tile_idx[slot * a.K + i] = id[i];
  }
  if ((threadIdx.x & 31) == 0) a.tile_n[slot] = tot;
}

template <int CT>
__global__ void __launch_bounds__(CT > 0 ? 32 * ((CT + 1) / 2)
                                         : 32 * MAX_PAIRS)
peaks_nms_kernel(NmsArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int C = CT > 0 ? CT : a.C;
  const int cp = padded_channels(C);
  const int stage_floats = STAGE_ROWS * HALO_W * cp;
  float* stage = smem;                    // [NBUF][STAGE_ROWS][HALO_W][cp]
  float* cand_v = smem + NBUF * stage_floats;  // [cp][cap]
  int* cand_i = (int*)(cand_v + cp * a.cap);  // [cp][cap]
  int* row_off = cand_i + cp * a.cap;        // [IN_ROWS]
  int* row_ok = row_off + IN_ROWS;           // [IN_ROWS]
  int* col_off = row_ok + IN_ROWS;           // [HALO_W]
  int* col_ok = col_off + HALO_W;            // [HALO_W]

  const MapView& m = a.m;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, pair = tid >> 5;
  const int n = blockIdx.y;
  const int y0 = (blockIdx.x / a.tiles_x) * BAND_H;
  const int x0 = (blockIdx.x % a.tiles_x) * BAND_W;
  const int vh = a.valid_h[n], vw = a.valid_w[n];

  // reflect-padded source row / column of each halo position, and whether
  // it lies in the valid region; positions past the map's far edge + 1
  // are no pixel's neighbour, the clamp only keeps their reads in the map
  for (int r = tid; r < IN_ROWS; r += nthr) {
    const int y = min(max(reflect_index(y0 - 1 + r, m.h), 0), m.h - 1);
    row_off[r] = n * m.sn + y * m.sh;
    row_ok[r] = y < vh;
  }
  for (int p = tid; p < HALO_W; p += nthr) {
    const int x = min(max(reflect_index(x0 - 1 + p, m.w), 0), m.w - 1);
    col_off[p] = x * m.sw;
    col_ok[p] = x < vw;
  }
  __syncthreads();

  // a thread's copies of one halo row: the serve instantiation's 8-byte
  // copies are the same for every row, so their offsets are made once
  constexpr int Q = CT / 2;  // 8-byte chunks of a pixel's slice
  constexpr int NT = 32 * Q;  // threads of the serve instantiation
  constexpr int J = CT > 0 ? (HALO_W * Q + NT - 1) / NT : 1;
  int src_c[J], dst_c[J];
  if constexpr (CT > 0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = tid + j * NT;
      const int p = e / Q, q = e - (e / Q) * Q;
      src_c[j] = e < HALO_W * Q ? col_off[p] + 2 * q : -1;
      dst_c[j] = p * CT + 2 * q;
    }
  }

  auto issue = [&](int s) {
    float* buf = stage + (s % NBUF) * stage_floats;
    for (int rr = 0; rr < STAGE_ROWS; ++rr) {
      const float* src = m.p + row_off[s * STAGE_ROWS + rr];
      float* dst = buf + rr * HALO_W * cp;
      if constexpr (CT > 0) {
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (src_c[j] >= 0) cp_async8(dst + dst_c[j], src + src_c[j]);
      } else {
        for (int e = tid; e < HALO_W * C; e += nthr) {
          const int p = e / C, c = e - p * C;
          cp_async4(dst + p * cp + c, src + (col_off[p] + c * m.sc));
        }
      }
    }
    cp_async_commit();
  };

  const int ca = 2 * pair, cb = 2 * pair + 1;
  const bool has_b = cb < C;  // an odd C's last pair has one channel
  float* va = cand_v + ca * a.cap;
  int* ia = cand_i + ca * a.cap;
  float* vb = cand_v + cb * a.cap;
  int* ib = cand_i + cb * a.cap;
  int nba = 0, nbb = 0, tota = 0, totb = 0;
  const int x = x0 + lane;
  const bool col_in = x < m.w;
  const bool ok_l = col_ok[lane], ok_c = col_ok[lane + 1],
             ok_r = col_ok[lane + 2];
  float2 hm0 = make_float2(0.f, 0.f), hm1 = hm0, ctr = hm0;

  for (int s = 0; s < NBUF - 1; ++s) issue(s);
  for (int s = 0; s < NSTAGES; ++s) {
    // stage s has landed (only the NBUF - 2 later ones may be in flight),
    // for every thread; and every thread is done with stage s - 1, whose
    // buffer the next issue reuses
    cp_async_wait<NBUF - 2>();
    __syncthreads();
    if (s + NBUF - 1 < NSTAGES)
      issue(s + NBUF - 1);
    else
      cp_async_commit();  // an empty group keeps the count of groups even
    const float* buf = stage + (s % NBUF) * stage_floats;
    for (int rr = 0; rr < STAGE_ROWS; ++rr) {
      const int r = s * STAGE_ROWS + rr;
      const float* row = buf + rr * HALO_W * cp + 2 * pair;
      const bool rok = row_ok[r];
      float2 l = *(const float2*)(row + lane * cp);
      float2 c = *(const float2*)(row + (lane + 1) * cp);
      float2 rt = *(const float2*)(row + (lane + 2) * cp);
      if (!(rok && ok_l)) l = make_float2(NEG_MASK, NEG_MASK);
      if (!(rok && ok_c)) c = make_float2(NEG_MASK, NEG_MASK);
      if (!(rok && ok_r)) rt = make_float2(NEG_MASK, NEG_MASK);
      const float2 hm = make_float2(fmaxf(fmaxf(l.x, c.x), rt.x),
                                    fmaxf(fmaxf(l.y, c.y), rt.y));
      if (r >= 2) {  // output row y0 + r - 2: input rows r-2, r-1, r
        const int y = y0 + r - 2;
        const bool in_map = col_in && y < m.h;
        const float mxa = fmaxf(fmaxf(hm0.x, hm1.x), hm.x);
        const float mxb = fmaxf(fmaxf(hm0.y, hm1.y), hm.y);
        const bool ka = in_map && mxa == ctr.x && ctr.x >= a.thre;
        const bool kb = has_b && in_map && mxb == ctr.y && ctr.y >= a.thre;
        const unsigned ba = __ballot_sync(FULL_MASK, ka);
        const unsigned bb = __ballot_sync(FULL_MASK, kb);
        const int idx = y * m.w + x;
        if (ba)
          append_kept(va, ia, nba, tota, ba, ka, ctr.x, idx, a.cap, a.K);
        if (bb)
          append_kept(vb, ib, nbb, totb, bb, kb, ctr.y, idx, a.cap, a.K);
      }
      hm0 = hm1;
      hm1 = hm;
      ctr = c;
    }
  }

  __syncwarp();
  write_band(a, va, ia, nba, tota, n, ca);
  if (has_b) write_band(a, vb, ib, nbb, totb, n, cb);
}

template <int RT>
__global__ void __launch_bounds__(SEL_THREADS)
peaks_select_kernel(MapView m, const int* __restrict__ valid_h,
                    const int* __restrict__ valid_w, int C, float thre,
                    int K, int radius, int ntiles,
                    const float* __restrict__ tile_val,
                    const int* __restrict__ tile_idx,
                    const int* __restrict__ tile_n, int* __restrict__ count,
                    int* __restrict__ xs, int* __restrict__ ys,
                    float* __restrict__ x_ref, float* __restrict__ y_ref,
                    float* __restrict__ score,
                    unsigned char* __restrict__ valid) {
  __shared__ float sv[SEL_BUF];
  __shared__ int si[SEL_BUF];
  __shared__ int fill, got, warp_off[SEL_THREADS / 32];
  const int c = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long nc = (long long)n * C + c;
  const int vh = valid_h[n], vw = valid_w[n];
  const int hw = m.h * m.w;
  const int* tn = tile_n + nc * ntiles;
  const float* tv = tile_val + nc * ntiles * K;
  const int* ti = tile_idx + nc * ntiles * K;

  // the channel's true kept count: the sum of its bands' counts
  int part = 0;
  for (int t = tid; t < ntiles; t += nthr) part += tn[t];
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL_MASK, part, o);
  if (lane == 0) warp_off[warp] = part;
  __syncthreads();
  int cnt = 0;
  for (int w = 0; w < nthr / 32; ++w) cnt += warp_off[w];
  if (tid == 0) {
    count[nc] = cnt;
    fill = 0;
  }
  __syncthreads();

  if (cnt <= SEL_BUF) {
    // every band's candidates fit: gather (any order), sort once
    for (int t = tid; t < ntiles; t += nthr) {
      const int k = min(tn[t], K);
      if (k) {
        const int b = atomicAdd(&fill, k);
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
    // merge the bands in rounds of g bands through [K, SEL_BUF)
    const int g = (SEL_BUF - K) / K;
    for (int i = tid; i < K; i += nthr) {
      sv[i] = -INFINITY;
      si[i] = INT_MAX;
    }
    for (int g0 = 0; g0 < ntiles; g0 += g) {
      for (int e = tid; e < SEL_BUF - K; e += nthr) {
        const int t = g0 + e / K, j = e % K;
        const bool ok = e / K < g && t < ntiles && j < min(tn[t], K);
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
  for (int base = 0; got < need && base < hw; base += nthr) {
    const int j = base + tid;
    float v;
    const bool free_slot =
        j < hw && !pixel_kept(m, n, c, j / m.w, j % m.w, vh, vw, thre, &v);
    const unsigned ballot = __ballot_sync(FULL_MASK, free_slot);
    if (lane == 0) warp_off[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int w = 0; w < nthr / 32; ++w) {
        const int s = warp_off[w];
        warp_off[w] = acc;
        acc += s;
      }
      fill = acc;
    }
    __syncthreads();
    if (free_slot) {
      const int r = got + warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));
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
  const int r = RT > 0 ? RT : radius;
  // the window mean as sum * (1/area), the reciprocal rounded to float
  // first: XLA's arithmetic for the mean
  const float area_inv = 1.0f / (float)((2 * r + 1) * (2 * r + 1));
  for (int s = tid; s < K; s += nthr) {
    const float val = sv[s];
    const int id = si[s];
    const int y = id / m.w, x = id % m.w;
    float total = 0.0f, sx = 0.0f, sy = 0.0f;
    if constexpr (RT > 0) {
      // a compile-time window: all its loads issue before the first add
      constexpr int D = 2 * RT + 1;
      float b[D * D];
#pragma unroll
      for (int i = 0; i < D * D; ++i)
        b[i] = map_at(m, n, c, min(max(y + i / D - RT, 0), m.h - 1),
                      min(max(x + i % D - RT, 0), m.w - 1));
#pragma unroll
      for (int i = 0; i < D * D; ++i) {
        total += b[i];
        sx += b[i] * (float)(i % D - RT);
        sy += b[i] * (float)(i / D - RT);
      }
    } else {
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

// Number of NMS bands of an H x W map: the caller sizes the scratch by it.
extern "C" int ibp_topk_peaks_tiles(int H, int W) {
  return ((H + BAND_H - 1) / BAND_H) * ((W + BAND_W - 1) / BAND_W);
}

// Launch both passes on `stream`.  Scratch (tile buffers of
// N*C*ntiles*K entries and tile_n of N*C*ntiles, ntiles from
// ibp_topk_peaks_tiles) comes from the caller; every output is written
// (count too: no zero-fill).  `valid` is one byte an entry (a torch.bool
// tensor).  Returns the cudaError_t of the launches (0 = success).
extern "C" int ibp_topk_peaks(const float* heat, long long sn, long long sh,
                              long long sw, long long sc, int N, int H,
                              int W, int C, const int* valid_h,
                              const int* valid_w, float thre, int K,
                              int radius, float* tile_val, int* tile_idx,
                              int* tile_n, int* count, int* xs, int* ys,
                              float* x_ref, float* y_ref, float* score,
                              unsigned char* valid, void* stream) {
  int cap = 32;
  while (cap < K + 32) cap <<= 1;
  const size_t smem = nms_smem_bytes(C, cap);
  if (K < 1 || K > MAX_K || K > (long long)H * W || radius < 0 || C < 1 ||
      C > 2 * MAX_PAIRS || smem > 227 * 1024 ||
      !offsets_fit_int32(sn, sh, sw, sc, N, H, W, C))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const MapView m{heat, (int)sn, (int)sh, (int)sw, (int)sc, H, W};
  const int tiles_x = (W + BAND_W - 1) / BAND_W;
  const int ntiles = ibp_topk_peaks_tiles(H, W);
  const NmsArgs a{m, valid_h, valid_w, C, K, cap, thre, tiles_x, ntiles,
                  tile_val, tile_idx, tile_n};
  // the serve lane's instantiation needs 8-byte-aligned channel pairs
  const bool serve = C == SERVE_C && sc == 1 && sn % 2 == 0 &&
                     sh % 2 == 0 && sw % 2 == 0 &&
                     ((uintptr_t)heat & 7) == 0;
  const dim3 grid(ntiles, N);
  const int threads = 32 * (padded_channels(C) / 2);
  cudaError_t e;
  if (serve) {
    e = cudaFuncSetAttribute(peaks_nms_kernel<SERVE_C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    peaks_nms_kernel<SERVE_C><<<grid, threads, smem, st>>>(a);
  } else {
    e = cudaFuncSetAttribute(peaks_nms_kernel<0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    peaks_nms_kernel<0><<<grid, threads, smem, st>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 sel_grid(C, N);
  if (radius == SERVE_R)
    peaks_select_kernel<SERVE_R><<<sel_grid, SEL_THREADS, 0, st>>>(
        m, valid_h, valid_w, C, thre, K, radius, ntiles, tile_val, tile_idx,
        tile_n, count, xs, ys, x_ref, y_ref, score, valid);
  else
    peaks_select_kernel<0><<<sel_grid, SEL_THREADS, 0, st>>>(
        m, valid_h, valid_w, C, thre, K, radius, ntiles, tile_val, tile_idx,
        tile_n, count, xs, ys, x_ref, y_ref, score, valid);
  return (int)cudaGetLastError();
}

// The read floor of pass (a) on this layout, for chip_smoke.py: a kernel
// that reads every pixel's C-channel slice once, with coalesced 8-byte
// loads, and nothing else (no halo, no NMS).  DRAM moves 64-byte atoms,
// so a 72-byte slice in a 200-byte record costs two of them.
__global__ void peaks_read_probe(const float* __restrict__ p, int pixels,
                                 int sw, int pairs, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = e / pairs, q = e - px * pairs;
  if (px >= pixels) return;
  const float2 v = __ldg((const float2*)(p + px * sw) + q);
  if (v.x == 12345.f && v.y == -12345.f) out[0] = v.x;  // keeps the load
}

// Launch the probe over N*H*W pixels of a view whose pixels are evenly
// strided by sw (a channel slice of contiguous maps) with an even C and
// 8-byte-aligned slices.
extern "C" int ibp_peaks_read_probe(const float* heat, int pixels, int sw,
                                    int C, float* out, void* stream) {
  if (C % 2 || sw % 2 || ((uintptr_t)heat & 7) ||
      (long long)pixels * sw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long work = (long long)pixels * (C / 2);
  peaks_read_probe<<<(unsigned)((work + 255) / 256), 256, 0,
                     (cudaStream_t)stream>>>(heat, pixels, sw, C / 2, out);
  return (int)cudaGetLastError();
}
