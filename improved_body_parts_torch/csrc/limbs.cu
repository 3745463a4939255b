// Dense limb-pair sampling statistics on Hopper (sm_90a).
//
// Replaces the TPU kernel limb_pair_stats_pallas / _limbs_kernel
// (improved_body_parts_tpu/ops/pallas_peaks.py:171, pallas_call at
// l.224), which keeps one limb's whole PAF channel in VMEM while it
// samples all K x K candidate segments.  A serve-size channel (640x896,
// 2.3 MB) exceeds a block's 227 KB of shared memory, so here the samples
// are gathered straight from device memory through L2 and the read-only
// cache: one thread per (image, limb, A slot, B slot) walks that pair's
// m = min(round(|B-A| + 1), S) nearest-pixel samples in order and writes
// the mean, the count above thre2, m and |B-A|.  Neighbouring threads
// share A and sample along nearby segments, so their gathers hit the
// same cache lines.
//
// Bound on this card: bytes -- at most N x L x K x K x S gathered floats
// (the run's sum of m counts what the data needs) plus four
// N x L x K x K outputs (1.97 MB per image at L=30, K=64).
//
// Exactness: the JAX package's XLA path computes px = ax + t*vx and
// vx*vx + vy*vy as fused multiply-adds (measured on its CPU backend), so
// this kernel calls fmaf at exactly those two places and is built with
// --fmad=false and without --use_fast_math, so that nvcc contracts
// nothing else: one more or one fewer rounding can flip rintf at .5 and
// read another pixel.  sqrtf and the divisions are IEEE, and rintf
// rounds half to even like jnp.round.
#include "common.cuh"

#define LIMB_THREADS 256

__global__ void __launch_bounds__(LIMB_THREADS)
limb_pair_stats_kernel(MapView paf, const float* __restrict__ x_ref,
                       const float* __restrict__ y_ref,
                       const int* __restrict__ limbs_from,
                       const int* __restrict__ limbs_to, int N, int C, int L,
                       int K, int S, float thre2, float* __restrict__ mean,
                       int* __restrict__ above, int* __restrict__ m_out,
                       float* __restrict__ norm_out) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)N * L * K * K;
  if (gid >= total) return;
  const int b = (int)(gid % K);
  long long r = gid / K;
  const int a = (int)(r % K);
  r /= K;
  const int l = (int)(r % L);
  const int n = (int)(r / L);

  const long long pa = ((long long)n * C + limbs_from[l]) * K + a;
  const long long pb = ((long long)n * C + limbs_to[l]) * K + b;
  const float ax = x_ref[pa], ay = y_ref[pa];
  const float bx = x_ref[pb], by = y_ref[pb];
  const float vx = bx - ax, vy = by - ay;
  const float norm = sqrtf(fmaf(vx, vx, vy * vy));
  const int m = (int)fminf(rintf(norm + 1.0f), (float)S);
  const float denom = (float)max(m - 1, 1);

  float sum = 0.0f;
  int count = 0;
  for (int s = 0; s < m; ++s) {
    const float t = fminf((float)s / denom, 1.0f);
    const float px = fmaf(t, vx, ax);
    const float py = fmaf(t, vy, ay);
    const int xi = min(max((int)rintf(px), 0), paf.w - 1);
    const int yi = min(max((int)rintf(py), 0), paf.h - 1);
    const float v = map_at(paf, n, l, yi, xi);
    sum += v;
    count += v > thre2;
  }
  mean[gid] = sum / (float)max(m, 1);
  above[gid] = count;
  m_out[gid] = m;
  norm_out[gid] = norm;
}

// Launch on `stream`; paf is a strided (N, H, W, L) view, x_ref/y_ref are
// contiguous (N, C, K), outputs contiguous (N, L, K, K).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int ibp_limb_pair_stats(const float* paf, long long sn,
                                   long long sh, long long sw, long long sc,
                                   int N, int H, int W, int L,
                                   const float* x_ref, const float* y_ref,
                                   int C, int K, const int* limbs_from,
                                   const int* limbs_to, int S, float thre2,
                                   float* mean, int* above, int* m_out,
                                   float* norm_out, void* stream) {
  if (K < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * L * K * K;
  if (total == 0) return (int)cudaSuccess;
  MapView m{paf, sn, sh, sw, sc, H, W};
  const unsigned blocks =
      (unsigned)((total + LIMB_THREADS - 1) / LIMB_THREADS);
  limb_pair_stats_kernel<<<blocks, LIMB_THREADS, 0, (cudaStream_t)stream>>>(
      m, x_ref, y_ref, limbs_from, limbs_to, N, C, L, K, S, thre2, mean,
      above, m_out, norm_out);
  return (int)cudaGetLastError();
}
