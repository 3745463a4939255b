// Dense limb-pair sampling statistics on Hopper (sm_90a).
//
// Replaces the TPU kernel limb_pair_stats_pallas / _limbs_kernel
// (improved_body_parts_tpu/ops/pallas_peaks.py:171, pallas_call at
// l.224), which keeps one limb's whole PAF channel in VMEM while it
// samples all K x K candidate segments.  A serve-size channel (640x896,
// 2.3 MB) exceeds a block's 227 KB of shared memory, so here the samples
// are gathered straight from device memory through L2 and the read-only
// cache: one thread per (image, limb, A slot, B slot) takes that pair's
// m = min(round(|B-A| + 1), S) nearest-pixel samples and writes the mean,
// the count above thre2, m and |B-A|.
//
// What bounds it on this card: bytes -- the gathered samples (the run's
// sum of m counts what the data needs) plus four N x L x K x K outputs --
// but a 4-byte sample pulls in a 32-byte sector, so what the gathers need
// is many loads in flight and cache hits.  The design:
//  - S is a compile-time count (20 on the serve lane; a generic
//    instantiation takes any other S): the sample loop is unrolled, all m
//    gathers are issued, predicated on s < m, into registers before the
//    first add, so a thread has up to S loads in flight instead of one;
//  - one block per (image, limb, group of A slots), the blocks of one
//    (image, limb) consecutive, so they run together and that channel's
//    touched sectors stay in the 50 MB L2; lanes are B slots of one A
//    slot, so their early samples share sectors;
//  - the limb's 2K endpoint coordinates are staged in shared memory once
//    a block, with the table of s / (m - 1) (the sample parameter, IEEE
//    division once a block instead of once a sample);
//  - addresses are 32-bit multiply-adds (common.cuh).
//
// Exactness: the JAX package's XLA path computes px = ax + t*vx and
// vx*vx + vy*vy as fused multiply-adds (measured on its CPU backend), so
// this kernel calls fmaf at exactly those two places and is built with
// --fmad=false and without --use_fast_math, so that nvcc contracts
// nothing else: one more or one fewer rounding can flip rintf at .5 and
// read another pixel.  sqrtf and the divisions are IEEE, and rintf
// rounds half to even like jnp.round.  The samples are summed first to
// last with zeros past m, as the plain version sums them.
#include "common.cuh"

#define LIMB_THREADS 256
#define SERVE_S 20  // the serve lane's samples a segment (mid_num)

// dynamic shared memory: ax, ay, bx, by of the limb's K slots, then (for
// a compile-time S) the sample parameters t[d - 1][s] for d = 1..S-1
__host__ __device__ inline int limb_smem_floats(int K, int S, bool table) {
  return 4 * K + (table ? (S > 1 ? S - 1 : 1) * S : 0);
}

template <int ST>
__global__ void __launch_bounds__(LIMB_THREADS)
limb_pair_stats_kernel(MapView paf, const float* __restrict__ x_ref,
                       const float* __restrict__ y_ref,
                       const int* __restrict__ limbs, int C, int L, int K,
                       int S, int groups, float thre2,
                       float* __restrict__ mean, int* __restrict__ above,
                       int* __restrict__ m_out,
                       float* __restrict__ norm_out) {
  extern __shared__ float sm[];
  float* sax = sm;
  float* say = sm + K;
  float* sbx = sm + 2 * K;
  float* sby = sm + 3 * K;
  float* tab = sm + 4 * K;
  if constexpr (ST > 0) S = ST;
  const int nl = blockIdx.x / groups;  // (image, limb)
  const int g = blockIdx.x - nl * groups;
  const int l = nl % L, n = nl / L;
  const int tid = threadIdx.x;

  const int ea = (n * C + limbs[l]) * K, eb = (n * C + limbs[L + l]) * K;
  for (int i = tid; i < K; i += LIMB_THREADS) {
    sax[i] = x_ref[ea + i];
    say[i] = y_ref[ea + i];
    sbx[i] = x_ref[eb + i];
    sby[i] = y_ref[eb + i];
  }
  if constexpr (ST > 0) {
    const int rows = ST > 1 ? ST - 1 : 1;
    for (int e = tid; e < rows * ST; e += LIMB_THREADS) {
      const int d = e / ST + 1, s = e - (d - 1) * ST;
      tab[e] = fminf((float)s / (float)d, 1.0f);
    }
  }
  __syncthreads();

  const int p = g * LIMB_THREADS + tid;  // the pair within (image, limb)
  if (p >= K * K) return;
  const int a = p / K, b = p - a * K;
  const float ax = sax[a], ay = say[a];
  const float vx = sbx[b] - ax, vy = sby[b] - ay;
  const float norm = sqrtf(fmaf(vx, vx, vy * vy));
  const int m = (int)fminf(rintf(norm + 1.0f), (float)S);
  const int d = max(m - 1, 1);
  const float* base = paf.p + (n * paf.sn + l * paf.sc);
  const int wmax = paf.w - 1, hmax = paf.h - 1;

  float sum;
  int count = 0;
  if constexpr (ST > 0) {
    const float* trow = tab + (d - 1) * ST;
    float v[ST];
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      v[s] = 0.0f;
      if (s < m) {
        const float t = trow[s];
        const int xi = min(max((int)rintf(fmaf(t, vx, ax)), 0), wmax);
        const int yi = min(max((int)rintf(fmaf(t, vy, ay)), 0), hmax);
        v[s] = __ldg(base + (yi * paf.sh + xi * paf.sw));
      }
    }
    sum = v[0];
#pragma unroll
    for (int s = 1; s < ST; ++s) sum += v[s];
#pragma unroll
    for (int s = 0; s < ST; ++s) count += (s < m) & (v[s] > thre2);
  } else {
    const float denom = (float)d;
    sum = 0.0f;
    for (int s = 0; s < S; ++s) {
      float v = 0.0f;
      if (s < m) {
        const float t = fminf((float)s / denom, 1.0f);
        const int xi = min(max((int)rintf(fmaf(t, vx, ax)), 0), wmax);
        const int yi = min(max((int)rintf(fmaf(t, vy, ay)), 0), hmax);
        v = __ldg(base + (yi * paf.sh + xi * paf.sw));
        count += v > thre2;
      }
      sum = s == 0 ? v : sum + v;
    }
  }
  const int o = nl * K * K + p;
  mean[o] = sum / (float)max(m, 1);
  above[o] = count;
  m_out[o] = m;
  norm_out[o] = norm;
}

// Launch on `stream`; paf is a strided (N, H, W, L) view, x_ref/y_ref are
// contiguous (N, C, K), limbs holds the L "from" then the L "to" channels
// (device int32), outputs contiguous (N, L, K, K).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int ibp_limb_pair_stats(const float* paf, long long sn,
                                   long long sh, long long sw, long long sc,
                                   int N, int H, int W, int L,
                                   const float* x_ref, const float* y_ref,
                                   int C, int K, const int* limbs, int S,
                                   float thre2, float* mean, int* above,
                                   int* m_out, float* norm_out,
                                   void* stream) {
  const long long pairs = (long long)N * L * K * K;
  const bool serve = S == SERVE_S;
  const size_t smem = limb_smem_floats(K, S, serve) * sizeof(float);
  if (K < 1 || S < 1 || pairs >= (1LL << 31) ||
      (long long)N * C * K >= (1LL << 31) || smem > 48 * 1024 ||
      !offsets_fit_int32(sn, sh, sw, sc, N, H, W, L))
    return (int)cudaErrorInvalidValue;
  if (pairs == 0) return (int)cudaSuccess;
  const MapView m{paf, (int)sn, (int)sh, (int)sw, (int)sc, H, W};
  const int groups = (K * K + LIMB_THREADS - 1) / LIMB_THREADS;
  const unsigned blocks = (unsigned)((long long)N * L * groups);
  cudaStream_t st = (cudaStream_t)stream;
  if (serve)
    limb_pair_stats_kernel<SERVE_S><<<blocks, LIMB_THREADS, smem, st>>>(
        m, x_ref, y_ref, limbs, C, L, K, S, groups, thre2, mean, above,
        m_out, norm_out);
  else
    limb_pair_stats_kernel<0><<<blocks, LIMB_THREADS, smem, st>>>(
        m, x_ref, y_ref, limbs, C, L, K, S, groups, thre2, mean, above,
        m_out, norm_out);
  return (int)cudaGetLastError();
}
