// Greedy person assembly on Hopper (sm_90a): the walk and the person-table
// rules of one image in one block.
//
// Replaces the TPU kernel candidate_walk_pallas / _walk_kernel
// (improved_body_parts_tpu/ops/pallas_assembly.py:28, pallas_call at l.75)
// together with the rules XLA ran around it: greedy_assemble of
// improved_body_parts_tpu/ops/assembly.py:89-323, a lax.while_loop per limb
// inside a fori_loop.  Per image, in limb order:
//
//  1. the walk: over the limb's rank-ordered candidates, take one when it
//     is valid, fewer than limit = min(count_a, count_b) (each capped at
//     K) are taken and neither endpoint slot is used yet (l.266-303);
//  2. the rules: each taken connection goes through `process` (l.124-264)
//     in walk order -- the first two owners in table order (_first_two,
//     l.69); none: spawn (person_overflow when the table is full); one:
//     assign / replace / rescore part B; two, disjoint: merge unless
//     refused; two, overlapping: compete, only when remove_recon > 0;
//  3. the prune (l.307-323): npart >= min_parts and
//     tot / max(npart, 1) >= min_mean_score.
//
// What bounds it on this card: latency, not bytes.  An image's inputs are
// ~75 KB (30 x 128 candidates of 17 B, 18 x 64 peak scores) and its output
// 5 KB, a few microseconds of one SM's share of device memory; the work
// is a chain of dependent steps (each walk step reads the used-masks the
// last one wrote, each rule reads the table the last one wrote).  So:
//
//  - One block per image.  Its 4 warps stage everything the chain reads
//    into shared memory with 4-byte cp.async copies, all in flight
//    together (the peak scores, every limb's M candidates, the limb
//    endpoints and peak counts), then warps 1-3 leave and warp 0 runs the
//    chain: no __syncthreads in it, and no step waits on device memory.
//  - Warp 0 walks a limb 32 candidates at a time: each lane reads its
//    candidate and the used-masks, a ballot gives the free ones, and the
//    first free one is taken; a second ballot drops the lanes that share
//    an endpoint slot with it.  That is the sequential walk exactly, one
//    ballot round per taken connection instead of one step per candidate.
//  - The table (P rows x parts) lives in shared memory, column-major with
//    a padded column (P + 1 words): lane l owns rows l + 32 i, so the
//    owner search is one conflict-free read of the two endpoint columns
//    and one __ballot_sync per 32 rows, and __ffs gives j1 and j2 in row
//    order; merge reads and writes the 18 parts of rows j1 and j2 one part
//    a lane, also conflict-free.  Scalar rules are computed by every lane
//    from broadcast reads and written by lane 0 after a __syncwarp.
//
// Limits: P <= 128 (4 rows a lane), parts <= 32 (a part a lane), K <= 1024,
// M <= 1024, and everything staged within the 227 KB of shared memory a
// block can use (asm_layout below); the wrapper refuses anything past them.
// The serve lane runs P = 32, K = 64, M = 128, 18 parts and 30 limbs
// (75.4 KB).
//
// Bits.  Every float operation is the plain version's, in its order, one
// IEEE-rounded op at a time (ops/cuda_assembly.py greedy_assemble_plain,
// itself XLA's order in the JAX package):
//   spawn   tot = (psa + psb) + score                          (l.148)
//   one     grow_ok: len_rate * maxlen[j1] > limb_len          (l.162)
//           assign:  tot + (psb + score); npart + 1            (l.170)
//           update:  tot + (((psb + score) - old_p) - conf_b)  (l.171)
//   merge   refuse:  score < connection_tole * min_tol
//                    or len_rate * maxlen[j1] <= limb_len       (l.199-200)
//           ids ids1 + ids2 + 1 in int32, conf (conf1 + conf2) + 1
//           (l.205-206), tot (tot1 + tot2) + score (l.214),
//           npart npart1 + npart2
//   compete tot - (old_p + old_conf), npart - 1                (l.254-256)
//   prune   tot / max(npart, 1) >= min_mean_score, an IEEE division
//           (l.308-310)
// min_tol is a minimum, exact in any order.  Why --fmad=false
// (ops/_build.py) matters: nvcc contracts a product feeding an add or a
// subtraction into one fused multiply-add, which rounds once where the
// plain version (PyTorch, one rounded op each) rounds twice.  The rules as
// written hold no such pair (their two products only feed comparisons),
// and the flag keeps any rule that gains one, such as a rescaled score,
// equal to the plain version bit for bit rather than within an ulp.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ASM_WARPS 4  // warps that stage the inputs; warp 0 runs the chain
#define ASM_THREADS (32 * ASM_WARPS)
#define ASM_MAX_P 128
#define ASM_MAX_PARTS 32
#define ASM_MAX_K 1024
#define ASM_MAX_M 1024
#define ASM_SMEM_LIMIT 232448  // bytes of shared memory a block can use

struct AsmArgs {
  const float* score;          // (N, C, K) peak scores
  const int* pcount;           // (N, C) true peak counts
  const int* slot_a;           // (N, L, M) candidate endpoint slots
  const int* slot_b;
  const float* prior;          // (N, L, M) connection scores
  const float* norm;           // (N, L, M) limb lengths
  const unsigned char* valid;  // (N, L, M) bool
  const int* ccount;           // (N, L) true accepted-pair counts
  const int* limbs;            // (2L) limb endpoint channels, from then to
  int C, K, L, M, P, parts, remove_recon;
  float len_rate, connection_tole, min_parts, min_mean_score;
  float* subset;               // (N, P, parts + 2, 2)
  unsigned char* mask;         // (N, P) bool
  int* n_people;               // (N)
  unsigned char* peak_overflow;    // (N) bool
  unsigned char* cand_overflow;    // (N) bool
  unsigned char* person_overflow;  // (N) bool
};

// Byte offsets of the staged inputs and the table in shared memory.
struct AsmLayout {
  long long pscore, ids, conf, tot, npart, maxlen, active, pcount, limbs,
      sa, sb, prior, norm, valid, used, bytes;
};

__host__ __device__ inline AsmLayout asm_layout(int C, int K, int L, int M,
                                                int P, int parts) {
  AsmLayout o;
  const long long lm = (long long)L * M, col = P + 1;
  long long b = 0;
  o.pscore = b; b += 4LL * C * K;
  o.ids = b;    b += 4LL * parts * col;
  o.conf = b;   b += 4LL * parts * col;
  o.tot = b;    b += 4LL * P;
  o.npart = b;  b += 4LL * P;
  o.maxlen = b; b += 4LL * P;
  o.active = b; b += 4LL * P;
  o.pcount = b; b += 4LL * C;
  o.limbs = b;  b += 8LL * L;
  o.sa = b;     b += 4 * lm;
  o.sb = b;     b += 4 * lm;
  o.prior = b;  b += 4 * lm;
  o.norm = b;   b += 4 * lm;
  o.valid = b;  b += (lm + 3) / 4 * 4;
  o.used = b;   b += (2LL * K + 3) / 4 * 4;
  o.bytes = b;
  return o;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n 4-byte words from global to shared memory, spread over the block.
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int n) {
  const uint32_t* s = (const uint32_t*)src;
  uint32_t* d = (uint32_t*)dst;
  for (int i = threadIdx.x; i < n; i += ASM_THREADS) cp_async4(d + i, s + i);
}

// The person table and the staged scores, in shared memory.
struct Table {
  int* ids;      // ids[part * col + row], -1 = empty
  float* conf;   // conf[part * col + row]
  float* tot;
  float* npart;
  float* maxlen;
  int* active;
  const float* pscore;  // flat id c * K + slot -> peak score
  int col, ck;
};

// One taken connection (part ia slot sa -> part ib slot sb) through the
// found in {0, 1, 2} rules.  Called by the whole of warp 0 with the same
// arguments; `count` (rows allocated) and `overflow` are the warp's
// uniform registers.
template <int RPL>
__device__ __forceinline__ void process(const Table& t, const AsmArgs& a,
                                        int ia, int ib, int sa, int sb,
                                        float score, float limb_len,
                                        int& count, bool& overflow) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const int col = t.col;
  const int aid = ia * a.K + sa, bid = ib * a.K + sb;
  const float psa = t.pscore[aid], psb = t.pscore[bid];

  // the first two owners in table order; rows past `count` are unused
  int j1 = -1, j2 = -1;
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    if (q * 32 >= count || j2 >= 0) break;
    const int r = q * 32 + lane;
    const bool match = r < count && t.active[r] != 0 &&
                       (t.ids[ia * col + r] == aid ||
                        t.ids[ib * col + r] == bid);
    unsigned b = __ballot_sync(full, match);
    if (j1 < 0 && b) {
      j1 = q * 32 + __ffs(b) - 1;
      b &= b - 1;
    }
    if (j2 < 0 && b) j2 = q * 32 + __ffs(b) - 1;
  }

  if (j1 < 0) {
    // spawn: a new person at the next free row, or the overflow flag
    if (count < a.P) {
      const int r = count;
      if (lane == 0) {
        t.ids[ia * col + r] = aid;
        t.ids[ib * col + r] = bid;
        t.conf[ia * col + r] = score;
        t.conf[ib * col + r] = score;
        t.tot[r] = (psa + psb) + score;
        t.npart[r] = 2.0f;
        t.maxlen[r] = limb_len;
        t.active[r] = 1;
      }
      ++count;
    } else {
      overflow = true;
    }
  } else if (j2 < 0) {
    // one owner: assign / replace / rescore part B on row j1
    const int j = j1;
    const int old_b = t.ids[ib * col + j];
    const float conf_b = t.conf[ib * col + j];
    const float ml = t.maxlen[j];
    const float tot = t.tot[j];
    const float np = t.npart[j];
    const bool grow_ok = a.len_rate * ml > limb_len;
    const bool do_assign = old_b == -1 && grow_ok;
    const bool do_update =
        !do_assign &&
        (old_b == bid ? conf_b <= score : (conf_b < score && grow_ok));
    __syncwarp();
    if (lane == 0 && (do_assign || do_update)) {
      t.ids[ib * col + j] = bid;
      t.conf[ib * col + j] = score;
      t.maxlen[j] = fmaxf(ml, limb_len);
      if (do_assign) {
        t.tot[j] = tot + (psb + score);
        t.npart[j] = np + 1.0f;
      } else {
        const float old_p = t.pscore[min(max(old_b, 0), t.ck - 1)];
        t.tot[j] = tot + (((psb + score) - old_p) - conf_b);
      }
    }
  } else {
    const bool in = lane < a.parts;
    const int i1 = in ? t.ids[lane * col + j1] : -1;
    const int i2 = in ? t.ids[lane * col + j2] : -1;
    const float c1 = in ? t.conf[lane * col + j1] : 0.0f;
    const float c2 = in ? t.conf[lane * col + j2] : 0.0f;
    const bool m1 = i1 >= 0, m2 = i2 >= 0;
    if (!__any_sync(full, m1 && m2)) {
      // two disjoint owners: merge j2 into j1 unless refused
      float v = fminf(m1 ? c1 : INFINITY, m2 ? c2 : INFINITY);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = fminf(v, __shfl_xor_sync(full, v, off));
      const float ml1 = t.maxlen[j1];
      const bool refuse = score < a.connection_tole * v ||
                          a.len_rate * ml1 <= limb_len;
      if (!refuse) {
        const float t1 = t.tot[j1], t2 = t.tot[j2];
        const float n1 = t.npart[j1], n2 = t.npart[j2];
        __syncwarp();
        if (in) {
          t.ids[lane * col + j1] = i1 + i2 + 1;
          t.conf[lane * col + j1] = (c1 + c2) + 1.0f;
          t.ids[lane * col + j2] = -1;
          t.conf[lane * col + j2] = -1.0f;
        }
        if (lane == 0) {
          t.tot[j1] = (t1 + t2) + score;
          t.npart[j1] = n1 + n2;
          // j2's longest limb is deliberately not folded in
          t.maxlen[j1] = fmaxf(ml1, limb_len);
          t.tot[j2] = 0.0f;
          t.npart[j2] = 0.0f;
          t.maxlen[j2] = -1.0f;
          t.active[j2] = 0;
        }
      }
    } else if (a.remove_recon > 0) {
      // two owners sharing a part compete for this limb
      const bool a_in_1 = t.ids[ia * col + j1] == aid;
      const int p1 = a_in_1 ? ia : ib, p2 = a_in_1 ? ib : ia;
      const float conf_11 = t.conf[p1 * col + j1];
      const float conf_22 = t.conf[p2 * col + j2];
      if (!(score < conf_11 && score < conf_22)) {
        const bool small_is_2 = conf_11 > conf_22;
        const int sj = small_is_2 ? j2 : j1, rc = small_is_2 ? p2 : p1;
        const int old_id = t.ids[rc * col + sj];
        const float old_conf = t.conf[rc * col + sj];
        const float old_p = t.pscore[min(max(old_id, 0), t.ck - 1)];
        const float tot = t.tot[sj], np = t.npart[sj];
        __syncwarp();
        if (lane == 0) {
          t.ids[rc * col + sj] = -1;
          t.conf[rc * col + sj] = -1.0f;
          t.tot[sj] = tot - (old_p + old_conf);
          t.npart[sj] = np - 1.0f;
        }
      }
    }
  }
  __syncwarp();
}

// One block of ASM_THREADS per image; RPL = ceil(P / 32) table rows a lane.
template <int RPL>
__global__ void __launch_bounds__(ASM_THREADS, 1)
greedy_assemble_kernel(const AsmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AsmLayout o = asm_layout(a.C, a.K, a.L, a.M, a.P, a.parts);
  const int n = blockIdx.x, tid = threadIdx.x;
  const int ck = a.C * a.K, lm = a.L * a.M, col = a.P + 1;
  Table t;
  t.ids = (int*)(smem + o.ids);
  t.conf = (float*)(smem + o.conf);
  t.tot = (float*)(smem + o.tot);
  t.npart = (float*)(smem + o.npart);
  t.maxlen = (float*)(smem + o.maxlen);
  t.active = (int*)(smem + o.active);
  t.pscore = (const float*)(smem + o.pscore);
  t.col = col;
  t.ck = ck;
  int* pcount = (int*)(smem + o.pcount);
  int* limbs = (int*)(smem + o.limbs);
  int* s_sa = (int*)(smem + o.sa);
  int* s_sb = (int*)(smem + o.sb);
  float* s_prior = (float*)(smem + o.prior);
  float* s_norm = (float*)(smem + o.norm);
  unsigned char* s_valid = smem + o.valid;
  unsigned char* used_a = smem + o.used;
  unsigned char* used_b = used_a + a.K;

  // stage: every copy in flight at once, then one wait
  const long long cand = (long long)n * lm;
  stage_words(smem + o.pscore, a.score + (long long)n * ck, ck);
  stage_words(pcount, a.pcount + (long long)n * a.C, a.C);
  stage_words(limbs, a.limbs, 2 * a.L);
  stage_words(s_sa, a.slot_a + cand, lm);
  stage_words(s_sb, a.slot_b + cand, lm);
  stage_words(s_prior, a.prior + cand, lm);
  stage_words(s_norm, a.norm + cand, lm);
  const unsigned char* g_valid = a.valid + cand;
  if (lm % 4 == 0 && ((uintptr_t)g_valid & 3) == 0) {
    stage_words(s_valid, g_valid, lm / 4);
  } else {
    for (int i = tid; i < lm; i += ASM_THREADS) s_valid[i] = g_valid[i];
  }
  for (int i = tid; i < a.parts * col; i += ASM_THREADS) {
    t.ids[i] = -1;
    t.conf[i] = -1.0f;
  }
  for (int i = tid; i < a.P; i += ASM_THREADS) {
    t.tot[i] = 0.0f;
    t.npart[i] = 0.0f;
    t.maxlen[i] = -1.0f;
    t.active[i] = 0;
  }
  for (int i = tid; i < 2 * a.K; i += ASM_THREADS) used_a[i] = 0;
  cp_async_wait_all();
  __syncthreads();
  if (tid >= 32) return;

  // the chain, warp 0 alone
  const unsigned full = 0xffffffffu;
  const int lane = tid;
  int count = 0;
  bool overflow = false;
  for (int li = 0; li < a.L; ++li) {
    const int ia = limbs[li], ib = limbs[a.L + li];
    const int limit = min(min(pcount[ia], a.K), min(pcount[ib], a.K));
    const int base = li * a.M;
    int taken = 0;
    for (int m0 = 0; m0 < a.M && taken < limit; m0 += 32) {
      const int m = m0 + lane;
      int sa = 0, sb = 0;
      bool free_ = false;
      if (m < a.M) {
        sa = min(max(s_sa[base + m], 0), a.K - 1);
        sb = min(max(s_sb[base + m], 0), a.K - 1);
        free_ = s_valid[base + m] != 0 && !used_a[sa] && !used_b[sb];
      }
      unsigned cand_bits = __ballot_sync(full, free_);
      while (cand_bits && taken < limit) {
        // the first free candidate is taken; its endpoint slots block
        // every later lane that shares one
        const int i = __ffs(cand_bits) - 1;
        const int csa = __shfl_sync(full, sa, i);
        const int csb = __shfl_sync(full, sb, i);
        cand_bits &= ~__ballot_sync(full, sa == csa || sb == csb);
        ++taken;
        if (lane == 0) {
          used_a[csa] = 1;
          used_b[csb] = 1;
        }
        process<RPL>(t, a, ia, ib, csa, csb, s_prior[base + m0 + i],
                     s_norm[base + m0 + i], count, overflow);
      }
    }
    __syncwarp();
    for (int k = lane; k < 2 * a.K; k += 32) used_a[k] = 0;
    __syncwarp();
  }

  // prune, and write the table in find_people's row layout
  const int row_len = (a.parts + 2) * 2;
  float* out = a.subset + (long long)n * a.P * row_len;
  int people = 0;
  for (int r0 = 0; r0 < a.P; r0 += 32) {
    const int r = r0 + lane;
    bool keep = false;
    if (r < a.P) {
      const float np = t.npart[r], tot = t.tot[r];
      keep = t.active[r] != 0 && np >= a.min_parts &&
             tot / fmaxf(np, 1.0f) >= a.min_mean_score;
      a.mask[(long long)n * a.P + r] = keep;
    }
    people += __popc(__ballot_sync(full, keep));
  }
  for (int e = lane; e < a.P * row_len; e += 32) {
    const int r = e / row_len, k = e - r * row_len, p = k >> 1;
    float v;
    if (p < a.parts)
      v = (k & 1) ? t.conf[p * col + r] : (float)t.ids[p * col + r];
    else if (p == a.parts)
      v = (k & 1) ? -1.0f : t.tot[r];
    else
      v = (k & 1) ? t.maxlen[r] : t.npart[r];
    out[e] = v;
  }
  bool peak_of = false, cand_of = false;
  for (int c = lane; c < a.C; c += 32) peak_of |= pcount[c] > a.K;
  for (int l = lane; l < a.L; l += 32)
    cand_of |= a.ccount[(long long)n * a.L + l] > a.M;
  peak_of = __any_sync(full, peak_of);
  cand_of = __any_sync(full, cand_of);
  if (lane == 0) {
    a.n_people[n] = people;
    a.peak_overflow[n] = peak_of;
    a.cand_overflow[n] = cand_of;
    a.person_overflow[n] = overflow;
  }
}

template <int RPL>
static int launch(const AsmArgs& a, int N, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      greedy_assemble_kernel<RPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  greedy_assemble_kernel<RPL><<<N, ASM_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Launch on `stream`: one block per image.  Inputs as AsmArgs documents
// them, contiguous; limbs are int32 (2L), limb endpoints < min(C, parts).
// Returns the cudaError_t of the launch (0 = success); sizes past the
// kernel's limits give cudaErrorInvalidValue and launch nothing.
extern "C" int ibp_greedy_assemble(
    const float* score, const int* pcount, const int* slot_a,
    const int* slot_b, const float* prior, const float* norm,
    const unsigned char* valid, const int* ccount, const int* limbs, int N,
    int C, int K, int L, int M, int P, int parts, float len_rate,
    float connection_tole, int remove_recon, float min_parts,
    float min_mean_score, float* subset, unsigned char* mask, int* n_people,
    unsigned char* peak_overflow, unsigned char* cand_overflow,
    unsigned char* person_overflow, void* stream) {
  if (N < 0 || C < 1 || L < 0 || P < 1 || P > ASM_MAX_P || parts < 1 ||
      parts > ASM_MAX_PARTS || K < 1 || K > ASM_MAX_K || M < 1 ||
      M > ASM_MAX_M)
    return (int)cudaErrorInvalidValue;
  const long long bytes = asm_layout(C, K, L, M, P, parts).bytes;
  if (bytes > ASM_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  AsmArgs a;
  a.score = score; a.pcount = pcount; a.slot_a = slot_a; a.slot_b = slot_b;
  a.prior = prior; a.norm = norm; a.valid = valid; a.ccount = ccount;
  a.limbs = limbs;
  a.C = C; a.K = K; a.L = L; a.M = M; a.P = P; a.parts = parts;
  a.remove_recon = remove_recon;
  a.len_rate = len_rate; a.connection_tole = connection_tole;
  a.min_parts = min_parts; a.min_mean_score = min_mean_score;
  a.subset = subset; a.mask = mask; a.n_people = n_people;
  a.peak_overflow = peak_overflow; a.cand_overflow = cand_overflow;
  a.person_overflow = person_overflow;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)bytes;
  switch ((P + 31) / 32) {
    case 1: return launch<1>(a, N, smem, st);
    case 2: return launch<2>(a, N, smem, st);
    case 3: return launch<3>(a, N, smem, st);
    default: return launch<4>(a, N, smem, st);
  }
}
