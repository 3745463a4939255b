// Masked focal-L2 loss, forward and backward, on Hopper (sm_90a).
//
// Replaces the TPU kernels of improved_body_parts_tpu/ops/pallas_focal.py:
// focal_l2_pallas / _fwd_kernel (l.28, pallas_call at l.98) and
// _focal_bwd / _bwd_kernel (l.49, pallas_call at l.120).  Per element of
// pred (S, N, H, W, C), with g = gt[n,h,w,c] and m = mask[n,h,w] * chan[c]:
//
//   st     = g >= 0.01 ? p : 1 - p,   factor = |1 - st|,   diff = p - g
//   loss_s = sum over (n, h, w, c) of diff * diff * factor * m
//   dpred  = (2 diff factor + diff diff dfactor) * m * ct[s]
//
// with dfactor = -(1 - p >= 0 ? 1 : -1) where g >= 0.01, else
// (p >= 0 ? 1 : -1): JAX's abs-VJP convention, +-1 at the kink.
//
// Bound on this card: bytes.  Both are streaming passes with a handful of
// flops per element: the forward reads pred, gt and mask once, the
// backward also writes dpred.
//
// The forward is one launch a call.  Each block takes one chunk of the
// (N, H, W, C) range for all S stacks (S <= FOCAL_MAX_S = 8; the canonical
// model has 4), so gt, mask and chan are read once, not once per stack,
// and keeps S double accumulators.  Chunks are a multiple of 1024
// elements, sized by E alone (about FOCAL_TARGET_BLOCKS blocks fill the
// card at 128^2; the 8^2 call takes 13 blocks of one float4 a thread), so
// a shape always reduces in the same order.  A thread finds its pixel and
// channel with one division and then steps both counters; mask is loaded
// once a pixel and chan comes from shared memory.  Each block writes its
// S partial sums, fences, and takes a ticket; the block that draws the
// last ticket sums every stack's partials in index order, writes out[S]
// and sets the ticket back to 0.  No float atomics: the loss is the same
// bits every run.  The ticket is one int per device that the wrapper
// keeps, so calls on one device share one stream (PyTorch's current
// stream; two calls in flight at once on two streams would share it).
// Offsets are 32-bit: the wrapper refuses S * E >= 2^31.
//
// The backward evaluates the expression in the TPU kernel's order; built
// with --fmad=false it equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>

#define FOCAL_THREADS 256
#define FOCAL_MAX_S 8
#define FOCAL_MAX_C 1024
#define FOCAL_TARGET_BLOCKS 528  // 4 blocks on each of 132 SMs
#define FOCAL_STEP (4 * FOCAL_THREADS)  // elements a block takes a pass

__device__ __forceinline__ float focal_term(float p, float g, float m) {
  const float st = g >= 0.01f ? p : 1.0f - p;
  const float factor = fabsf(1.0f - st);
  const float diff = p - g;
  return diff * diff * factor * m;
}

__device__ __forceinline__ float focal_grad(float p, float g, float m,
                                            float ct) {
  const bool fg = g >= 0.01f;
  const float st = fg ? p : 1.0f - p;
  const float factor = fabsf(1.0f - st);
  const float diff = p - g;
  const float dfactor = fg ? -(1.0f - p >= 0.0f ? 1.0f : -1.0f)
                           : (p >= 0.0f ? 1.0f : -1.0f);
  const float grad = (2.0f * diff * factor + diff * diff * dfactor) * m;
  return grad * ct;
}

// Sum of each thread's v[0..S) over the block, in a fixed order; the sums
// are valid in thread 0.
template <int S>
__device__ __forceinline__ void block_sums(double (&v)[S]) {
  __shared__ double warp_sums[S][FOCAL_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    for (int off = 16; off > 0; off >>= 1)
      v[s] += __shfl_down_sync(0xffffffffu, v[s], off);
    if (lane == 0) warp_sums[s][warp] = v[s];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      v[s] = lane < FOCAL_THREADS / 32 ? warp_sums[s][lane] : 0.0;
      for (int off = 16; off > 0; off >>= 1)
        v[s] += __shfl_down_sync(0xffffffffu, v[s], off);
    }
  }
  __syncthreads();  // warp_sums is free for the next call
}

// Chunk size (elements of one stack a block reduces) for E, by shape alone.
static int focal_chunk(int E) {
  long long want = ((long long)E + FOCAL_TARGET_BLOCKS - 1) /
                   FOCAL_TARGET_BLOCKS;
  want = (want + FOCAL_STEP - 1) / FOCAL_STEP * FOCAL_STEP;
  return (int)(want < FOCAL_STEP ? FOCAL_STEP : want);
}

// One block per chunk, all S stacks.  VEC: E % 4 == 0 and 16-byte aligned
// pred and gt, so a thread takes 4 consecutive elements of each stack
// with one float4 load each.
template <int S, bool VEC>
__global__ void __launch_bounds__(FOCAL_THREADS)
focal_fwd(const float* __restrict__ pred, const float* __restrict__ gt,
          const float* __restrict__ mask, const float* __restrict__ chan,
          int E, int C, int chunk, double* __restrict__ partial,
          unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float s_chan[FOCAL_MAX_C];
  __shared__ bool last;
  for (int c = threadIdx.x; c < C; c += FOCAL_THREADS) s_chan[c] = chan[c];
  __syncthreads();
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, E);
  const int per = VEC ? 4 : 1;            // elements a thread takes a pass
  const int step = per * FOCAL_THREADS;   // elements the block takes a pass
  const int dpix = step / C, dc = step - dpix * C;
  int i = begin + per * threadIdx.x;
  int pix = i / C, c = i - pix * C;
  double acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.0;
  for (; i < end; i += step) {
    if (VEC) {
      float4 pv[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        pv[s] = __ldg(reinterpret_cast<const float4*>(pred + s * E + i));
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gt + i));
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      int p = pix, cc = c;
      float mk = __ldg(mask + p);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float m = mk * s_chan[cc];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float pa[4] = {pv[s].x, pv[s].y, pv[s].z, pv[s].w};
          acc[s] += (double)focal_term(pa[k], ga[k], m);
        }
        if (++cc == C && k < 3) {
          cc = 0;
          mk = __ldg(mask + ++p);
        }
      }
    } else {
      const float m = __ldg(mask + pix) * s_chan[c];
      const float g = __ldg(gt + i);
#pragma unroll
      for (int s = 0; s < S; ++s)
        acc[s] += (double)focal_term(__ldg(pred + s * E + i), g, m);
    }
    pix += dpix;
    c += dc;
    if (c >= C) {
      c -= C;
      ++pix;
    }
  }
  block_sums<S>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) partial[s * gridDim.x + blockIdx.x] = acc[s];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every stack's partials, in index order
  __threadfence();
  double tot[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    tot[s] = 0.0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += FOCAL_THREADS)
      tot[s] += __ldcg(partial + s * gridDim.x + b);
  }
  block_sums<S>(tot);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) out[s] = (float)tot[s];
    *ticket = 0;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(FOCAL_THREADS)
focal_bwd(const float* __restrict__ pred, const float* __restrict__ gt,
          const float* __restrict__ mask, const float* __restrict__ chan,
          const float* __restrict__ ct, long long E, int C, long long total,
          float* __restrict__ dpred) {
  const long long stride = (long long)gridDim.x * FOCAL_THREADS * (VEC ? 4 : 1);
  for (long long i = ((long long)blockIdx.x * FOCAL_THREADS + threadIdx.x) *
                     (VEC ? 4 : 1);
       i < total; i += stride) {
    const int s = (int)(i / E);
    const long long e = i - (long long)s * E;  // index within the stack
    const float cs = __ldg(ct + s);
    if (VEC) {
      const float4 pv = __ldg(reinterpret_cast<const float4*>(pred + i));
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gt + e));
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      float out[4];
      long long pix = e / C;
      int c = (int)(e - pix * C);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float m = __ldg(mask + pix) * __ldg(chan + c);
        out[k] = focal_grad(pa[k], ga[k], m, cs);
        if (++c == C) {
          c = 0;
          ++pix;
        }
      }
      *reinterpret_cast<float4*>(dpred + i) =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
      const long long pix = e / C;
      const int c = (int)(e - pix * C);
      const float m = __ldg(mask + pix) * __ldg(chan + c);
      dpred[i] = focal_grad(__ldg(pred + i), __ldg(gt + e), m, cs);
    }
  }
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

// Blocks of a forward call over E elements a stack; the wrapper makes
// S times as many doubles of partial scratch.
extern "C" int ibp_focal_fwd_blocks(int E) {
  return E > 0 ? (E + focal_chunk(E) - 1) / focal_chunk(E) : 0;
}

template <int S>
static void launch_fwd(const float* pred, const float* gt, const float* mask,
                       const float* chan, int E, int C, int chunk,
                       int blocks, double* partial, unsigned* ticket,
                       float* out, cudaStream_t st) {
  if (E % 4 == 0 && aligned16(pred) && aligned16(gt))
    focal_fwd<S, true><<<blocks, FOCAL_THREADS, 0, st>>>(
        pred, gt, mask, chan, E, C, chunk, partial, ticket, out);
  else
    focal_fwd<S, false><<<blocks, FOCAL_THREADS, 0, st>>>(
        pred, gt, mask, chan, E, C, chunk, partial, ticket, out);
}

// Forward, one launch.  pred (S, E) with E = N*H*W*C, gt (E), mask (E / C),
// chan (C), all contiguous float32; partial holds S * ibp_focal_fwd_blocks(E)
// doubles of scratch; ticket is one unsigned int, 0 between calls; out
// (S).  Needs S <= 8, C <= 1024 and S * E < 2^31.  Returns the cudaError_t
// of the launch.
extern "C" int ibp_focal_fwd(const float* pred, const float* gt,
                             const float* mask, const float* chan, int S,
                             long long E, int C, double* partial,
                             unsigned* ticket, float* out, void* stream) {
  if (S < 1 || S > FOCAL_MAX_S || C < 1 || C > FOCAL_MAX_C || E < 0 ||
      E % C != 0 || (long long)S * E >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (E == 0) return (int)cudaMemsetAsync(out, 0, S * sizeof(float), st);
  const int e = (int)E, chunk = focal_chunk(e);
  const int blocks = (e + chunk - 1) / chunk;
  switch (S) {
    case 1: launch_fwd<1>(pred, gt, mask, chan, e, C, chunk, blocks, partial, ticket, out, st); break;
    case 2: launch_fwd<2>(pred, gt, mask, chan, e, C, chunk, blocks, partial, ticket, out, st); break;
    case 3: launch_fwd<3>(pred, gt, mask, chan, e, C, chunk, blocks, partial, ticket, out, st); break;
    case 4: launch_fwd<4>(pred, gt, mask, chan, e, C, chunk, blocks, partial, ticket, out, st); break;
    case 5: launch_fwd<5>(pred, gt, mask, chan, e, C, chunk, blocks, partial, ticket, out, st); break;
    case 6: launch_fwd<6>(pred, gt, mask, chan, e, C, chunk, blocks, partial, ticket, out, st); break;
    case 7: launch_fwd<7>(pred, gt, mask, chan, e, C, chunk, blocks, partial, ticket, out, st); break;
    default: launch_fwd<8>(pred, gt, mask, chan, e, C, chunk, blocks, partial, ticket, out, st); break;
  }
  return (int)cudaGetLastError();
}

// Backward.  As the forward, plus ct (S) and dpred (S, E).
extern "C" int ibp_focal_bwd(const float* pred, const float* gt,
                             const float* mask, const float* chan,
                             const float* ct, int S, long long E, int C,
                             float* dpred, void* stream) {
  if (S < 1 || C < 1 || E % C != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)S * E;
  if (total == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = E % 4 == 0 && aligned16(pred) && aligned16(gt) &&
                   aligned16(dpred);
  const long long per_block = (long long)FOCAL_THREADS * (vec ? 4 : 1);
  const long long want = (total + per_block - 1) / per_block;
  const int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
  if (vec)
    focal_bwd<true><<<blocks, FOCAL_THREADS, 0, st>>>(pred, gt, mask, chan,
                                                      ct, E, C, total, dpred);
  else
    focal_bwd<false><<<blocks, FOCAL_THREADS, 0, st>>>(pred, gt, mask, chan,
                                                       ct, E, C, total, dpred);
  return (int)cudaGetLastError();
}
