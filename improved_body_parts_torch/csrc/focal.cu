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
// flops per element (the forward reads pred, gt and mask once; the
// backward also writes dpred), so the design is coalesced 16-byte loads
// of pred and gt (4 consecutive elements a thread, one integer division
// a vector to find the pixel and channel), mask and chan through the
// read-only cache, and enough blocks to fill the card.  The TPU kernel
// accumulated the forward in an SMEM scalar over a sequential grid; blocks
// here run in parallel and in no order, so the forward is a deterministic
// two-pass reduction instead: (a) a grid over (chunk, stack) writes one
// double partial per block, (b) one block per stack sums its partials in
// a fixed order.  No float atomics, so the loss is the same bits every
// run.  The backward evaluates the expression in the TPU kernel's order;
// built with --fmad=false it equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>

#define FOCAL_THREADS 256
#define FOCAL_CHUNK 16384  // elements of one stack a forward block reduces

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

// Sum of `v` over the block, every thread's value in a fixed order; the
// result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[FOCAL_THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < FOCAL_THREADS / 32 ? warp_sums[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// (a) partial[s * chunks + chunk] = sum of the loss terms of one chunk of
// stack s.  VEC: E % 4 == 0 and 16-byte aligned pred / gt, so a thread
// takes 4 consecutive elements with one float4 load of each.
template <bool VEC>
__global__ void __launch_bounds__(FOCAL_THREADS)
focal_fwd_partial(const float* __restrict__ pred, const float* __restrict__ gt,
                  const float* __restrict__ mask, const float* __restrict__ chan,
                  long long E, int C, int chunks, double* __restrict__ partial) {
  const int s = blockIdx.y;
  const long long begin = (long long)blockIdx.x * FOCAL_CHUNK;
  const long long end = min(begin + FOCAL_CHUNK, E);
  const float* p = pred + (long long)s * E;
  double acc = 0.0;
  if (VEC) {
    for (long long i = begin + 4LL * threadIdx.x; i < end;
         i += 4LL * FOCAL_THREADS) {
      const float4 pv = __ldg(reinterpret_cast<const float4*>(p + i));
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gt + i));
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      long long pix = i / C;
      int c = (int)(i - pix * C);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float m = __ldg(mask + pix) * __ldg(chan + c);
        acc += (double)focal_term(pa[k], ga[k], m);
        if (++c == C) {
          c = 0;
          ++pix;
        }
      }
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += FOCAL_THREADS) {
      const long long pix = i / C;
      const int c = (int)(i - pix * C);
      const float m = __ldg(mask + pix) * __ldg(chan + c);
      acc += (double)focal_term(__ldg(p + i), __ldg(gt + i), m);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[(long long)s * chunks + blockIdx.x] = acc;
}

// (b) out[s] = sum of stack s's partials, in a fixed order.
__global__ void __launch_bounds__(FOCAL_THREADS)
focal_fwd_final(const double* __restrict__ partial, int chunks,
                float* __restrict__ out) {
  const int s = blockIdx.x;
  double acc = 0.0;
  for (int i = threadIdx.x; i < chunks; i += FOCAL_THREADS)
    acc += partial[(long long)s * chunks + i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[s] = (float)acc;
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

// Forward.  pred (S, E) with E = N*H*W*C, gt (E), mask (E / C), chan (C),
// all contiguous float32; partial holds S * focal_chunks(E) doubles of
// scratch; out (S).  Returns the cudaError_t of the launches.
extern "C" int ibp_focal_chunks(long long E) {
  return (int)((E + FOCAL_CHUNK - 1) / FOCAL_CHUNK);
}

extern "C" int ibp_focal_fwd(const float* pred, const float* gt,
                             const float* mask, const float* chan, int S,
                             long long E, int C, double* partial, float* out,
                             void* stream) {
  if (S < 1 || S > 65535 || C < 1 || E % C != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int chunks = ibp_focal_chunks(E);
  if (chunks == 0) {
    return (int)cudaMemsetAsync(out, 0, S * sizeof(float), st);
  }
  const dim3 grid(chunks, S);
  if (E % 4 == 0 && aligned16(pred) && aligned16(gt))
    focal_fwd_partial<true><<<grid, FOCAL_THREADS, 0, st>>>(
        pred, gt, mask, chan, E, C, chunks, partial);
  else
    focal_fwd_partial<false><<<grid, FOCAL_THREADS, 0, st>>>(
        pred, gt, mask, chan, E, C, chunks, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  focal_fwd_final<<<S, FOCAL_THREADS, 0, st>>>(partial, chunks, out);
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
