// Per-limb one-to-one candidate walk on Hopper (sm_90a).
//
// Replaces the TPU kernel candidate_walk_pallas / _walk_kernel
// (improved_body_parts_tpu/ops/pallas_assembly.py:28, pallas_call at
// l.75), the walk of greedy_assemble (ops/assembly.py:266-303): over the
// rank-ordered candidates of one limb, take a candidate when it is valid,
// fewer than `limit` are taken and neither endpoint slot is used yet,
// then mark both endpoints used.
//
// Bound on this card: latency.  The walk is scalar and sequential within
// a limb (each step reads the used-masks the previous step wrote), so one
// thread owns one (image, limb) row with its two K-entry used-masks in
// shared memory; rows run in parallel.  Its bytes (three N x L x M int32
// inputs, one output) take well under a microsecond to move; the M
// dependent steps are what it waits on.
#include <cuda_runtime.h>

#define WALK_THREADS 32

__global__ void __launch_bounds__(WALK_THREADS)
candidate_walk_kernel(const int* __restrict__ slot_a,
                      const int* __restrict__ slot_b,
                      const int* __restrict__ valid,
                      const int* __restrict__ limit, int rows, int M, int K,
                      int* __restrict__ sel) {
  extern __shared__ unsigned char used[];  // WALK_THREADS x 2K flags
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  unsigned char* used_a = used + (long long)threadIdx.x * 2 * K;
  unsigned char* used_b = used_a + K;
  for (int k = 0; k < 2 * K; ++k) used_a[k] = 0;
  const int lim = limit[row];
  int taken = 0;
  const long long base = (long long)row * M;
  for (int m = 0; m < M; ++m) {
    const int sa = min(max(slot_a[base + m], 0), K - 1);
    const int sb = min(max(slot_b[base + m], 0), K - 1);
    const bool ok = valid[base + m] != 0 && taken < lim && !used_a[sa] &&
                    !used_b[sb];
    sel[base + m] = ok;
    if (ok) {
      used_a[sa] = 1;
      used_b[sb] = 1;
      ++taken;
    }
  }
}

// Launch on `stream`: rows = images x limbs, each row M candidates over
// K peak slots; inputs and output contiguous int32 (rows, M).  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int ibp_candidate_walk(const int* slot_a, const int* slot_b,
                                  const int* valid, const int* limit,
                                  int rows, int M, int K, int* sel,
                                  void* stream) {
  if (K < 1 || 2 * K * WALK_THREADS > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || M == 0) return (int)cudaSuccess;
  const int blocks = (rows + WALK_THREADS - 1) / WALK_THREADS;
  candidate_walk_kernel<<<blocks, WALK_THREADS, 2 * K * WALK_THREADS,
                          (cudaStream_t)stream>>>(slot_a, slot_b, valid,
                                                  limit, rows, M, K, sel);
  return (int)cudaGetLastError();
}
