// SMC receive sweep for Hopper (sm_90a): the Spindle receive predicate
// (paper Sec. 3.2) as two CUDA kernels with a plain C interface, loaded
// from Python with ctypes (repro_torch/kernels/smc_sweep.py).
//
// What each kernel replaces:
//   smc_sweep_watermark_kernel  <- repro/kernels/smc_sweep.py
//       smc_sweep_watermark_pallas (bodies _watermark_kernel,
//       _watermark_masked_kernel).  The receive predicate of the "kernel"
//       Group backend; one launch per protocol round covers every
//       (point, subgroup, member, sender) lane of the stacked run.
//   smc_sweep_ring_kernel       <- repro/kernels/smc_sweep.py
//       smc_sweep_pallas (body _sweep_kernel): the same contiguous-run
//       receive over an explicit (S, W) slot-counter ring, the oracle of
//       the watermark form.
//
// What bounds them on an H100: the watermark kernel reads three int32
// per lane (published, processed, valid) and writes one, about 16 B per
// lane at 3.35 TB/s, plus the fixed launch cost; at the main path's
// sizes (256 lanes for the 16-node group, a few thousand for a stacked
// DDS domain) the launch cost is the whole time.  The Pallas kernel built
// a (block, W) counter tile in VMEM; here each thread rebuilds the one
// counter it needs in registers, so nothing W-wide exists anywhere and
// no shared memory is used.
//
// The loop over j in [0, W) is data-dependent: it stops at the first
// slot whose counter is too old, so a lane costs (run + 1) iterations.
//
// For non-negative inputs the watermark result equals
//     processed + clamp(published - processed, 0, W)
// (checked in numpy over 16k random lanes, W in {1, 3, 8, 100}).  The
// kernel keeps the reference's loop so that it agrees on every int32
// input, negative ones included; using the closed form is left to a
// later change.
//
// Python's // and % floor; C's / and % truncate toward zero, so the
// arithmetic below goes through floor_div / floor_mod.  Adds wrap like
// the reference's int32 arithmetic (done in unsigned to stay defined).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// b > 0 (the wrapper rejects window < 1)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return (r < 0) ? r + b : r;
}

__global__ void smc_sweep_watermark_kernel(const int* __restrict__ published,
                                           const int* __restrict__ processed,
                                           const int* __restrict__ valid,
                                           int* __restrict__ out, int n,
                                           int window) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int proc = processed[i];
    int run = 0;
    if (valid == nullptr || valid[i] > 0) {
      const int pub = published[i];
      for (int j = 0; j < window; ++j) {
        const int k = wrap_add(proc, j);
        const int slot = floor_mod(k, window);
        const int want = floor_div(k, window);
        // the counter slot `slot` holds after `pub` publishes
        const int counter =
            pub > slot ? floor_div(wrap_add(wrap_add(pub, -1), -slot), window)
                       : -1;
        if (counter < want) break;
        ++run;
      }
    }
    out[i] = wrap_add(proc, run);
  }
}

__global__ void smc_sweep_ring_kernel(const int* __restrict__ counters,
                                      const int* __restrict__ processed,
                                      int* __restrict__ out, int n_rows,
                                      int window) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += gridDim.x * blockDim.x) {
    const int* row = counters + static_cast<long long>(r) * window;
    const int proc = processed[r];
    int run = 0;
    for (int j = 0; j < window; ++j) {
      const int k = wrap_add(proc, j);
      if (row[floor_mod(k, window)] < floor_div(k, window)) break;
      ++run;
    }
    out[r] = wrap_add(proc, run);
  }
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM, grid-stride beyond

int blocks_for(int n) {
  int b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

// Each launcher returns cudaGetLastError() as an int (0 = launched).
// valid may be null (no mask).  n >= 1 and window >= 1 are checked by the
// Python wrapper.
extern "C" int smc_sweep_watermark_launch(const int* published,
                                          const int* processed,
                                          const int* valid, int* out, int n,
                                          int window, void* stream) {
  smc_sweep_watermark_kernel<<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      published, processed, valid, out, n, window);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smc_sweep_ring_launch(const int* counters, const int* processed,
                                     int* out, int n_rows, int window,
                                     void* stream) {
  smc_sweep_ring_kernel<<<blocks_for(n_rows), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      counters, processed, out, n_rows, window);
  return static_cast<int>(cudaGetLastError());
}
