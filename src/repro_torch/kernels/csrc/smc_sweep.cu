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
// What bounds them on an H100: the watermark kernel reads two or three
// int32 per lane (published, processed, valid) and writes one, 12-16 B
// per lane at 3.35 TB/s, plus the fixed launch cost; at the main path's
// sizes (256 lanes for the 16-node group, a few thousand for a stacked
// DDS domain) the launch cost is the whole time.  The Pallas kernel built
// a (block, W) counter tile in VMEM and walked it; this one computes the
// run in closed form, so nothing W-wide exists anywhere, no shared memory
// is used and a lane's cost does not depend on W.
//
// The closed form.  After `published` messages the counter of slot k % W
// reaches k / W (floor) exactly when k < published, for every k >= 0,
// and for k < 0 every counter (-1 or more) is at least the floor of k / W
// (-1 or less); so slot k is visible iff k < max(published, 0).  The run
// from `processed` is the count of leading k = processed + j, j in
// [0, W), below that limit:
//     out = wrap32(processed + clamp(max(published, 0) - processed, 0, W))
// with the clamp in 64-bit arithmetic (the difference of two int32 does
// not fit one) and the final add wrapped to 32 bits like the reference's
// int32 arithmetic.  It holds for every int32 input (the CPU tests check
// it against the loop at INT32_MIN/MAX +- 2W and negative counts).  A
// masked lane (valid <= 0) returns `processed`.  Lanes go four to a
// thread as int4 when every lane array is 16-byte aligned, else one.
//
// The ring kernel keeps the reference's loop over an explicit ring: it
// is the oracle of the watermark form, off the main paths.  Python's //
// and % floor; C's / and % truncate toward zero, so its arithmetic goes
// through floor_div / floor_mod, and its adds wrap (done in unsigned to
// stay defined).

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

// the visible count of one lane: processed + clamp(max(pub, 0) - proc,
// 0, W), 64-bit inside, wrapped to int32
__device__ __forceinline__ int visible(int pub, int proc, long long window) {
  long long run = static_cast<long long>(pub > 0 ? pub : 0) - proc;
  run = run < 0 ? 0 : (run > window ? window : run);
  return wrap_add(proc, static_cast<int>(run));
}

template <bool MASKED>
__device__ __forceinline__ int lane(int pub, int proc, int ok,
                                    long long window) {
  return (!MASKED || ok > 0) ? visible(pub, proc, window) : proc;
}

// Lanes [0, n): four a thread as int4 where VEC (every array 16-byte
// aligned), the last n % 4 lanes one a thread; else one lane a thread.
template <bool VEC, bool MASKED>
__global__ void smc_sweep_watermark_kernel(const int* __restrict__ published,
                                           const int* __restrict__ processed,
                                           const int* __restrict__ valid,
                                           int* __restrict__ out, int n,
                                           int window) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long w = window;
  if (VEC) {
    const int quads = n >> 2;
    if (i < quads) {
      const int4 p = reinterpret_cast<const int4*>(published)[i];
      const int4 q = reinterpret_cast<const int4*>(processed)[i];
      int4 v = make_int4(1, 1, 1, 1);
      if (MASKED) v = reinterpret_cast<const int4*>(valid)[i];
      reinterpret_cast<int4*>(out)[i] =
          make_int4(lane<MASKED>(p.x, q.x, v.x, w),
                    lane<MASKED>(p.y, q.y, v.y, w),
                    lane<MASKED>(p.z, q.z, v.z, w),
                    lane<MASKED>(p.w, q.w, v.w, w));
    }
    const int t = 4 * quads + i;  // the tail, by the first threads
    if (i < (n & 3))
      out[t] = lane<MASKED>(published[t], processed[t],
                            MASKED ? valid[t] : 1, w);
  } else if (i < n) {
    out[i] = lane<MASKED>(published[i], processed[i], MASKED ? valid[i] : 1,
                          w);
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

template <bool VEC, bool MASKED>
void launch_watermark(const int* published, const int* processed,
                      const int* valid, int* out, int n, int window,
                      cudaStream_t stream) {
  const int threads = VEC ? (n + 3) / 4 : n;
  smc_sweep_watermark_kernel<VEC, MASKED>
      <<<(threads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          published, processed, valid, out, n, window);
}

}  // namespace

// The watermark sweep's one entry point, its arguments packed into one
// int64 array (no per-call conversion on the Python side): published,
// processed, valid (0 = no mask), out, n, window, stream.  Returns
// cudaGetLastError() as an int (0 = launched).  n >= 1 and window >= 1
// are checked by the Python wrapper.
extern "C" int smc_sweep_watermark_launch(const long long* a) {
  const int* published = reinterpret_cast<const int*>(a[0]);
  const int* processed = reinterpret_cast<const int*>(a[1]);
  const int* valid = reinterpret_cast<const int*>(a[2]);
  int* out = reinterpret_cast<int*>(a[3]);
  const int n = static_cast<int>(a[4]);
  const int window = static_cast<int>(a[5]);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[6]);
  const bool vec = ((a[0] | a[1] | a[2] | a[3]) & 15) == 0;
  if (valid == nullptr) {
    if (vec)
      launch_watermark<true, false>(published, processed, valid, out, n,
                                    window, stream);
    else
      launch_watermark<false, false>(published, processed, valid, out, n,
                                     window, stream);
  } else if (vec) {
    launch_watermark<true, true>(published, processed, valid, out, n, window,
                                 stream);
  } else {
    launch_watermark<false, true>(published, processed, valid, out, n,
                                  window, stream);
  }
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
