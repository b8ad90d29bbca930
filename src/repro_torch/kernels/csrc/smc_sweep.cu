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
// is used and a lane's cost does not depend on W.  The ring kernel must
// read the counters a row's run looks at (run + 1 slots, at most W), its
// processed count, and write one count; at the phase-1 sizes (a few
// hundred rows) that is kilobytes, and its time is the latency of the
// rounds of loads a row's walk needs, plus the launch.
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
// The ring kernel keeps the reference's walk over an explicit ring: it is
// the oracle of the watermark form, off the main paths.  A warp takes a
// row, and the run is the index of the first miss, from __ballot_sync of
// the misses and __ffs.  A row of W <= 256 slots with W % 4 == 0 is read
// whole, each lane four slots of each 128-slot chunk as one int4, while
// `processed` is still in flight, and the ballots are rotated by
// processed mod W: one load latency and a few dozen instructions a row;
// the warps stride the rows, each with the next row's loads in flight.
// Another row walks j = 32 c + lane for chunks c = 0, 1, ..., the loads
// of RING_CHUNKS chunks issued before their ballots, so a long run
// (W = 1000 at the Fig. 6 grid) costs one latency per 256 slots.
// Python's // and % floor; C's / and % truncate toward zero, so the slot and the
// counter a slot needs are floor_mod / floor_div of k = processed + j
// (`slot_of`: one division a row; a row whose k wraps past INT32_MAX
// walks in j order, and a lane whose add wraps divides its own k), and
// the adds wrap (done in unsigned to stay defined), exactly as the
// reference's int32 loop.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int RING_CHUNKS = 8;   // chunks of 32 slots loaded per ballot round

// Slot k = processed + j (int32 wrap) of a row: where it lives in the
// ring (floor_mod(k, W)) and the counter it needs (floor_div(k, W)).  From
// q0 = floor_div(processed, W) and r0 = floor_mod(processed, W), both once
// a row, that is r0 + j folded once into [0, W) for 0 <= j < W, unless the
// add wraps past INT32_MAX: then the wrapped k is divided as it is.
__device__ __forceinline__ void slot_of(int proc, int j, int q0, int r0,
                                        int window, int& slot, int& need) {
  const int k = wrap_add(proc, j);
  if (k >= proc) {
    const int r = r0 + j;
    const bool over = r >= window;
    slot = over ? r - window : r;
    need = q0 + (over ? 1 : 0);
  } else {
    slot = floor_mod(k, window);
    need = floor_div(k, window);
  }
}

// The run of a row walked in j order: chunk c of 32 lanes checks
// j = 32 c + lane, RING_CHUNKS chunks' loads issued before their ballots.
__device__ __forceinline__ int run_in_j_order(const int* __restrict__ row,
                                              int proc, int window,
                                              int lane) {
  const int q0 = floor_div(proc, window), r0 = floor_mod(proc, window);
  int slot, need, run = window;
  for (int base = 0; base < window && run == window;
       base += 32 * RING_CHUNKS) {
    int have[RING_CHUNKS], needs[RING_CHUNKS];
#pragma unroll
    for (int u = 0; u < RING_CHUNKS; ++u) {
      const int j = base + 32 * u + lane;
      have[u] = needs[u] = 0;               // past the row: not a miss
      if (j < window) {
        slot_of(proc, j, q0, r0, window, slot, need);
        have[u] = row[slot];
        needs[u] = need;
      }
    }
#pragma unroll
    for (int u = 0; u < RING_CHUNKS; ++u) {
      const unsigned misses = __ballot_sync(0xffffffffu, have[u] < needs[u]);
      if (misses && run == window) run = base + 32 * u + __ffs(misses) - 1;
    }
  }
  return run;
}

// Rows read whole in slot order: lane l holds slots 4 l .. 4 l + 3 of each
// 128-slot chunk as one int4 (W % 4 == 0 and the ring 16-byte aligned, so
// every row is).
constexpr int VEC_CHUNKS = 2;            // W <= 128 VEC_CHUNKS

__device__ __forceinline__ void load_row(const int* __restrict__ counters,
                                         const int* __restrict__ processed,
                                         long long r, int window, int lane,
                                         int4 (&have)[VEC_CHUNKS],
                                         int& proc) {
  const int4* row = reinterpret_cast<const int4*>(counters + r * window);
  proc = processed[r];
#pragma unroll
  for (int v = 0; v < VEC_CHUNKS; ++v)
    have[v] = 128 * v + 4 * lane < window ? row[32 * v + lane]
                                           : make_int4(0, 0, 0, 0);
}

// floor_div and floor_mod of a by W (32 <= W < 2^31) with no division:
// a' = a + 2^31 is unsigned, and a' / W = umulhi64(a', M) exactly for
// M = ceil(2^64 / W) (the product overshoots a' / W by less than 2^-32,
// while a' / W's fraction is at most 1 - 1/W); then a = W (qa - qc) +
// (ra - rc) with 2^31 = W qc + rc, folded once into [0, W).
struct Divisor {
  unsigned long long magic;   // ceil(2^64 / W)
  int window, qc, rc;         // 2^31 = W qc + rc
};

__device__ __forceinline__ void floor_divmod(int a, const Divisor& d,
                                             int& q, int& r) {
  const unsigned ap = static_cast<unsigned>(a) ^ 0x80000000u;   // a + 2^31
  const unsigned qa = static_cast<unsigned>(__umul64hi(ap, d.magic));
  const int ra = static_cast<int>(ap - qa * static_cast<unsigned>(d.window));
  q = static_cast<int>(qa) - d.qc;
  r = ra - d.rc;
  if (r < 0) {
    r += d.window;
    --q;
  }
}

// The run of a row read in slot order: slot s holds j = s - r0 (s >= r0)
// or s - r0 + W (s < r0) and needs q0 + (s < r0), so the run is the first
// miss at or after slot r0, else the first before it, rotated.  A row
// whose k = processed + j wraps past INT32_MAX walks in j order.
__device__ __forceinline__ int run_in_slot_order(
    const int* __restrict__ row, const int4 (&have)[VEC_CHUNKS], int proc,
    const Divisor& d, int lane) {
  const int window = d.window;
  if (wrap_add(proc, window - 1) < proc)
    return run_in_j_order(row, proc, window, lane);
  int q0, r0;
  floor_divmod(proc, d, q0, r0);
  int after = window, before = window;    // first missing slot >= r0, < r0
#pragma unroll
  for (int v = 0; v < VEC_CHUNKS; ++v) {
    if (128 * v >= window) break;
    const int h[4] = {have[v].x, have[v].y, have[v].z, have[v].w};
    unsigned hi = 0, lo = 0;                // this lane's misses, as bits
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 128 * v + 4 * lane + e;
      if (s < window && h[e] < q0 + (s < r0 ? 1 : 0)) {
        if (s >= r0) hi |= 1u << e;
        else lo |= 1u << e;
      }
    }
    const unsigned lanes_hi = __ballot_sync(0xffffffffu, hi != 0);
    const unsigned lanes_lo = __ballot_sync(0xffffffffu, lo != 0);
    if (lanes_hi && after == window) {
      const int l = __ffs(lanes_hi) - 1;
      after = 128 * v + 4 * l + __ffs(__shfl_sync(0xffffffffu, hi, l)) - 1;
    }
    if (lanes_lo && before == window) {
      const int l = __ffs(lanes_lo) - 1;
      before = 128 * v + 4 * l + __ffs(__shfl_sync(0xffffffffu, lo, l)) - 1;
    }
  }
  return after < window ? after - r0
                        : (before < window ? before + window - r0 : window);
}

// SLOTS (32 <= W <= 128 VEC_CHUNKS, W % 4 == 0, a 16-byte aligned ring): a
// warp a row read in slot order, the warps striding the rows, the next
// row's loads issued before this row's ballots, and `processed` read
// beside the row, not before it.  Otherwise a warp a row walked in j
// order.
template <bool SLOTS>
__global__ void smc_sweep_ring_kernel(const int* __restrict__ counters,
                                      const int* __restrict__ processed,
                                      int* __restrict__ out, int n_rows,
                                      Divisor d) {
  const int window = d.window;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (!SLOTS) {
    if (warp >= n_rows) return;             // the whole warp
    const int proc = processed[warp];
    const int run = run_in_j_order(counters + warp * window, proc, window,
                                   lane);
    if (lane == 0) out[warp] = wrap_add(proc, run);
    return;
  }
  const long long warps =
      static_cast<long long>(gridDim.x) * blockDim.x >> 5;
  long long r = warp;
  if (r >= n_rows) return;
  int4 have[VEC_CHUNKS], next[VEC_CHUNKS];
  int proc, proc_next = 0;
  load_row(counters, processed, r, window, lane, have, proc);
  while (true) {
    const long long rn = r + warps;
    if (rn < n_rows)
      load_row(counters, processed, rn, window, lane, next, proc_next);
    const int run = run_in_slot_order(counters + r * window, have, proc, d,
                                      lane);
    if (lane == 0) out[r] = wrap_add(proc, run);
    if (rn >= n_rows) break;
    r = rn;
    proc = proc_next;
#pragma unroll
    for (int v = 0; v < VEC_CHUNKS; ++v) have[v] = next[v];
  }
}

constexpr int kThreads = 256;
constexpr int kRingBlocksPerSm = 8;   // 2048 threads an SM

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Divisor d;
  d.window = window;
  d.magic = ~0ull / static_cast<unsigned long long>(window) + 1;
  d.qc = static_cast<int>((1u << 31) / static_cast<unsigned>(window));
  d.rc = static_cast<int>((1u << 31) % static_cast<unsigned>(window));
  const bool slots = window >= 32 && window <= 128 * VEC_CHUNKS &&
                     window % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(counters) & 15) == 0;
  long long blocks = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  if (!slots) {
    smc_sweep_ring_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                   0, st>>>(counters, processed, out, n_rows,
                                            d);
    return static_cast<int>(cudaGetLastError());
  }
  // the warps stride the rows: as many blocks as are resident at once
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * kRingBlocksPerSm;
  if (blocks > resident) blocks = resident;
  smc_sweep_ring_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(counters, processed, out, n_rows,
                                      d);
  return static_cast<int>(cudaGetLastError());
}
