// Flash attention (forward) for Hopper (sm_90a): causal or non-causal
// grouped-query attention over a full sequence, as two CUDA kernels with
// one plain C interface loaded from Python with ctypes
// (repro_torch/kernels/flash_attention.py).  bfloat16 inputs take the
// tensor-core kernel (flash_attention_kernel_bf16, wgmma); float32 inputs
// take the CUDA-core kernel (flash_attention_kernel_f32), which keeps
// float32's digits where TF32 tensor cores would not.
//
// What it replaces: repro/kernels/flash_attention.py flash_attention_flat
// (body _attn_kernel): softmax(q k^T / sqrt(D)) v per query head, an
// online softmax in f32 carried across key tiles, whole key tiles above
// the causal diagonal skipped (the TPU kernel's pl.when(run)) and the
// diagonal tile masked element-wise.  The TPU kernel takes q, k, v
// transposed to (B*H, S, D) and padded to a multiple of 128; these read
// the model's layout (B, S, H, D) in place through strides and mask the
// ragged last tile themselves, so nothing is copied or padded.
//
// What bounds it on an H100: operations.  Causal attention at qwen3-1.7b's
// shape (Hq 16, Hkv 8, D 128) does 2*S*D flops per query row per half of
// the keys, against 4*S*Hkv*D bytes of K/V per row of the batch: far above
// the ~295 flops a byte where the card stops being bound by memory.
//
// Both kernels flatten the query rows of a kv head position-major: row f
// is position f / G of query head h*G + f % G (G = Hq/Hkv).  So one block
// serves all G query heads of its kv head, every K/V tile it stages is
// used by G heads (the flash-decode kernel's grouping), and any G works,
// not only divisors of the tile.  Constants kept from the TPU kernel:
// NEG_INF = -1e30 for masked scores and the running max, the
// max(l, 1e-30) floor of the denominator, and m, l and the output
// accumulated in f32.
//
// The bf16 tensor-core kernel.  One block of two warpgroups (256 threads)
// per (batch row, kv head, tile of 128 flattened query rows); each
// warpgroup owns 64 rows.  Blocks are numbered heaviest first: the causal
// query tiles with the most keys take the lowest block indices, so the
// last wave holds the light tiles.  The Q tile is gathered once with
// cp.async (a block's rows are G heads of each position, no single box);
// K and V tiles of 64 keys stream through a ring of three stages in
// shared memory by TMA: one thread issues each tile's two box copies,
// which complete on the stage's mbarrier, two tiles ahead of the compute.
// The SM's threads spend no instructions on those copies (issued by all
// threads as cp.async, they cost a sixth of the time at S = 2048 and more
// at longer S).  Q K^T is wgmma.m64n64k16 with both operands read from
// shared memory (K stored (keys, D) is already the K-major B operand);
// the scale 1/sqrt(D) * log2(e) is applied to the f32 scores and the
// softmax uses exp2.  The online softmax runs on the
// accumulator fragment in registers: a thread holds 2 rows x 16 keys, so
// a row's max reduces over the 4 lanes of a quad.  P is rounded to bf16
// in registers and is the A operand of wgmma.m64nDk16 (the accumulator's
// fragment is the A fragment's layout), with the V tile as an MN-major B
// operand from shared memory.  Every tile sits in shared memory in the
// canonical no-swizzle layout of 8-row x 16-byte core matrices: the
// 16-byte chunk c of row r of a tile of R rows lives at byte
// c * 16 R + 16 r, so one layout serves K as the K-major operand of
// Q K^T and V as the MN-major operand of P V (leading and stride byte
// offsets swapped).  A TMA box of (8 elements, 64 positions, D/8 chunks)
// of the (element, position, chunk, head, batch) view of k or v lands in
// exactly that layout.  Keys past the sequence are zero-filled by the copy
// and masked to NEG_INF (a zero key scores 0, not -inf); key tiles wholly
// above the diagonal of a warpgroup's rows are skipped, and only the
// diagonal and ragged tiles are masked.  The one rounding the TPU kernel
// does not make is P to bf16 before P V; products of bf16 inputs are
// exact in f32, so the rest differs only in summation order; the softmax
// takes 2^x on the special-function unit (ex2.approx.ftz).  D = 128 takes
// 128 KB of dynamic shared memory, one block an SM.
//
// The f32 CUDA-core kernel.  One block per (batch row, kv head, tile of
// 64 query rows), 256 threads.  The block loops over tiles of 64 keys: K
// is staged transposed in shared memory, each thread computes a 4x4 patch
// of the 64x64 score tile with f32 FMAs, the row max and sum of the online
// softmax are reduced across the 16 threads of a row with warp shuffles,
// P goes to shared memory, V is staged in K's place, and each thread
// accumulates 4 rows x D/16 columns of the output in registers.  Its
// ceiling is the 67 TFLOP/s f32 rate; scale = 1/sqrt(D) is applied to q.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kRows = 64;      // flattened query rows per block
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx columns

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // Q tile [kRows][D+1] + K^T [D][kKeys+1] (V [kKeys][D] reuses it)
  // + P [kRows][kKeys+1]
  return kRows * (D + 1) + D * (kKeys + 1) + kRows * (kKeys + 1);
}

// q: (B, S, Hq, D) with strides (q_sb, q_ss, q_sh, 1); k, v: (B, S, Hkv, D)
// with strides (*_sb, *_ss, *_sh, 1); out: (B, S, Hq, D) contiguous.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel_f32(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out, int s_len, int group,
                               int causal, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, float scale) {
  constexpr int QS = D + 1;      // row stride of the Q tile
  constexpr int KS = kKeys + 1;  // row stride of K^T and of P
  // output columns per thread (tx + 16 c); where D is no multiple of 16
  // the last column group is partial
  constexpr int DC = (D + 15) / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kRows][QS]
  float* kv = qs + kRows * QS;   // K^T [D][KS], then V [kKeys][D]
  float* ps = kv + D * KS;       // [kRows][KS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.y;  // kv head
  const int b = blockIdx.z;  // batch row
  const long long n_rows = static_cast<long long>(s_len) * group;
  const long long f0 = static_cast<long long>(blockIdx.x) * kRows;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  // the block's query rows, scaled in f32; rows past the end are zeros
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const long long f = f0 + r;
    float x = 0.f;
    if (f < n_rows) {
      const long long pos = f / group;
      const int head = h * group + static_cast<int>(f % group);
      x = q[b * q_sb + pos * q_ss + head * q_sh + d] * scale;
    }
    qs[r * QS + d] = x;
  }

  int qpos[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = static_cast<int>((f0 + ty + 16 * i) / group);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: the last tile any row of this block can see
  const long long f_last = (f0 + kRows < n_rows ? f0 + kRows : n_rows) - 1;
  const int last_pos = static_cast<int>(f_last / group);
  const int n_tiles = causal ? last_pos / kKeys + 1
                             : (s_len + kKeys - 1) / kKeys;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's P.V is done with kv and ps
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int pos = k0 + j;
      kv[d * KS + j] =
          pos < s_len ? kb[static_cast<long long>(pos) * k_ss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[4], kr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kr[j] = kv[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = k0 + tx + 16 * j;
        if (pos >= s_len || (causal && pos > qpos[i])) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * KS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // K^T is read and P is complete

    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int pos = k0 + j;
      kv[j * D + d] =
          pos < s_len ? vb[static_cast<long long>(pos) * v_ss + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pr[4], vr[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * KS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        vr[c] = (D % 16 == 0 || tx + 16 * c < D) ? kv[j * D + tx + 16 * c]
                                                  : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
    }
  }

  const int hq = gridDim.y * group;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = f0 + ty + 16 * i;
    if (f >= n_rows) continue;
    const long long pos = f / group;
    const int head = h * group + static_cast<int>(f % group);
    float* orow = out + ((static_cast<long long>(b) * s_len + pos) * hq +
                         head) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (D % 16 == 0 || tx + 16 * c < D) orow[tx + 16 * c] = acc[i][c] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s_len, int hkv, int group, int causal, const long long* st,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_f32<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = static_cast<long long>(s_len) * group;
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows), hkv,
                  b);
  flash_attention_kernel_f32<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s_len, group,
      causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), asynchronous K/V tiles
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;     // flattened query rows per block (2 x 64)
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 3;     // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Q K^T steps its contraction 16 values at a time, so a tile holds D
// rounded up to 16: where D is an odd number of 16-byte chunks, one zero
// chunk follows the last (a zero column adds nothing to the scores).
template <int D>
__host__ __device__ constexpr int padded_d() {
  return (D + 15) / 16 * 16;
}

template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * padded_d<D>() * 2;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  // Q, the K/V ring, one mbarrier per stage
  return tile_bytes<D>(kRows) + 2 * kStages * tile_bytes<D>(kKeys) +
         8 * kStages;
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (a probability below 2^-126 of the row's largest counts as 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// wait for all of this thread's cp.async copies
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// make this thread's shared-memory writes visible to the async proxy
// (wgmma reads its shared operands through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive on the mbarrier and expect `bytes` of copies to complete on it
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` of the mbarrier; trap (a launch
// error, not a hang) if it has not completed after ~2^32 cycles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// One TMA copy of a 5-d box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, int c4,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across an
// asynchronous wgmma: accumulators are written, and A fragments read, until
// its wait_group returns.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, the
// leading byte offset (between core matrices along K) and the stride byte
// offset (between core matrices along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d(64x64, f32) (+)= A(64x16, shared) * B(16x64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d(64x8, f32) (+)= A(64x16, registers) * B(16x8, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64x16, f32) (+)= A(64x16, registers) * B(16x16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64x32, f32) (+)= A(64x16, registers) * B(16x32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64x64, f32) (+)= A(64x16, registers) * B(16x64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64x128, f32) (+)= A(64x16, registers) * B(16x128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Byte offset of 16-byte chunk c of row r in a tile of R rows laid out as
// core matrices (8 rows x 16 bytes, contiguous): rows step 16 bytes, chunks
// step 16 R.  The copy of a warp's 32 chunks covers 8 consecutive rows x 4
// chunks: 64 contiguous bytes of each of 8 global rows, and 128 contiguous
// bytes of shared memory per 8 lanes (no bank conflict).
template <int C>
__device__ __forceinline__ void chunk_of(int i, int& r, int& c) {
  r = (i / (8 * C)) * 8 + i % 8;
  c = (i / 8) % C;
}

// S (64 rows of warpgroup wg x kKeys keys, f32) = Q K^T, both from shared
// memory.  q_s holds kRows rows, k_s kKeys rows, D columns each.
template <int D>
__device__ __forceinline__ void qk_scores(float (&s)[kKeys / 2],
                                          uint32_t q_s, uint32_t k_s,
                                          int wg) {
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < padded_d<D>() / 16; ++kk) {
    // a k16 step spans two 16-byte chunks: two core matrices along K
    const uint64_t da = smem_desc(q_s + 2 * kk * (kRows * 16) + wg * 64 * 16,
                                  kRows * 16, 128);
    const uint64_t db = smem_desc(k_s + 2 * kk * (kKeys * 16), kKeys * 16,
                                  128);
    wgmma_ss_n64(s, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// O[:, COL0:D] += P V[:, COL0:D] for one step of 16 keys, as wgmma
// widths of 128, 64, 32, 16 and 8 columns (D = 80: n64 then n16), so the
// tensor cores do D columns of work, not the next power of two.  The
// output columns COL0 .. are the accumulator registers from COL0 / 2 on;
// V's columns are core matrices kKeys * 16 bytes apart along N.
template <int D, int COL0 = 0>
__device__ __forceinline__ void pv_columns(float* o, const uint32_t (&p)[4],
                                           uint32_t v_kt) {
  constexpr int REST = D - COL0;
  if constexpr (REST > 0) {
    constexpr int W = REST >= 128 ? 128
                      : REST >= 64 ? 64
                      : REST >= 32 ? 32
                      : REST >= 16 ? 16
                                   : 8;
    const uint64_t db =
        smem_desc(v_kt + (COL0 / 8) * (kKeys * 16), 128, kKeys * 16);
    if constexpr (W == 128) wgmma_rs_n128(o + COL0 / 2, p, db, 1);
    if constexpr (W == 64) wgmma_rs_n64(o + COL0 / 2, p, db, 1);
    if constexpr (W == 32) wgmma_rs_n32(o + COL0 / 2, p, db, 1);
    if constexpr (W == 16) wgmma_rs_n16(o + COL0 / 2, p, db, 1);
    if constexpr (W == 8) wgmma_rs_n8(o + COL0 / 2, p, db, 1);
    pv_columns<D, COL0 + W>(o, p, v_kt);
  }
}

// O (64 x D, f32) += P V: P (64 x kKeys) in registers as bf16 A fragments,
// V (kKeys x D) from shared memory as the MN-major B operand.
template <int D>
__device__ __forceinline__ void pv_accumulate(float (&o)[D / 2],
                                              uint32_t (&p)[kKeys / 16][4],
                                              uint32_t v_s) {
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < kKeys / 16; ++kt) {
    // 16 keys: two core matrices along K (8 keys = 128 bytes apart)
    pv_columns<D>(o, p[kt], v_s + kt * 16 * 16);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(p);
}

// The scores' fragment as bf16 A fragments: keys 16 kt .. 16 kt + 15 are
// the accumulator's 8-column chunks 2 kt and 2 kt + 1.
__device__ __forceinline__ void to_a_fragments(const float (&s)[kKeys / 2],
                                               uint32_t (&p)[kKeys / 16][4]) {
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i) {
    p[i / 2][(i % 2) * 2] = pack_bf16(s[4 * i], s[4 * i + 1]);
    p[i / 2][(i % 2) * 2 + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
}

// q: (B, S, Hq, D) with strides (q_sb, q_ss, q_sh, 1), base and rows
// 16-byte aligned; k, v: (B, S, Hkv, D), read through the TMA maps
// tmap_k / tmap_v (tile_map); out: (B, S, Hq, D) contiguous.
// scale_log2 = log2(e) / sqrt(D).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel_bf16(const bf16* __restrict__ q,
                                bf16* __restrict__ out, int n_batch,
                                int s_len, int hkv, int group, int causal,
                                long long q_sb, long long q_ss,
                                long long q_sh, float scale_log2,
                                const __grid_constant__ CUtensorMap tmap_k,
                                const __grid_constant__ CUtensorMap tmap_v) {
  constexpr int C = D / 8;                 // 16-byte chunks of a row
  constexpr int CK = padded_d<D>() / 8;    // ... of a tile row
  constexpr int TILE = tile_bytes<D>(kKeys);
  constexpr int LOADED = kKeys * D * 2;    // bytes one TMA box brings
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + tile_bytes<D>(kRows);
  const uint32_t bar_s = kv_s + kStages * 2 * TILE;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  // heaviest query tiles first (see launch_geometry in the wrapper)
  const long long n_rows = static_cast<long long>(s_len) * group;
  const int n_qt = static_cast<int>((n_rows + kRows - 1) / kRows);
  const int hb = hkv * n_batch;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / hb);
  const int h = static_cast<int>(blockIdx.x % hb) % hkv;
  const int b = static_cast<int>(blockIdx.x % hb) / hkv;
  const long long f0 = static_cast<long long>(qt) * kRows;

  // the Q tile, gathered row by row (G heads of each position); the pad
  // chunk, where there is one, is zero
  for (int i = tid; i < kRows * CK; i += kThreads) {
    int r, c;
    chunk_of<CK>(i, r, c);
    const long long f = f0 + r;
    const bf16* src = q;
    int bytes = 0;
    if (f < n_rows && c < C) {
      src = q + b * q_sb + (f / group) * q_ss +
            (h * group + f % group) * q_sh + 8 * c;
      bytes = 16;
    }
    cp_async16(q_s + c * (kRows * 16) + r * 16, src, bytes);
  }

  // K and V of tile t into stage t % kStages by TMA (thread 0): boxes of
  // (8 elements, kKeys positions, C chunks) of the (chunk element,
  // position, chunk, head, batch) view, which lay out as the core-matrix
  // tile; positions past the end are zero-filled
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    const uint32_t bar = bar_s + 8 * st;
    const uint32_t k_st = kv_s + st * 2 * TILE;
    mbar_expect_tx(bar, 2 * LOADED);
    tma_load_5d(k_st, &tmap_k, 0, t * kKeys, 0, h, b, bar);
    tma_load_5d(k_st + TILE, &tmap_v, 0, t * kKeys, 0, h, b, bar);
  };

  // this warpgroup's rows and the two rows this thread holds
  const long long wg_row0 = f0 + wg * 64;
  const bool wg_live = wg_row0 < n_rows;
  const int wg_first_pos = static_cast<int>(wg_row0 / group);
  const long long wg_row_last =
      (wg_row0 + 63 < n_rows ? wg_row0 + 63 : n_rows - 1);
  const int wg_last_pos = static_cast<int>(wg_row_last / group);
  const long long row0 = wg_row0 + warp * 16 + lane / 4;
  const int qpos0 = static_cast<int>(row0 / group);
  const int qpos1 = static_cast<int>((row0 + 8) / group);

  // causal: the last tile any row of this block can see
  const long long f_last = (f0 + kRows < n_rows ? f0 + kRows : n_rows) - 1;
  const int n_tiles = causal ? static_cast<int>(f_last / group) / kKeys + 1
                             : (s_len + kKeys - 1) / kKeys;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  if constexpr (CK > C) {
    // the K/V tiles' pad chunk (TMA writes chunks 0 .. C - 1 only)
    for (int i = tid; i < kStages * 2 * kKeys; i += kThreads)
      *reinterpret_cast<uint4*>(smem + tile_bytes<D>(kRows) +
                                (i / kKeys) * TILE + C * (kKeys * 16) +
                                (i % kKeys) * 16) = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar_s + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t);
  }
  cp_async_wait_all();  // Q
  fence_proxy_async();
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(bar_s + 8 * (t % kStages), (t / kStages) & 1);

    const int k0 = t * kKeys;
    if (wg_live && (!causal || k0 <= wg_last_pos)) {
      const uint32_t k_st = kv_s + (t % kStages) * 2 * TILE;
      float s[kKeys / 2];
      qk_scores<D>(s, q_s, k_st, wg);

      // thread element s[4i + j]: row row0 + 8 (j / 2), key
      // k0 + 8 i + 2 (lane % 4) + j % 2
      if (k0 + kKeys > s_len || (causal && k0 + kKeys - 1 > wg_first_pos)) {
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = k0 + 8 * i + 2 * (lane % 4) + j % 2;
            const int qp = j < 2 ? qpos0 : qpos1;
            if (key >= s_len || (causal && key > qp)) s[4 * i + j] = kNegInf;
          }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = fast_exp2((m0 - mx0) * scale_log2);
      const float alpha1 = fast_exp2((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        s[4 * i] = fast_exp2(fmaf(s[4 * i], scale_log2, -mc0));
        s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], scale_log2, -mc0));
        s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], scale_log2, -mc1));
        s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], scale_log2, -mc1));
        sum0 += s[4 * i] + s[4 * i + 1];
        sum1 += s[4 * i + 2] + s[4 * i + 3];
      }
      // l stays a per-thread partial sum until the end: alpha is uniform
      // over a row's quad
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }
      uint32_t p[kKeys / 16][4];
      to_a_fragments(s, p);
      pv_accumulate<D>(o, p, k_st + TILE);
    }
    __syncthreads();  // stage t % kStages is free for tile t + kStages
    if (tid == 0 && t + kStages < n_tiles) load_kv(t + kStages);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (!wg_live) return;
  const int hq = hkv * group;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long f = row0 + 8 * half;
    if (f >= n_rows) continue;
    const long long pos = f / group;
    const int head = h * group + static_cast<int>(f % group);
    bf16* orow = out + ((static_cast<long long>(b) * s_len + pos) * hq +
                        head) * D + 2 * (lane % 4);
    const float den = fmaxf(half ? l1 : l0, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * half] / den,
                                o[4 * i + 2 * half + 1] / den);
  }
}

// Self-check of the wgmma operand layouts, one block: S = Q K^T (Q 128 x D,
// K 64 x D, both contiguous bf16) through qk_scores, and O = bf16(S) V
// (V 64 x D) through to_a_fragments and pv_accumulate; s_out (128 x 64) and
// o_out (128 x D) f32, contiguous.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tile_check_kernel(const bf16* __restrict__ q,
                                      const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      float* __restrict__ s_out,
                                      float* __restrict__ o_out) {
  constexpr int C = D / 8;
  constexpr int CK = padded_d<D>() / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + tile_bytes<D>(kRows);
  const uint32_t v_s = k_s + tile_bytes<D>(kKeys);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  for (int i = tid; i < kRows * CK; i += kThreads) {
    int r, c;
    chunk_of<CK>(i, r, c);
    cp_async16(q_s + c * (kRows * 16) + r * 16, q + r * D + 8 * (c % C),
               c < C ? 16 : 0);
  }
  for (int i = tid; i < kKeys * CK; i += kThreads) {
    int j, c;
    chunk_of<CK>(i, j, c);
    cp_async16(k_s + c * (kKeys * 16) + j * 16, k + j * D + 8 * (c % C),
               c < C ? 16 : 0);
    cp_async16(v_s + c * (kKeys * 16) + j * 16, v + j * D + 8 * (c % C),
               c < C ? 16 : 0);
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  float s[kKeys / 2];
  qk_scores<D>(s, q_s, k_s, wg);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t p[kKeys / 16][4];
  to_a_fragments(s, p);
  pv_accumulate<D>(o, p, v_s);

  const int row0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s_out[r * kKeys + 8 * i + 2 * (lane % 4) + e] =
            s[4 * i + 2 * half + e];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o_out[r * D + 8 * i + 2 * (lane % 4) + e] = o[4 * i + 2 * half + e];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (chunk element, position, chunk, head, batch) view of k or v
// (B, S, H, D) with element strides (sb, ss, sh, 1), boxes of one K/V tile.
template <int D>
bool tile_map(CUtensorMap* map, const void* base, int b, int s_len, int h,
              long long sb, long long ss, long long sh) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(s_len), D / 8,
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  // strides in bytes of dims 1..4; a dim of length 1 takes any valid one
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(ss) * 2, 16,
                                 h > 1 ? static_cast<cuuint64_t>(sh) * 2 : 16,
                                 b > 1 ? static_cast<cuuint64_t>(sb) * 2 : 16};
  const cuuint32_t box[5] = {8, kKeys, D / 8, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s_len, int hkv, int group, int causal, const long long* st,
           float scale, cudaStream_t stream) {
  CUtensorMap tmap_k, tmap_v;
  if (!tile_map<D>(&tmap_k, k, b, s_len, hkv, st[3], st[4], st[5]) ||
      !tile_map<D>(&tmap_v, v, b, s_len, hkv, st[6], st[7], st[8]))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_bf16<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = static_cast<long long>(s_len) * group;
  const long long blocks =
      (n_rows + kRows - 1) / kRows * static_cast<long long>(hkv) * b;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel_bf16<D>
      <<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<bf16*>(out), b, s_len,
          hkv, group, causal, st[0], st[1], st[2], scale * kLog2e, tmap_k,
          tmap_v);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int tile_check(const void* q, const void* k, const void* v, void* s_out,
               void* o_out, cudaStream_t stream) {
  constexpr int bytes = tile_bytes<D>(kRows) + 2 * tile_bytes<D>(kKeys);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tile_check_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_tile_check_kernel<D><<<1, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(s_out),
      static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// f(std::integral_constant<int, D>()) for the head dims the kernels take:
// every multiple of 8 from 8 to 128
template <typename F>
int by_head_dim(int head_dim, F f) {
  switch (head_dim) {
#define FA_HEAD_DIM(D) \
  case D:              \
    return f(std::integral_constant<int, D>());
    FA_HEAD_DIM(8) FA_HEAD_DIM(16) FA_HEAD_DIM(24) FA_HEAD_DIM(32)
    FA_HEAD_DIM(40) FA_HEAD_DIM(48) FA_HEAD_DIM(56) FA_HEAD_DIM(64)
    FA_HEAD_DIM(72) FA_HEAD_DIM(80) FA_HEAD_DIM(88) FA_HEAD_DIM(96)
    FA_HEAD_DIM(104) FA_HEAD_DIM(112) FA_HEAD_DIM(120) FA_HEAD_DIM(128)
#undef FA_HEAD_DIM
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the CUDA error of the launch as an int (0 = launched).  dtype:
// 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the wgmma kernel).
// strides (9 values, in elements): q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
// v_sb, v_ss, v_sh.  The Python wrapper checks shapes, dtypes, unit-stride
// head dims, head_dim a multiple of 8 from 8 to 128, b, s_len, hkv,
// group >= 1 and, for bfloat16, gives the kernel 16-byte aligned bases and
// strides (a contiguous copy of an operand that has none).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b,
                                      int s_len, int hkv, int group,
                                      int head_dim, int causal, int dtype,
                                      const long long* strides, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_head_dim(head_dim, [&](auto d) {
      return f32::launch<decltype(d)::value>(q, k, v, out, b, s_len, hkv,
                                             group, causal, strides, scale,
                                             s);
    });
  if (dtype == 1)
    return by_head_dim(head_dim, [&](auto d) {
      return tc::launch<decltype(d)::value>(q, k, v, out, b, s_len, hkv,
                                            group, causal, strides, scale,
                                            s);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma layout self-check (kernels/selfcheck.py): q (128, D), k and v
// (64, D) contiguous bfloat16 -> s_out (128, 64) = q k^T and o_out (128, D)
// = bf16(s_out) v, float32.
extern "C" int flash_attention_tile_check(const void* q, const void* k,
                                          const void* v, void* s_out,
                                          void* o_out, int head_dim,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(head_dim, [&](auto d) {
    return tc::tile_check<decltype(d)::value>(q, k, v, s_out, o_out, s);
  });
}
