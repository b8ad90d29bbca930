// Mamba2 SSD chunked scan for Hopper (sm_90a), as four CUDA kernels
// launched from one C entry point (plain C interface, loaded from Python
// with ctypes by repro_torch/kernels/ssd_scan.py).
//
// What it replaces: repro/kernels/ssd_scan.py ssd_scan_pallas (body
// _ssd_kernel).  Per (batch row b, head h) and chunk of L positions:
//   dt  = softplus(dt + dt_bias[h]),  da = dt * -exp(a_log[h]),
//   cs  = prefix sum of da over the chunk,
//   y_l = sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) (x_s dt_s)
//         + exp(cs_l) C_l . S_in + d_skip[h] x_l,
//   S_out = exp(cs_last) S_in + sum_s exp(cs_last - cs_s) (x_s dt_s) B_s^T,
// with the (P, N) state S carried from chunk to chunk and written out after
// the last one; head h reads B/C group h / (H/G).  The TPU kernel walks the
// chunks in order as the sequential axis of its grid, the state in VMEM.
//
// What bounds it on an H100.  At mamba2-2.7b's shape in bf16 (B 1, S 2048,
// H 80, P 64, N 128, G 1, L 256) the function is bound by bytes: x and y
// are 21 MB each, about 14 us at 3.35 TB/s, against 8 GFLOP of matrix work,
// about 8 us on the bf16 tensor cores.  A walk over the chunks in order
// (the TPU kernel's shape) leaves one block per (b, h): 80 blocks on 132
// SMs, each doing every product of its head in sequence.
//
// The design: the chunked SSD's four steps, each a kernel, all launched by
// one call on one stream, with the intermediates in a workspace that the
// wrapper allocates behind the outputs.
//   (i)   ssd_scan_scores_kernel: one block per (b, chunk, group, 64x64
//         tile of the causal L x L score matrix) computes C B^T, once per
//         group and not per head (at G = 1, once instead of 80 times),
//         stored in the operand dtype.  The same launch's other blocks
//         run the prefix sums, one warp a (b, h, chunk): softplus(dt +
//         bias), cs (adding in the order of PyTorch's CUDA cumsum, so
//         that cs is the plain version's bit for bit) and the state's
//         weights w_s = dt_s exp(cs_last - cs_s).
//   (ii)  ssd_scan_states_kernel: one block per (b, chunk, head, 64x64 tile
//         of the (P, N) state) computes the chunk's own state
//         sum_s w_s x_s B_s^T, a (P x L) (L x N) product.
//   (iii) ssd_scan_pass_kernel: one thread per (b, h, p, n) runs
//         S_c = exp(cs_last,c) S_{c-1} + local_c over the chunks, writing
//         the state entering each chunk (in the operand dtype) and the
//         final state.  The only serial part: elementwise, nc steps.
//   (iv)  ssd_scan_output_kernel: one block per (b, chunk, head, 64 rows l,
//         64 columns p): y = exp(cs_l) C_l S_in^T
//         + (scores o exp(cs_l - cs_s) dt_s o [s <= l]) x + d_skip x.
// At mamba2-2.7b that is 80 + 80, 1280, 2560 and 2560 blocks, not 80.
//
// Products.  Every product is a 64x64 output tile accumulated over slices
// of 64 contraction values, staged in shared memory in two stages: the
// raw operands (B, C, x, the inbound state) by cp.async, the ones that
// need arithmetic first (x w in (ii); exp(cs_l) C and the decayed scores
// in (iv)) by loads into registers that are issued before the current
// slice's product and stored after it.  A tile is kept in the layout its
// rows have in device memory, either rows of the contraction ("row"
// tiles) or rows of the output index ("col" tiles), padded so that no two
// rows of eight meet in a bank.  bf16: 8 warps each own 16 x 32 of the
// tile and run mma.sync.m16n8k16 (bf16 in, f32 accumulation), fragments
// loaded with ldmatrix (.trans for col tiles).  The decayed scores are
// rounded to bf16 for their product, as flash attention rounds P (y is
// rounded to bf16 anyway); dt_s is folded into them so that x enters (iv)
// as it is.  x w, whose product is the carried state, goes in as two
// bf16 parts, hi + lo (two products; the state keeps ~16 bits), and the
// state entering a chunk is rounded to bf16 only as the operand of y's
// inbound term.  float32: the same tiles on the CUDA cores in full
// float32 (no TF32), each of the 256 threads 4 x 4 outputs.  A tile's
// results go through shared memory, so that device memory is written in
// 16-byte runs of rows.  Exponents are of differences of prefix sums that
// are <= 0 where used; pairs s > l are set to 0 and never exponentiated.
// Rows past the chunk and columns past P or N are zero-filled by the
// copies and never stored.  P and N may be any multiple of 16 (the grid
// covers them in 64-wide tiles), L any length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // rows and columns of an output tile
constexpr int kSlice = 64;     // contraction values a stage

// Shared-memory row strides (elements) of the two tile layouts: a "row"
// tile [64][kSlice] (the contraction contiguous) and a "col" tile
// [kSlice][64] (the output index contiguous).  A slice of 64 rather than
// 32 halves the barriers and load latencies a tile waits on, which is
// what holds these kernels back.  bf16 rows are padded to an odd
// number of 16-byte units (ldmatrix reads 8 rows at once), f32 rows of
// the row tile to an odd number of words.
template <typename T>
struct Smem;
template <>
struct Smem<bf16> {
  static constexpr int kRow = kSlice + 8;  // 144 bytes
  static constexpr int kCol = kTile + 8;   // 144 bytes
};
template <>
struct Smem<float> {
  static constexpr int kRow = kSlice + 1;
  static constexpr int kCol = kTile;
};

// elements of one operand buffer (either layout)
template <typename T>
__host__ __device__ constexpr int buf_elems() {
  return kTile * Smem<T>::kRow > kSlice * Smem<T>::kCol
             ? kTile * Smem<T>::kRow
             : kSlice * Smem<T>::kCol;
}

// bytes of two stages of `bufs` operand buffers each
template <typename T>
__host__ __device__ constexpr int stage_bytes(int bufs = 2) {
  return 2 * bufs * buf_elems<T>() * static_cast<int>(sizeof(T));
}

// A operands of the states kernel (ii): bf16 carries x dt w as two bf16
// parts, hi + lo (about 16 bits of mantissa), so that the final state
// keeps float32's digits to 1e-3 where one rounding to bf16 would not
template <typename T>
__host__ __device__ constexpr int state_a_parts() {
  return std::is_same_v<T, bf16> ? 2 : 1;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// e^x for the decayed scores: float32 takes expf, the plain version's
// exp to the last bit; bf16 rounds the product to 8 bits, so the
// special-function unit's __expf is enough
template <typename T>
__device__ __forceinline__ float decay_exp(float x) {
  if constexpr (std::is_same_v<T, bf16>)
    return __expf(x);
  else
    return expf(x);
}

// PyTorch's softplus (threshold 20)
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; a copy that is not `full` writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A row tile: rows [0, 64) of `src` (row stride rs elements), contraction
// values [k0, k0 + kSlice), zeros for rows >= rows or values >= kmax (a
// multiple of 8).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long rs,
                                          int rows, int k0, int kmax) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same_v<T, bf16>) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 64 rows x 8 pieces of 16 bytes
      const int e = tid + kThreads * i;
      const int r = e >> 3, k = k0 + 8 * (e & 7);
      const bool full = r < rows && k < kmax;
      cp_async16(dst + r * Smem<T>::kRow + 8 * (e & 7),
                 full ? src + r * rs + k : src, full);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // 64 rows x 64 words
      const int e = tid + kThreads * i;
      const int r = e >> 6, kk = e & 63;
      const bool full = r < rows && k0 + kk < kmax;
      cp_async4(dst + r * Smem<T>::kRow + kk,
                full ? src + r * rs + k0 + kk : src, full);
    }
  }
}

// A col tile: rows k0 + [0, kSlice) of `src` (row stride rs elements),
// values [m0, m0 + 64) of each, zeros for rows >= kmax or values >= mmax
// (a multiple of 8).
template <typename T>
__device__ __forceinline__ void copy_cols(T* dst, const T* src, long long rs,
                                          int k0, int kmax, int m0,
                                          int mmax) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // values a piece
  constexpr int PER_ROW = kTile / V;                    // pieces a row
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kSlice * PER_ROW / kThreads; ++i) {
    const int e = tid + kThreads * i;
    const int kk = e / PER_ROW, mm = V * (e % PER_ROW);
    const bool full = k0 + kk < kmax && m0 + mm < mmax;
    cp_async16(dst + kk * Smem<T>::kCol + mm,
               full ? src + (k0 + kk) * rs + m0 + mm : src, full);
  }
}

// Eight float values into shared memory as T: one 16-byte store for bf16
// (dst 16-byte aligned); float32 as two float4 where VEC (dst 16-byte
// aligned), else one by one.
template <typename T, bool VEC>
__device__ __forceinline__ void store8(T* dst, const float* v) {
  if constexpr (std::is_same_v<T, bf16>) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = u;
  } else if constexpr (VEC) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = v[i];
  }
}

// Eight values of T (16-byte aligned, device or shared memory) as float.
template <typename T>
__device__ __forceinline__ void load8(float* v, const T* src) {
  if constexpr (std::is_same_v<T, bf16>) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float4 u0 = reinterpret_cast<const float4*>(src)[0];
    const float4 u1 = reinterpret_cast<const float4*>(src)[1];
    v[0] = u0.x, v[1] = u0.y, v[2] = u0.z, v[3] = u0.w;
    v[4] = u1.x, v[5] = u1.y, v[6] = u1.z, v[7] = u1.w;
  }
}

// ---------------------------------------------------------------------------
// the 64 x 64 tile product over one slice, and where each accumulator lives
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16x8, f32) += a (16x16, bf16) b (16x8, bf16)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (64 x 64 tile, this thread's 16 values) += A (64 x 32) B (32 x 64).
// A_ROWS: A is a row tile [m][k], else a col tile [k][m]; B_ROWS: B is a
// row tile [n][k], else a col tile [k][n].
template <typename T, bool A_ROWS, bool B_ROWS>
__device__ __forceinline__ void tile_product(float (&acc)[16], const T* a,
                                             const T* b) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same_v<T, bf16>) {
    constexpr int R = Smem<T>::kRow, C = Smem<T>::kCol;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm, cols 32 wn
    const int mi = lane >> 3, r = lane & 7;   // ldmatrix: matrix, row
#pragma unroll
    for (int ks = 0; ks < kSlice; ks += 16) {
      uint32_t af[4];
      if constexpr (A_ROWS)
        ldmatrix_x4(af, a + (16 * wm + r + 8 * (mi & 1)) * R + ks +
                            8 * (mi >> 1));
      else
        ldmatrix_x4_trans(af, a + (ks + r + 8 * (mi >> 1)) * C + 16 * wm +
                                  8 * (mi & 1));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int nb = 32 * wn + 16 * jp;
        uint32_t bfr[4];
        if constexpr (B_ROWS)
          ldmatrix_x4(bfr, b + (nb + r + 8 * (mi >> 1)) * R + ks +
                               8 * (mi & 1));
        else
          ldmatrix_x4_trans(bfr, b + (ks + r + 8 * (mi & 1)) * C + nb +
                                     8 * (mi >> 1));
        mma_bf16(acc + 8 * jp, af, bfr[0], bfr[1]);
        mma_bf16(acc + 8 * jp + 4, af, bfr[2], bfr[3]);
      }
    }
  } else {
    constexpr int R = Smem<T>::kRow, C = Smem<T>::kCol;
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll 8
    for (int k = 0; k < kSlice; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = A_ROWS ? a[(ty + 16 * i) * R + k] : a[k * C + ty + 16 * i];
        bv[i] = B_ROWS ? b[(tx + 16 * i) * R + k] : b[k * C + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * i + j] = fmaf(av[i], bv[j], acc[4 * i + j]);
    }
  }
}

// (row, column) in the 64 x 64 tile of this thread's accumulator e
template <typename T>
__device__ __forceinline__ void acc_pos(int e, int& row, int& col) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same_v<T, bf16>) {
    const int warp = tid >> 5, lane = tid & 31;
    row = 16 * (warp & 3) + (lane >> 2) + 8 * ((e >> 1) & 1);
    col = 32 * (warp >> 2) + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
  } else {
    row = (tid >> 4) + 16 * (e >> 2);
    col = (tid & 15) + 16 * (e & 3);
  }
}

// The tile's accumulators into shared memory, `tmp` (64 rows of kTmp
// floats, 16-byte aligned), so that the epilogue writes whole 16-byte runs
// of rows to device memory rather than each thread's scattered values.
constexpr int kTmp = kTile + 4;

template <typename T>
__device__ __forceinline__ void acc_to_shared(const float (&acc)[16],
                                              float* tmp) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    int row, col;
    acc_pos<T>(e, row, col);
    tmp[row * kTmp + col] = acc[e];
  }
  __syncthreads();
}

// One pipeline over nk slices, both operands raw (cp.async): issue(slice,
// a_buf, b_buf) starts the copies of a slice.  Leaves the buffers free.
template <typename T, bool A_ROWS, bool B_ROWS, typename Issue>
__device__ __forceinline__ void raw_pipeline(float (&acc)[16], T* bufs,
                                             int nk, Issue issue) {
  constexpr int E = buf_elems<T>();
  issue(0, bufs, bufs + E);
  cp_async_commit();
  for (int it = 0; it < nk; ++it) {
    T* a = bufs + (it & 1) * 2 * E;
    cp_async_wait_all();
    __syncthreads();  // slice it landed; slice it - 1's buffers are free
    if (it + 1 < nk) {
      T* an = bufs + ((it + 1) & 1) * 2 * E;
      issue(it + 1, an, an + E);
      cp_async_commit();
    }
    tile_product<T, A_ROWS, B_ROWS>(acc, a, a + E);
  }
  __syncthreads();
}

// One pipeline over nk slices with A computed in registers: load(slice,
// regs) issues the loads of a thread's share of a slice, store(slice,
// regs, stage) writes them (transformed) into the stage's A buffer (and
// any further part at stage + 2 E), issue_b(slice, b_buf) starts the B
// copies, product(slice, stage) accumulates the slice.  A stage is NBUF
// buffers: [A][B][A2 ...].  ready() runs once, while the first slice's
// loads are in flight, before the first store (it ends with a barrier
// where the stores read what it fills).  The loads of slice it + 1 are in
// flight during slice it's product.  Returns the last slice's stage,
// intact.
template <typename T, int NBUF, typename Regs, typename Ready, typename Load,
          typename Store, typename IssueB, typename Product>
__device__ __forceinline__ T* reg_pipeline(T* bufs, int nk, Ready ready,
                                           Load load, Store store,
                                           IssueB issue_b, Product product) {
  constexpr int E = buf_elems<T>();
  constexpr int STAGE = NBUF * E;
  Regs regs;
  load(0, regs);
  issue_b(0, bufs + E);
  cp_async_commit();
  ready();
  store(0, regs, bufs);
  for (int it = 0; it < nk; ++it) {
    T* a = bufs + (it & 1) * STAGE;
    T* an = bufs + ((it + 1) & 1) * STAGE;
    cp_async_wait_all();
    __syncthreads();  // slice it is in place; slice it - 1's buffers free
    if (it + 1 < nk) {
      load(it + 1, regs);
      issue_b(it + 1, an + E);
      cp_async_commit();
    }
    product(it, a);
    if (it + 1 < nk) store(it + 1, regs, an);
  }
  __syncthreads();
  return bufs + ((nk - 1) & 1) * STAGE;
}

// A thread's share of a 64 x 64 slice, as loaded for a reg_pipeline
// store: two runs of eight values.
struct Regs16 {
  float v[16];
};

// ---------------------------------------------------------------------------
// the arguments, and the four kernels
// ---------------------------------------------------------------------------

template <typename T>
struct Args {
  const T* x;
  const void* dt;  // float32 or bfloat16 (dt_bf16)
  const float* a_log;
  const T* b;
  const T* c;
  const float* d_skip;
  const float* dt_bias;
  T* y;          // (B, S, H, P) contiguous
  float* state;  // (B, H, P, N) contiguous
  T* scores;      // (B, nc, G, LP, LP), in the operand dtype
  float* cs;      // (B, H, S): prefix sums of da within each chunk
  float* dts;     // (B, H, S): softplus(dt + bias)
  float* w;       // (B, H, S): dts exp(cs_last - cs), the state's weights
  float* local;   // (B, nc, H, P, N): each chunk's own state
  T* s_in;        // (B, nc, H, P, N): the state entering each chunk
  int bsz, s_len, heads, groups, p, n, chunk, n_chunks, lp, dt_bf16;
  int scan_log;  // the prefix sum's blocks are 2 << scan_log values
  int prefix_rows;  // (b, h, chunk) rows a block of kernel (i) scans
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb,
      c_ss, c_sg;
};

__host__ __device__ constexpr int tiles64(int n) { return (n + 63) / 64; }

// The prefix sums of one (b, h, chunk) row by one warp, in `buf` (the
// chunk rounded up to a scan block) and `dbuf` (the chunk):
// softplus(dt + bias) and da, their prefix sum cs, and
// w = dts exp(cs_last - cs), into the workspace.  dt is read four values
// a lane at a time, so that the loads' latencies overlap.
//
// The prefix sum adds in the order of PyTorch's CUDA cumsum over the last
// dim (ATen's scan_innermost_dim, which the plain version's torch.cumsum
// runs): blocks of 2 << scan_log values, the running total added to each
// block's first value, then a Sklansky scan inside the block.  So cs, and
// every exp(cs_l - cs_s) the outputs take, equal the plain version's bit
// for bit; only the products' sums differ in order.
template <typename T>
__device__ __forceinline__ void prefix_row(const Args<T>& a, int row,
                                           float* buf, float* dbuf) {
  const int lane = threadIdx.x & 31;
  const int L = a.chunk;
  const int block = 2 << a.scan_log;
  const int l_pad = (L + block - 1) / block * block;
  const int c = row % a.n_chunks;
  const int bh = row / a.n_chunks;
  const int b = bh / a.heads, h = bh % a.heads;
  const long long pos = static_cast<long long>(c) * L;
  const long long off = static_cast<long long>(bh) * a.s_len + pos;
  const float neg_a = -expf(a.a_log[h]);
  const float bias = a.dt_bias[h];
  const long long dt0 = b * a.dt_sb + pos * a.dt_ss + h * a.dt_sh;
  for (int s0 = 0; s0 < l_pad; s0 += 128) {
    float raw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + 32 * j + lane;
      const long long i = dt0 + s * a.dt_ss;
      raw[j] = s >= L ? 0.f
               : a.dt_bf16
                   ? __bfloat162float(__ldg(static_cast<const bf16*>(a.dt) + i))
                   : __ldg(static_cast<const float*>(a.dt) + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + 32 * j + lane;
      if (s < L) {
        const float d = softplus(raw[j] + bias);
        dbuf[s] = d;
        buf[s] = d * neg_a;
      } else if (s < l_pad) {
        buf[s] = 0.f;
      }
    }
  }
  __syncwarp();
  float total = 0.f;
  if (block == 32) {
    // blocks of one value a lane: the same adds through shuffles
    for (int base = 0; base < L; base += 32) {
      float v = buf[base + lane];
      if (lane == 0) v = v + total;
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const int half = 1 << m;
        const float up = __shfl_sync(
            0xffffffffu, v, ((lane >> (m + 1)) << (m + 1)) + half - 1);
        if (lane & half) v = v + up;
      }
      buf[base + lane] = v;
      total = __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
  } else {
    for (int base = 0; base < L; base += block) {
      float* blk = buf + base;
      if (lane == 0) blk[0] = blk[0] + total;
      __syncwarp();
      for (int m = 0; m <= a.scan_log; ++m) {
        const int half = 1 << m;
        for (int x = lane; x < block / 2; x += 32) {
          const int lo = ((x >> m) << (m + 1)) | half;
          const int ti = lo + (x & (half - 1));
          blk[ti] = blk[ti] + blk[lo - 1];
        }
        __syncwarp();
      }
      total = blk[block - 1];
    }
  }
  const float cs_last = buf[L - 1];
  for (int s = lane; s < L; s += 32) {
    a.cs[off + s] = buf[s];
    a.dts[off + s] = dbuf[s];
    a.w[off + s] = dbuf[s] * expf(cs_last - buf[s]);
  }
}

// (i) Two independent jobs in one launch (grid.x = tri(nt) * B * nc * G
// blocks of scores, then the prefix blocks).  A scores block: C B^T of
// one (b, chunk, group, 64x64 lower tile).  A prefix block: prefix_rows
// (b, h, chunk) rows, one a warp (prefix_row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_scores_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = tiles64(a.chunk);
  const int tri = nt * (nt + 1) / 2;
  const long long n_scores =
      static_cast<long long>(tri) * a.bsz * a.n_chunks * a.groups;
  if (blockIdx.x >= n_scores) {
    const int warp = threadIdx.x >> 5;
    const long long row =
        (blockIdx.x - n_scores) * a.prefix_rows + warp;
    if (warp < a.prefix_rows &&
        row < static_cast<long long>(a.bsz) * a.heads * a.n_chunks) {
      const int block = 2 << a.scan_log;
      const int l_pad = (a.chunk + block - 1) / block * block;
      float* buf = reinterpret_cast<float*>(smem) + warp * (l_pad + a.chunk);
      prefix_row(a, static_cast<int>(row), buf, buf + l_pad);
    }
    return;
  }
  T* bufs = reinterpret_cast<T*>(smem);
  const int tile = blockIdx.x % tri;
  const int rest = blockIdx.x / tri;
  const int g = rest % a.groups, bc = rest / a.groups;
  const int b = bc / a.n_chunks, c = bc % a.n_chunks;
  int lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= tile) ++lt;
  const int st = tile - lt * (lt + 1) / 2;
  const long long pos = static_cast<long long>(c) * a.chunk;
  const T* cr = a.c + b * a.c_sb + g * a.c_sg + (pos + 64 * lt) * a.c_ss;
  const T* br = a.b + b * a.b_sb + g * a.b_sg + (pos + 64 * st) * a.b_ss;
  const int rows_l = min(kTile, a.chunk - 64 * lt);
  const int rows_s = min(kTile, a.chunk - 64 * st);

  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  raw_pipeline<T, true, true>(
      acc, bufs, (a.n + kSlice - 1) / kSlice, [&](int it, T* ab, T* bb) {
        copy_rows(ab, cr, a.c_ss, rows_l, it * kSlice, a.n);
        copy_rows(bb, br, a.b_ss, rows_s, it * kSlice, a.n);
      });
  T* out = a.scores +
           ((static_cast<long long>(bc) * a.groups + g) * a.lp + 64 * lt) *
               a.lp +
           64 * st;
  float* tmp = reinterpret_cast<float*>(smem);
  acc_to_shared<T>(acc, tmp);
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 64 rows x 8 runs of eight
    const int e = threadIdx.x + kThreads * i;
    const int row = e >> 3, c8 = 8 * (e & 7);
    store8<T, true>(out + static_cast<long long>(row) * a.lp + c8,
                    tmp + row * kTmp + c8);
  }
}

// (ii) one (b, chunk, head, 64x64 tile of the (P, N) state): grid.x =
// tiles64(P) * tiles64(N) * B * nc, grid.y = H.  Shared memory: the
// stages, then w (chunk floats).
// (registers capped for three blocks an SM: 85 a thread)
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_scan_states_kernel(const Args<T> a) {
  constexpr int NA = state_a_parts<T>();
  constexpr int E = buf_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  const int L = a.chunk;
  float* w = reinterpret_cast<float*>(smem + stage_bytes<T>(NA + 1));
  const int tid = threadIdx.x;
  const int pts = tiles64(a.p), tiles = pts * tiles64(a.n);
  const int tile = blockIdx.x % tiles;
  const int bc = blockIdx.x / tiles;
  const int b = bc / a.n_chunks, c = bc % a.n_chunks;
  const int pt = tile % pts, nt = tile / pts;
  const int h = blockIdx.y;
  const int g = h / (a.heads / a.groups);
  const long long pos = static_cast<long long>(c) * L;
  const float* wr = a.w + (static_cast<long long>(b) * a.heads + h) *
                              a.s_len + pos;

  // state tile [p][n] = sum_s (x_s w_s)[p] B_s[n]: A = (x w)^T from a col
  // tile [s][p], B from a col tile [s][n].  This thread's A values: rows
  // kk and kk + 32 of a slice, columns m8 .. m8 + 7.
  const T* xr = a.x + b * a.x_sb + h * a.x_sh + pos * a.x_ss;
  const T* br = a.b + b * a.b_sb + g * a.b_sg + pos * a.b_ss;
  const int kk = tid >> 3, m8 = 8 * (tid & 7);
  const int p0 = 64 * pt + m8;
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  reg_pipeline<T, NA + 1, Regs16>(
      bufs, (L + kSlice - 1) / kSlice,
      [&] {
        for (int s = tid; s < L; s += kThreads) w[s] = wr[s];
        __syncthreads();
      },
      [&](int it, Regs16& r) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int s = it * kSlice + kk + 32 * q;
          if (s < L && p0 < a.p) {
            load8(r.v + 8 * q, xr + s * a.x_ss + p0);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) r.v[8 * q + i] = 0.f;
          }
        }
      },
      [&](int it, Regs16& r, T* ab) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int s = it * kSlice + kk + 32 * q;
          const float ws_ = s < L ? w[s] : 0.f;
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = r.v[8 * q + i] * ws_;
          T* dst = ab + (kk + 32 * q) * Smem<T>::kCol + m8;
          store8<T, true>(dst, v);
          if constexpr (NA == 2) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              v[i] -= to_f32(from_f32<T>(v[i]));  // the part bf16 drops
            store8<T, true>(dst + 2 * E, v);
          }
        }
      },
      [&](int it, T* bb) {
        copy_cols(bb, br, a.b_ss, it * kSlice, L, 64 * nt, a.n);
      },
      [&](int, T* st) {
        tile_product<T, false, false>(acc, st, st + E);
        if constexpr (NA == 2)
          tile_product<T, false, false>(acc, st + 2 * E, st + E);
      });
  float* out = a.local +
               ((static_cast<long long>(bc) * a.heads + h) * a.p) * a.n;
  float* tmp = reinterpret_cast<float*>(smem);
  acc_to_shared<T>(acc, tmp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 64 rows x 16 runs of four
    const int e = tid + kThreads * i;
    const int row = e >> 4, c4 = 4 * (e & 15);
    const int p = 64 * pt + row, n = 64 * nt + c4;
    if (p < a.p && n < a.n)
      *reinterpret_cast<float4*>(out + static_cast<long long>(p) * a.n + n) =
          *reinterpret_cast<const float4*>(tmp + row * kTmp + c4);
  }
}

// (iii) the state passed from chunk to chunk: one thread per (b, h, p, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_pass_kernel(const Args<T> a) {
  const long long pn = static_cast<long long>(a.p) * a.n;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= a.bsz * a.heads * pn) return;
  const long long bh = i / pn, e = i % pn;
  const int b = static_cast<int>(bh / a.heads);
  const int h = static_cast<int>(bh % a.heads);
  const float* cs_last = a.cs + bh * a.s_len + a.chunk - 1;
  const long long step = static_cast<long long>(a.heads) * pn;
  const long long off0 =
      (static_cast<long long>(b) * a.n_chunks * a.heads + h) * pn + e;
  float st = 0.f;
  for (int c = 0; c < a.n_chunks; ++c) {
    const float loc = __ldg(a.local + off0 + c * step);
    a.s_in[off0 + c * step] = from_f32<T>(st);
    st = expf(__ldg(cs_last + static_cast<long long>(c) * a.chunk)) * st +
         loc;
  }
  a.state[i] = st;
}

// (iv) y of one (b, chunk, head, 64 rows l, 64 columns p): grid.x =
// tiles64(L) * tiles64(P) * B * nc, grid.y = H.  Shared memory: the
// stages, then cs and dts of the chunk's positions [0, l_end) (each array
// LP floats, read eight at a time).
//
// One pipeline of slices: first (chunks after the first) the inbound
// state's, A = exp(cs_l) C_l (row tile [l][n]) and B = S_in (row tile
// [p][n]); then the chunk's own, A = the decayed scores (row tile [l][s],
// from the float32 workspace) and B = x (col tile [s][p]).  The last
// slice's x rows are the block's own rows l, so the skip term reads them
// from shared memory.
// (bf16: registers capped for four blocks an SM, 64 a thread)
template <typename T>
__global__ void __launch_bounds__(kThreads, std::is_same_v<T, bf16> ? 4 : 2)
    ssd_scan_output_kernel(const Args<T> a) {
  constexpr int E = buf_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  const int L = a.chunk;
  float* cs = reinterpret_cast<float*>(smem + stage_bytes<T>());
  float* dts = cs + a.lp;
  const int tid = threadIdx.x;
  const int lts = tiles64(L), tiles = lts * tiles64(a.p);
  const int tile = blockIdx.x % tiles;
  const int bc = blockIdx.x / tiles;
  const int b = bc / a.n_chunks, c = bc % a.n_chunks;
  const int lt = tile % lts, pt = tile / lts;
  const int h = blockIdx.y;
  const int g = h / (a.heads / a.groups);
  const int l0 = 64 * lt;
  const int rows = min(kTile, L - l0);
  const int l_end = l0 + rows;
  const long long pos = static_cast<long long>(c) * L;
  const long long ws = (static_cast<long long>(b) * a.heads + h) * a.s_len +
                       pos;
  const T* cr = a.c + b * a.c_sb + g * a.c_sg + (pos + l0) * a.c_ss;
  const T* sr = a.s_in +
                ((static_cast<long long>(bc) * a.heads + h) * a.p +
                 64 * pt) * a.n;
  const T* sc = a.scores +
                    ((static_cast<long long>(bc) * a.groups + g) * a.lp +
                     l0) * a.lp;
  const T* xr = a.x + b * a.x_sb + h * a.x_sh + pos * a.x_ss;
  // this thread's A values: row r of the tile, columns k8 .. k8 + 7 and
  // k8 + 32 .. k8 + 39 of a slice
  const int r = tid >> 2, k8 = 8 * (tid & 3);
  const int l = l0 + r;
  float cs_l = 0.f, in_scale = 0.f;  // cs of row l and exp(cs_l), once read
  const int n1 = c > 0 ? (a.n + kSlice - 1) / kSlice : 0;
  const int n2 = (l_end + kSlice - 1) / kSlice;
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  const T* last = reg_pipeline<T, 2, Regs16>(
      bufs, n1 + n2,
      [&] {
        for (int s = tid; s < l_end; s += kThreads) {
          cs[s] = a.cs[ws + s];
          dts[s] = a.dts[ws + s];
        }
        __syncthreads();
        if (r < rows) {
          cs_l = cs[l];
          in_scale = expf(cs_l);
        }
      },
      [&](int it, Regs16& v) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (it < n1) {
            const int n = it * kSlice + k8 + 32 * q;
            if (r < rows && n < a.n) {
              load8(v.v + 8 * q, cr + r * a.c_ss + n);
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i) v.v[8 * q + i] = 0.f;
            }
          } else {
            load8(v.v + 8 * q, sc + static_cast<long long>(r) * a.lp +
                                   (it - n1) * kSlice + k8 + 32 * q);
          }
        }
      },
      [&](int it, Regs16& v, T* ab) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float d[8];
          if (it < n1) {
#pragma unroll
            for (int i = 0; i < 8; ++i) d[i] = v.v[8 * q + i] * in_scale;
          } else {
            const int s0 = (it - n1) * kSlice + k8 + 32 * q;
            float css[8], dss[8];  // past l_end: never used
            load8(css, cs + s0);
            load8(dss, dts + s0);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int s = s0 + i;
              d[i] = r < rows && s <= l
                         ? v.v[8 * q + i] * decay_exp<T>(cs_l - css[i]) *
                               dss[i]
                         : 0.f;
            }
          }
          store8<T, false>(ab + r * Smem<T>::kRow + k8 + 32 * q, d);
        }
      },
      [&](int it, T* bb) {
        if (it < n1)
          copy_rows(bb, sr, a.n, a.p - 64 * pt, it * kSlice, a.n);
        else
          copy_cols(bb, xr, a.x_ss, (it - n1) * kSlice, l_end, 64 * pt,
                    a.p);
      },
      [&](int it, T* st) {
        if (it < n1)
          tile_product<T, true, true>(acc, st, st + E);
        else
          tile_product<T, true, false>(acc, st, st + E);
      });

  // + d_skip x (x_l from the last slice's col tile), through the other
  // stage's buffers as the staging tile, then stored in 16-byte runs
  const T* xl = last + E;
  float* tmp = reinterpret_cast<float*>(last == bufs ? bufs + 2 * E : bufs);
  acc_to_shared<T>(acc, tmp);
  const float skip = a.d_skip[h];
  const long long hp = static_cast<long long>(a.heads) * a.p;
  T* yb = a.y + (b * a.s_len + pos + l0) * hp + h * a.p;
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 64 rows x 8 runs of eight
    const int e = tid + kThreads * i;
    const int row = e >> 3, c8 = 8 * (e & 7);
    const int p = 64 * pt + c8;
    if (row < rows && p < a.p) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = tmp[row * kTmp + c8 + j] +
               skip * to_f32(xl[row * Smem<T>::kCol + c8 + j]);
      store8<T, true>(yb + row * hp + p, v);
    }
  }
}

template <typename K>
int shared_bytes(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// log2 of the threads along a row that ATen's CUDA cumsum over the last
// dim gives rows of row_size values when there are num_rows of them
// (get_log_num_threads_x_inner_scan, in its unsigned arithmetic): its scan
// blocks are twice that many values
int torch_scan_log(unsigned num_rows, unsigned row_size) {
  unsigned lx = 0, ly = 0;
  while ((1u << lx) < row_size) ++lx;
  while ((1u << ly) < num_rows) ++ly;
  unsigned log_x = (9u + (lx - ly)) / 2u;
  return static_cast<int>(log_x < 4u ? 4u : (log_x > 9u ? 9u : log_x));
}

template <typename T>
int launch_all(Args<T>& a, cudaStream_t stream) {
  const long long bnc = static_cast<long long>(a.bsz) * a.n_chunks;
  const int nt = tiles64(a.chunk);
  const int block = 2 << a.scan_log;
  const int l_pad = (a.chunk + block - 1) / block * block;
  const int base = stage_bytes<T>();
  // prefix rows a block of (i): one a warp, their buffers within the
  // stages' shared memory
  a.prefix_rows = min(kThreads / 32, base / ((l_pad + a.chunk) * 4));
  const long long rows = bnc * a.heads;
  const long long grid_i = nt * (nt + 1) / 2 * bnc * a.groups +
                           (rows + a.prefix_rows - 1) / a.prefix_rows;
  const long long grid_ii = static_cast<long long>(tiles64(a.p)) *
                            tiles64(a.n) * bnc;
  const long long grid_iv = static_cast<long long>(nt) * tiles64(a.p) * bnc;
  const long long n_iii = rows / a.n_chunks * a.p * a.n;
  if (a.prefix_rows < 1 || grid_i >= (1LL << 31) || grid_ii >= (1LL << 31) ||
      grid_iv >= (1LL << 31) || a.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes_ii = stage_bytes<T>(state_a_parts<T>() + 1) + a.chunk * 4;
  const int bytes_iv = base + 2 * a.lp * 4;
  int err = shared_bytes(ssd_scan_scores_kernel<T>, base);
  if (!err) err = shared_bytes(ssd_scan_states_kernel<T>, bytes_ii);
  if (!err) err = shared_bytes(ssd_scan_output_kernel<T>, bytes_iv);
  if (err) return err;
  ssd_scan_scores_kernel<T>
      <<<static_cast<unsigned>(grid_i), kThreads, base, stream>>>(a);
  ssd_scan_states_kernel<T>
      <<<dim3(static_cast<unsigned>(grid_ii), a.heads), kThreads, bytes_ii,
         stream>>>(a);
  ssd_scan_pass_kernel<T>
      <<<static_cast<unsigned>((n_iii + kThreads - 1) / kThreads), kThreads,
         0, stream>>>(a);
  ssd_scan_output_kernel<T>
      <<<dim3(static_cast<unsigned>(grid_iv), a.heads), kThreads, bytes_iv,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const long long* v) {
  Args<T> a;
  a.x = reinterpret_cast<const T*>(v[0]);
  a.dt = reinterpret_cast<const void*>(v[1]);
  a.a_log = reinterpret_cast<const float*>(v[2]);
  a.b = reinterpret_cast<const T*>(v[3]);
  a.c = reinterpret_cast<const T*>(v[4]);
  a.d_skip = reinterpret_cast<const float*>(v[5]);
  a.dt_bias = reinterpret_cast<const float*>(v[6]);
  a.y = reinterpret_cast<T*>(v[7]);
  a.state = reinterpret_cast<float*>(v[8]);
  a.scores = reinterpret_cast<T*>(v[9]);
  a.cs = reinterpret_cast<float*>(v[10]);
  a.dts = reinterpret_cast<float*>(v[11]);
  a.w = reinterpret_cast<float*>(v[12]);
  a.local = reinterpret_cast<float*>(v[13]);
  a.s_in = reinterpret_cast<T*>(v[14]);
  a.bsz = static_cast<int>(v[15]);
  a.s_len = static_cast<int>(v[16]);
  a.heads = static_cast<int>(v[17]);
  a.groups = static_cast<int>(v[18]);
  a.p = static_cast<int>(v[19]);
  a.n = static_cast<int>(v[20]);
  a.chunk = static_cast<int>(v[21]);
  a.dt_bf16 = static_cast<int>(v[23]);
  a.n_chunks = a.s_len / a.chunk;
  a.lp = 64 * tiles64(a.chunk);
  // the plain version's torch.cumsum scans (B, H, nc) rows of a chunk
  a.scan_log = torch_scan_log(
      static_cast<unsigned>(a.bsz) * a.heads * a.n_chunks, a.chunk);
  a.x_sb = v[24], a.x_ss = v[25], a.x_sh = v[26];
  a.dt_sb = v[27], a.dt_ss = v[28], a.dt_sh = v[29];
  a.b_sb = v[30], a.b_ss = v[31], a.b_sg = v[32];
  a.c_sb = v[33], a.c_ss = v[34], a.c_sg = v[35];
  return launch_all(a, reinterpret_cast<cudaStream_t>(v[36]));
}

}  // namespace

// The scan's one entry point: the four kernels on one stream.  Arguments
// packed into one int64 array (no per-call conversion on the Python side):
//   0-6   x, dt, a_log, b, c, d_skip, dt_bias
//   7-14  y, state, then the workspace: scores, cs, dts, w, local, s_in
//   15-23 B, S, H, G, P, N, chunk, dtype (0 float32, 1 bfloat16; x, b, c,
//         y and s_in), dt's dtype (0 float32, 1 bfloat16)
//   24-35 strides in elements: x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
//         b_sb, b_ss, b_sg, c_sb, c_ss, c_sg
//   36    the stream
// a_log, d_skip and dt_bias are float32.  Returns the CUDA error of the
// launches as an int (0 = launched).  The Python wrapper checks shapes,
// dtypes, P and N multiples of 16 (P <= 128, N <= 256), chunk dividing S,
// heads a multiple of groups, unit-stride last dims and 16-byte aligned
// rows of x, b and c.
extern "C" int ssd_scan_launch(const long long* v) {
  if (v[22] == 0) return launch_t<float>(v);
  if (v[22] == 1) return launch_t<bf16>(v);
  return static_cast<int>(cudaErrorInvalidValue);
}
