// Causal flash attention for Hopper (sm_90a): o = softmax(q.k^T * scale,
// masked) . v with the online softmax, one pass over the keys, the (S, S)
// score matrix never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (wrapper flash_attention), which the JAX package reaches through
// models/attention.py::_causal_attend.  Same function: s = (q.k^T) * scale,
// then the mask (causal j <= i; with a window also j > i - window), a running
// max m, normaliser l and fp32 accumulator acc per query row
// (acc = acc * alpha + p.v), and o = acc / max(l, 1e-30) in the input dtype.
// GQA folds query head h onto KV head h / (Hq / Hkv); no K/V is replicated.
// Key tiles wholly above the diagonal or wholly outside the window are never
// loaded.  The layout is the JAX package's (B, S, H, hd) for q, k, v and o,
// read and written in place: no transposes.  Any S; hd in {16, 32, 64,
// 112, 128} (112: Zamba2's shared attention block, d 3584 over 32 heads).
// Masked scores take the TPU kernel's finite -1e30 and their weights are set
// to 0 explicitly, so a row whose first tiles are wholly masked (as happens
// with a window) adds no mass and never computes inf - inf.  The blocks with
// the most keys (the last query tiles) are launched first.
//
// What bounds it on an H100: at the LM slice's prefill (B=2, S=4096, Hq=40,
// Hkv=8, hd=128, bf16) the causal work is 4 * B * Hq * hd * S(S+1)/2, about
// 3.4e11 FLOP, 0.35 ms at the 989 TFLOP/s of dense bf16 on the tensor cores;
// the bytes (q, k, v read once, o written once) are about 2.0e8, 0.06 ms at
// 3.35 TB/s.  So the bound is the operations, and only the tensor cores can
// come near it.
//
// Two kernels, chosen by dtype, explicitly (the C entries at the end):
//
// * bf16 (repro_flash_attention_bf16, the model's path): flash_sm90, on the
//   tensor cores.  A block takes 128 query rows of one (batch, head) and has
//   3 warpgroups.  The producer warpgroup drops to 24 registers (setmaxnreg)
//   and one of its threads issues TMA loads: q once, then K and V in 128-key
//   tiles through a 2-stage ring in shared memory, each stage with a "full"
//   mbarrier (TMA bytes arrived) and an "empty" one (both consumer
//   warpgroups done with it).  The two consumer warpgroups rise to 240
//   registers and own 64 query rows each: S = q.k^T is wgmma m64n128k16 with
//   q and k K-major in shared memory; the online softmax runs on the fp32
//   accumulator fragment in registers (a row is spread over the 4 threads of
//   a quad: two shuffles reduce it; the max is taken on the unscaled scores
//   and scale * log2(e) folds into one FFMA before ex2.approx); P
//   is packed to bf16 in registers, where the accumulator fragment of S is
//   already the A fragment of the next product, and O += P.v is wgmma
//   m64n{hd}k16 with A from registers and v MN-major in shared memory (the
//   transpose bit).  Only the diagonal tile, the window's boundary tiles and
//   the S tail are masked.  The epilogue divides by max(l, 1e-30) and stores
//   bf16 from registers, rows past S dropped.  The tensor maps are 4-D over
//   (hd, H, S, B), the model's own layout; TMA fills rows past S with zeros.
//   A row of a TMA box with the 128-byte swizzle is at most 128 bytes, so at
//   hd=128 a tile is two 64-column boxes (the descriptor's k-offset steps
//   into the second box at k-step 4); hd=32 and hd=16 take the 64- and
//   32-byte swizzles.  hd=112 keeps that layout at a padded width of 128:
//   the map's innermost extent is the real 112 columns (224-byte rows, a
//   multiple of TMA's 16 bytes), so the second 64-column box reads columns
//   64..127 and TMA fills 112..127 with zeros; q.k^T takes the 7 k-steps
//   that hold data, P.v runs at n128 (the zero columns of v give zero
//   columns of acc) and the epilogue stores the 112 real columns.  The maps
//   are encoded on the host at every call
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library
//   needs no -lcuda).  Not here yet: overlapping one tile's softmax with the
//   next tile's q.k^T, ping-pong between the consumer warpgroups, a
//   persistent grid.
//
// * fp32 (repro_flash_attention_f32): flash_simt, the CUDA-core kernel of the
//   port's first version.  The tensor cores take fp32 only as TF32 (10-bit
//   mantissa), which cannot hold the 2e-5 fp32 tolerance of
//   tests/test_kernels.py; so fp32 stays on fp32 FMAs (67 TFLOP/s at most).
//   A block of kWarps warps takes kRowsPerWarp rows per warp; key tiles of 32
//   are staged in shared memory as fp32; lane t owns key t for the scores
//   and dims t, t + 32, ... of acc for p.v, with the tile's max, sum and
//   weights moved by shuffles.
//
// fp32 sums throughout.  Launches on the calling thread's current device,
// which the Python wrapper sets; never changes it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's constant
constexpr float kMinNorm = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ fp32
namespace simt {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// shared memory of one block, in floats: q rows, padded k rows, v rows
template <int HD>
struct Tile {
  static constexpr int kPad = HD + 4;
  static constexpr int kQ = kBlockQ * HD;
  static constexpr int kK = kBlockK * kPad;
  static constexpr int kV = kBlockK * HD;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int B,
               int S, int Hq, int Hkv, int window, float scale) {
  constexpr int kPerLane = (HD + 31) / 32;  // acc dims each lane owns
  constexpr int kPad = Tile<HD>::kPad;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + Tile<HD>::kQ;
  float* vs = ks + Tile<HD>::kK;

  const int n_q = (S + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / (B * Hq));
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const size_t q_stride = static_cast<size_t>(Hq) * HD;   // per position
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const float* qb = q + static_cast<size_t>(b) * S * q_stride + h * HD;
  const float* kb = k + static_cast<size_t>(b) * S * kv_stride + kvh * HD;
  const float* vb = v + static_cast<size_t>(b) * S * kv_stride + kvh * HD;
  float* ob = o + static_cast<size_t>(b) * S * q_stride + h * HD;

  for (int e = tid; e < kBlockQ * HD; e += kThreads) {
    const int r = e / HD;
    const int i = q0 + r;
    qs[e] = i < S ? qb[i * q_stride + (e - r * HD)] : 0.0f;
  }

  // keys any row of this block may see
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = min(S, q0 + kBlockQ);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) acc[r][t] = 0.0f;
  }
  const float* qw = qs + warp * kRowsPerWarp * HD;
  const int row0 = q0 + warp * kRowsPerWarp;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // q staged; the previous tile fully consumed
    for (int e = tid; e < kBlockK * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int j = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (j < k_end) {
        kv = kb[j * kv_stride + d];
        vv = vb[j * kv_stride + d];
      }
      ks[r * kPad + d] = kv;
      vs[e] = vv;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * kPad);
#pragma unroll 8
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(qw + r * HD)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // mask, online softmax; s[r] becomes this lane's weight p
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = row0 + r;
      bool ok = j < k_end && j <= i;
      if (window > 0) ok = ok && j > i - window;
      const float sv = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.0f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) acc[r][t] *= alpha;
      s[r] = p;
    }

    // acc += p . v, the weights broadcast lane by lane
    const int n_keys = min(kBlockK, k_end - k0);
    for (int jj = 0; jj < n_keys; ++jj) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        pj[r] = __shfl_sync(kFull, s[r], jj);
      }
      const float* vrow = vs + jj * HD;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int d = lane + 32 * t;
        if (HD % 32 == 0 || d < HD) {
          const float vv = vrow[d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            acc[r][t] = fmaf(pj[r], vv, acc[r][t]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
    if (i >= S) continue;
    const float norm = fmaxf(l[r], kMinNorm);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int d = lane + 32 * t;
      if (HD % 32 == 0 || d < HD) ob[i * q_stride + d] = acc[r][t] / norm;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int Hq, int Hkv, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Tile<HD>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_simt<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_q = (S + kBlockQ - 1) / kBlockQ;
  const dim3 grid(static_cast<unsigned>(n_q * B * Hq));
  flash_simt<HD><<<grid, kThreads, smem, stream>>>(q, k, v, o, B, S, Hq, Hkv,
                                                   window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ------------------------------------------------------------------ bf16
namespace sm90 {

constexpr int kBlockQ = 128;  // query rows per block: 2 consumer warpgroups
constexpr int kBlockK = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V tiles in flight
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kEmptyArrivals = 8;  // lane 0 of each consumer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block for head dim HD, held at kCols columns: HD, or
// HD rounded up to a multiple of 64 past 64 (112 -> 128; TMA zero-fills the
// columns past HD).  A tile (q: 128 rows, k or v: 128 keys) comes in kBoxes
// TMA boxes of kBoxCols columns; a box row is
// kRowBytes, which is also its swizzle span (32, 64 or 128 bytes), so a box
// is 8-row swizzle atoms of 8 * kRowBytes bytes.  Every tile and box starts
// on a 1024-byte boundary, as the 128-byte swizzle needs.
template <int HD>
struct Smem {
  static constexpr int kCols = HD <= 64 ? HD : (HD + 63) / 64 * 64;
  static constexpr int kBoxCols = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = 2 * kBoxCols;
  static constexpr int kBoxes = kCols / kBoxCols;
  static constexpr int kBoxBytes = kBlockK * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kAtomBytes = 8 * kRowBytes;  // SBO of both operands
  static constexpr int kStepsPerBox = kRowBytes / 32;  // k16 steps in a row
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;  // stage s: + s * kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, full[kStages], empty[kStages]; then slack to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  // the wgmma descriptor's layout code of this swizzle: 1 = 128 B,
  // 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` of the barrier has completed;
// a wait that never ends (a broken ring) traps after about 2^30 tries
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 30)) __trap();
  }
}

// one TMA box of a 4-D map at coordinates (c0 innermost .. c3) into shared
// memory at dst; its bytes complete a transaction on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout code in bits 62-63
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// ties each accumulator register to this point of the program, so that no
// read of it moves above the wgmma wait (or a write below the next wgmma)
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x by the special-function unit alone (no denormal fix-up); x <= 0 here
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 x 128, fp32) (+)= kSignA A (64 x 16) . B^T (128 x 16), both bf16
// K-major in shared memory; kSignA is wgmma's own scale of A, 1 or -1
template <int kSignA>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, %67, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kSignA));
}

// O (64 x N, fp32) += A (64 x 16, bf16 in registers) . B (16 x N), B bf16
// MN-major in shared memory (transpose bit set); one overload per N = hd
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// The accumulator fragment of a warpgroup's m64nN tile: warp w holds rows
// 16w .. 16w + 15; thread (lane) holds, for column block c = 0 .. N/8 - 1,
// d[4c + 0, 1] = row 16w + lane/4,     columns 8c + 2(lane%4) + {0, 1},
// d[4c + 2, 3] = row 16w + lane/4 + 8, the same columns.
// The A fragment of wgmma k16 from registers is the same map over 16
// columns, so k-step kk of P.v takes d[8kk .. 8kk + 7] of S, packed in pairs.
// kSignA is the sign of the caller's scale: S is computed as (kSignA q).k^T
// and scaled by |scale|, so the row max can be taken on the unscaled scores.
template <int HD, int kSignA>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv,
               int window, float scale_log2, int n_bh) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8;             // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;   // empty[s] = empty0 + 8 s

  const int n_q = (S + kBlockQ - 1) / kBlockQ;
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  // key tiles any row of this block may see: through the diagonal tile
  // (kBlockK == kBlockQ), from the window's first key
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBlockK : 0;
  const int n_tiles = qt + 1 - kt_begin;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTileBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(sq + c * L::kBoxBytes, &qmap, q_full, c * L::kBoxCols, h, q0,
                 b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        // the stage's previous tile released by both consumer warpgroups
        // (the first round passes at once)
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const int k0 = (kt_begin + it) * kBlockK;
        mbar_expect_tx(full, 2 * L::kTileBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          const uint32_t off = s * L::kTileBytes + c * L::kBoxBytes;
          tma_load(sk + off, &kmap, full, c * L::kBoxCols, kvh, k0, b);
          tma_load(sv + off, &vmap, full, c * L::kBoxCols, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int qw0 = q0 + 64 * cw;                 // the warpgroup's rows
    const int row0 = qw0 + 16 * warp + lane / 4;  // this thread's: +0, +8
    const int col0 = 2 * (lane & 3);
    // this warpgroup's 64 q rows inside each q box
    const uint32_t q_rows = sq + cw * 64 * L::kRowBytes;

    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums
    float acc[L::kCols / 2];
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) acc[i] = 0.0f;
    float s[64];

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int k0 = (kt_begin + it) * kBlockK;
      mbar_wait(full0 + 8 * st, (it / kStages) & 1);
      // a tile wholly masked for these 64 rows (a window's edge) is skipped
      const bool skip = k0 > qw0 + 63 ||
                        (window > 0 && k0 + kBlockK - 1 <= qw0 - window);
      if (!skip) {
        const uint32_t k_tile = sk + st * L::kTileBytes;
        const uint32_t v_tile = sv + st * L::kTileBytes;

        // S = q . k^T over hd in k16 steps (the zero-filled columns past
        // HD add nothing and are skipped)
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < (HD + 15) / 16; ++ks) {
          const uint32_t off = (ks / L::kStepsPerBox) * L::kBoxBytes +
                               (ks % L::kStepsPerBox) * 32;
          wgmma_ss_n128<kSignA>(
              s, desc(q_rows + off, 16, L::kAtomBytes, L::kLayout),
              desc(k_tile + off, 16, L::kAtomBytes, L::kLayout), ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        // mask where some key is out of reach; the row max is taken on the
        // unscaled scores (scale_log2 >= 0) and m is kept in log2 units
        const bool masked = k0 + kBlockK - 1 > qw0 || k0 + kBlockK > S ||
                            (window > 0 && k0 <= qw0 + 63 - window);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          float x = s[i];
          if (masked) {
            const int row = row0 + 8 * r;
            const int col = k0 + 8 * (i >> 2) + col0 + (i & 1);
            bool ok = col <= row && col < S;
            if (window > 0) ok = ok && col > row - window;
            x = ok ? x : kNegInf;
          }
          s[i] = x;
          mx[r] = fmaxf(mx[r], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * scale_log2);
          alpha[r] = exp2_approx(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        // weights; a masked one is exactly 0
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          const float p =
              s[i] <= kNegInf ? 0.0f
                              : exp2_approx(fmaf(s[i], scale_log2, -m[r]));
          s[i] = p;
          l[r] += p;
        }
#pragma unroll
        for (int i = 0; i < L::kCols / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
          }
        }

        // acc += P . v over the tile's keys in k16 steps; v is MN-major
        // (hd contiguous): LBO steps between 64-column boxes, SBO between
        // 8-key atoms
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_rs(acc, pa[kk],
                   desc(v_tile + kk * 16 * L::kRowBytes, L::kBoxBytes,
                        L::kAtomBytes, L::kLayout));
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // o = acc / max(l, 1e-30) in bf16; rows past S and columns past HD
    // are not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const float inv = 1.0f / fmaxf(l[r], kMinNorm);
      const int row = row0 + 8 * r;
      if (row < S) {
        __nv_bfloat16* orow =
            o + (static_cast<size_t>(b) * S + row) * Hq * HD + h * HD + col0;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
              __floats2bfloat162_rn(acc[4 * c + 2 * r] * inv,
                                    acc[4 * c + 2 * r + 1] * inv);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 4-D map over (hd, H, S, B), innermost first, of a contiguous (B, S, H, hd)
// bf16 tensor; a box is kBoxCols columns of one head at 128 positions, the
// columns past hd (a box of hd=112's second half) filled with zeros
template <int HD>
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B,
              int S, int H) {
  using L = Smem<HD>;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * HD;  // bytes per (position, head)
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {L::kBoxCols, 1, kBlockK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, L::kSwizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int kSignA>
int launch_signed(const void* q, const void* k, const void* v, void* o, int B,
                  int S, int Hq, int Hkv, int window, float scale,
                  cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<HD>(&qmap, encode, q, B, S, Hq) ||
      !make_map<HD>(&kmap, encode, k, B, S, Hkv) ||
      !make_map<HD>(&vmap, encode, v, B, S, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = Smem<HD>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_sm90<HD, kSignA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_q = (S + kBlockQ - 1) / kBlockQ;
  const dim3 grid(static_cast<unsigned>(n_q * B * Hq));
  flash_sm90<HD, kSignA><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), S, Hq, Hkv, window,
      std::fabs(scale) * kLog2e, B * Hq);
  return static_cast<int>(cudaGetLastError());
}

// a negative scale goes to wgmma as the sign of q, so the kernel's scale is
// never negative
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int window, float scale, cudaStream_t stream) {
  return scale < 0.0f ? launch_signed<HD, -1>(q, k, v, o, B, S, Hq, Hkv,
                                               window, scale, stream)
                      : launch_signed<HD, 1>(q, k, v, o, B, S, Hq, Hkv,
                                              window, scale, stream);
}

}  // namespace sm90

bool bad_sizes(int B, int S, int Hq, int Hkv, int block_q) {
  return B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 ||
         static_cast<long long>(S + block_q - 1) / block_q * B * Hq >
             0x7fffffffLL;
}

}  // namespace

extern "C" {

// fp32: the CUDA-core kernel (TF32 on the tensor cores would not hold the
// fp32 tolerance)
int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int S, int Hq, int Hkv, int hd,
                              int window, float scale, void* stream) {
  if (bad_sizes(B, S, Hq, Hkv, simt::kBlockQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return simt::launch<16>(qf, kf, vf, of, B, S, Hq, Hkv, window, scale, st);
    case 32:
      return simt::launch<32>(qf, kf, vf, of, B, S, Hq, Hkv, window, scale, st);
    case 64:
      return simt::launch<64>(qf, kf, vf, of, B, S, Hq, Hkv, window, scale, st);
    case 112:
      return simt::launch<112>(qf, kf, vf, of, B, S, Hq, Hkv, window, scale,
                               st);
    case 128:
      return simt::launch<128>(qf, kf, vf, of, B, S, Hq, Hkv, window, scale,
                               st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16: wgmma on the tensor cores, fed by TMA through an mbarrier ring
int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int Hq, int Hkv, int hd,
                               int window, float scale, void* stream) {
  if (bad_sizes(B, S, Hq, Hkv, sm90::kBlockQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return sm90::launch<16>(q, k, v, o, B, S, Hq, Hkv, window, scale, st);
    case 32:
      return sm90::launch<32>(q, k, v, o, B, S, Hq, Hkv, window, scale, st);
    case 64:
      return sm90::launch<64>(q, k, v, o, B, S, Hq, Hkv, window, scale, st);
    case 112:
      return sm90::launch<112>(q, k, v, o, B, S, Hq, Hkv, window, scale, st);
    case 128:
      return sm90::launch<128>(q, k, v, o, B, S, Hq, Hkv, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
