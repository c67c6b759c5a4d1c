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
// visited.  The layout is the JAX package's (B, S, H, hd) for q, k, v and o,
// read and written in place: no transposes.
//
// What bounds it on an H100: at the LM slice's prefill (B=2, S=4096, Hq=40,
// Hkv=8, hd=128, bf16) the causal work is 4 * B * Hq * hd * S(S+1)/2, about
// 3.4e11 FLOP, 0.35 ms at the 989 TFLOP/s of dense bf16 on the tensor cores;
// the bytes (q, k, v read once, o written once) are about 2.0e8, 0.06 ms at
// 3.35 TB/s.  So the bound is the operations.  This kernel is the simple,
// right one: it runs on the fp32 CUDA cores (67 TFLOP/s at most, so >= 5 ms)
// and its inner loops are limited by shared-memory reads.  wgmma on the
// tensor cores, TMA and a ring of tiles are later work.
//
// Design: a block of kWarps warps takes kBlockQ = kWarps * kRowsPerWarp
// consecutive query rows of one (batch, head); each warp carries
// kRowsPerWarp rows, so one shared-memory read of a key feeds that many rows.
// The block stages its q rows once, then walks key tiles of kBlockK = 32
// keys: all threads stage the tile's k and v in shared memory as fp32, and in
// each warp lane t owns key k0 + t for the scores (a 128-bit read of its key
// row per 4 dims; the k rows are padded by 4 floats so the 32 lanes hit
// distinct banks) while the q rows are read as broadcasts.  The tile max and
// sum go across lanes by shuffles; for p.v the weights are broadcast by
// shuffles and lane t owns dims t, t + 32, ... of acc.  Masked scores take
// the finite -1e30 of the TPU kernel and their weights are set to 0
// explicitly, so a row whose first tiles are wholly masked (as happens with a
// window) adds no mass and never computes inf - inf.  Rows past S and keys
// past the tile's end are zero-filled and never stored, so any S works.  The
// blocks with the most keys (the last query tiles) are launched first.
// fp32 sums throughout; expf, not __expf; bf16 converts only through the
// cuda_bf16 intrinsics.  Launches on the calling thread's current device,
// which the Python wrapper sets; never changes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;               // the TPU kernel's constant
constexpr float kMinNorm = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int B,
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
  const T* qb = q + static_cast<size_t>(b) * S * q_stride + h * HD;
  const T* kb = k + static_cast<size_t>(b) * S * kv_stride + kvh * HD;
  const T* vb = v + static_cast<size_t>(b) * S * kv_stride + kvh * HD;
  T* ob = o + static_cast<size_t>(b) * S * q_stride + h * HD;

  for (int e = tid; e < kBlockQ * HD; e += kThreads) {
    const int r = e / HD;
    const int i = q0 + r;
    qs[e] = i < S ? load(qb + i * q_stride + (e - r * HD)) : 0.0f;
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
        kv = load(kb + j * kv_stride + d);
        vv = load(vb + j * kv_stride + d);
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
      if (HD % 32 == 0 || d < HD) store(ob + i * q_stride + d, acc[r][t] / norm);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int Hq, int Hkv, int window, float scale, void* stream) {
  const size_t smem = Tile<HD>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_q = (S + kBlockQ - 1) / kBlockQ;
  const dim3 grid(static_cast<unsigned>(n_q * B * Hq));
  flash_attention_kernel<T, HD>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), B, S, Hq, Hkv, window,
          scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int hd, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      static_cast<long long>(S + kBlockQ - 1) / kBlockQ * B * Hq >
          0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, B, S, Hq, Hkv, window, scale,
                              stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, S, Hq, Hkv, window, scale,
                              stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, S, Hq, Hkv, window, scale,
                              stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, S, Hq, Hkv, window, scale,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int S, int Hq, int Hkv, int hd,
                              int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, B, S, Hq, Hkv, hd, window, scale, stream);
}

int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int Hq, int Hkv, int hd,
                               int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, hd, window, scale,
                               stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
