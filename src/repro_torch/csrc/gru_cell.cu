// Fused GRU cell for Hopper (sm_90a): one time step of the forecaster's
// recurrence, writing h' from x, h and the gate weights.
//
// Replaces the TPU kernel src/repro/kernels/gru_cell.py::_gru_kernel
// (wrapper gru_cell), which the JAX package reaches through
// kernels/ops.py::gru_cell_fused.  Same function: zx = x.Wx + b and
// zh = h.Wh with fp32 accumulation and gates [z|r|h~] along the columns of
// wx (I, 3H) and wh (H, 3H), no hidden bias; z = sig(zx_z + zh_z),
// r = sig(zx_r + zh_r), h~ = tanh(zx_h + r * zh_h), h' = z h + (1 - z) h~.
// Only h' is written, in the input dtype.
//
// What bounds it on an H100: at the serving shape (B=256, I=1, H=64, fp32)
// one step moves about 0.18 MB and does about 6.4 MFLOP, about 0.05 us of
// HBM time at 3.35 TB/s or about 0.10 us of fp32 non-tensor work at
// 67 TFLOP/s.  A kernel launch costs several microseconds more, so the
// serving forward is bound by launches and latency, not by the cell; the
// remedies (one persistent kernel for the recurrence and the head, or a
// CUDA graph per batch bucket) are later work.
//
// Design: as csrc/lstm_cell.cu.  One thread per output (b, j), j fastest so
// neighbouring threads read neighbouring columns of wx and wh; the block's
// rows of [x | h] staged in shared memory as fp32; six fp32 sums in
// registers (the x part and the h part of each gate stay apart because the
// reset gate scales only the h part of the candidate); both tails masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreadsJ = 64;  // threads along the hidden axis
constexpr int kRows = 4;       // batch rows per block

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <typename T>
__global__ void gru_cell_kernel(const T* __restrict__ x,
                                const T* __restrict__ h,
                                const T* __restrict__ wx,
                                const T* __restrict__ wh,
                                const T* __restrict__ b,
                                T* __restrict__ h_out,
                                int B, int I, int H) {
  extern __shared__ float rows[];  // kRows x (I + H), each row [x | h]
  const int K = I + H;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < kRows * K; e += blockDim.x * blockDim.y) {
    const int r = e / K;
    const int k = e - r * K;
    const int bb = row0 + r;
    float v = 0.0f;
    if (bb < B) {
      v = k < I ? load(x + static_cast<size_t>(bb) * I + k)
                : load(h + static_cast<size_t>(bb) * H + (k - I));
    }
    rows[e] = v;
  }
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int bb = row0 + threadIdx.y;
  if (j >= H || bb >= B) return;
  const float* row = rows + threadIdx.y * K;
  const size_t G = static_cast<size_t>(3) * H;

  float xz = load(b + j);
  float xr = load(b + H + j);
  float xn = load(b + 2 * H + j);
  for (int k = 0; k < I; ++k) {
    const float v = row[k];
    const T* w = wx + k * G + j;
    xz += v * load(w);
    xr += v * load(w + H);
    xn += v * load(w + 2 * H);
  }
  float hz = 0.0f, hr = 0.0f, hn = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float v = row[I + k];
    const T* w = wh + k * G + j;
    hz += v * load(w);
    hr += v * load(w + H);
    hn += v * load(w + 2 * H);
  }

  const float z = sigmoid(xz + hz);
  const float r = sigmoid(xr + hr);
  const float h_tilde = tanhf(xn + r * hn);
  store(h_out + static_cast<size_t>(bb) * H + j,
        z * row[I + j] + (1.0f - z) * h_tilde);
}

template <typename T>
int launch(const void* x, const void* h, const void* wx, const void* wh,
           const void* b, void* h_out, int B, int I, int H, void* stream) {
  const dim3 block(kThreadsJ, kRows);
  const dim3 grid((H + kThreadsJ - 1) / kThreadsJ, (B + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kRows * (I + H);
  gru_cell_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(wx), static_cast<const T*>(wh),
      static_cast<const T*>(b), static_cast<T*>(h_out), B, I, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int repro_gru_cell_f32(const void* x, const void* h, const void* wx,
                       const void* wh, const void* b, void* h_out, int B,
                       int I, int H, void* stream) {
  return launch<float>(x, h, wx, wh, b, h_out, B, I, H, stream);
}

int repro_gru_cell_bf16(const void* x, const void* h, const void* wx,
                        const void* wh, const void* b, void* h_out, int B,
                        int I, int H, void* stream) {
  return launch<__nv_bfloat16>(x, h, wx, wh, b, h_out, B, I, H, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
