// Fused LSTM cell for Hopper (sm_90a): one time step of the forecaster's
// recurrence, writing h' and c' from x, h, c and the gate weights.
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell.py::_lstm_kernel
// (wrapper lstm_cell), which the JAX package reaches through
// kernels/ops.py::lstm_cell_fused.  Same function: z = x.Wx + h.Wh + b with
// fp32 accumulation, gates [i|f|g|o] along the columns of wx (I, 4H) and
// wh (H, 4H); c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c'); only h'
// and c' are written, in the input dtype.
//
// What bounds it on an H100: at the serving shape (B=256, I=1, H=64, fp32)
// one step moves about 0.33 MB (each input read once, h' and c' written
// once) and does about 8.5 MFLOP, so its floor is about 0.10 us of HBM time
// at 3.35 TB/s or about 0.13 us of fp32 non-tensor work at 67 TFLOP/s.  A
// kernel launch costs several microseconds more than either.  The serving
// forward (lookback x n_layers launches of this kernel, plus the head) is
// therefore bound by launches and latency, not by the cell.  The remedies,
// the whole recurrence and the head in one persistent kernel or a CUDA
// graph per batch bucket, are later work: this is the simple, right kernel.
//
// Design: one thread per output (b, j).  j varies fastest inside a block,
// so neighbouring threads read neighbouring columns g*H + j of wx and wh.
// A block stages its kRows rows of [x | h] in shared memory as fp32, then
// each thread runs over k < I + H keeping the four gate sums in fp32
// registers and applies the gates in the same pass.  Both tails (b >= B,
// j >= H) are masked inside the kernel, so no shape has to divide a block.
// bf16 converts only through the cuda_bf16 intrinsics.  The entry points
// launch on the calling thread's current device, which the Python wrapper
// sets to the tensors' device; they never change it.
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
__global__ void lstm_cell_kernel(const T* __restrict__ x,
                                 const T* __restrict__ h,
                                 const T* __restrict__ c,
                                 const T* __restrict__ wx,
                                 const T* __restrict__ wh,
                                 const T* __restrict__ b,
                                 T* __restrict__ h_out,
                                 T* __restrict__ c_out,
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
  const size_t G = static_cast<size_t>(4) * H;

  float zi = load(b + j);
  float zf = load(b + H + j);
  float zg = load(b + 2 * H + j);
  float zo = load(b + 3 * H + j);
  for (int k = 0; k < I; ++k) {
    const float v = row[k];
    const T* w = wx + k * G + j;
    zi += v * load(w);
    zf += v * load(w + H);
    zg += v * load(w + 2 * H);
    zo += v * load(w + 3 * H);
  }
  for (int k = 0; k < H; ++k) {
    const float v = row[I + k];
    const T* w = wh + k * G + j;
    zi += v * load(w);
    zf += v * load(w + H);
    zg += v * load(w + 2 * H);
    zo += v * load(w + 3 * H);
  }

  const size_t out = static_cast<size_t>(bb) * H + j;
  const float c_new = sigmoid(zf) * load(c + out) + sigmoid(zi) * tanhf(zg);
  store(h_out + out, sigmoid(zo) * tanhf(c_new));
  store(c_out + out, c_new);
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx,
           const void* wh, const void* b, void* h_out, void* c_out, int B,
           int I, int H, void* stream) {
  const dim3 block(kThreadsJ, kRows);
  const dim3 grid((H + kThreadsJ - 1) / kThreadsJ, (B + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kRows * (I + H);
  lstm_cell_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(wx),
      static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<T*>(h_out), static_cast<T*>(c_out), B, I, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int repro_lstm_cell_f32(const void* x, const void* h, const void* c,
                        const void* wx, const void* wh, const void* b,
                        void* h_out, void* c_out, int B, int I, int H,
                        void* stream) {
  return launch<float>(x, h, c, wx, wh, b, h_out, c_out, B, I, H, stream);
}

int repro_lstm_cell_bf16(const void* x, const void* h, const void* c,
                         const void* wx, const void* wh, const void* b,
                         void* h_out, void* c_out, int B, int I, int H,
                         void* stream) {
  return launch<__nv_bfloat16>(x, h, c, wx, wh, b, h_out, c_out, B, I, H,
                               stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
