// LSTM layer for Hopper (sm_90a): the fused LSTM cell scanned over a whole
// time-major sequence in one launch, writing every step's h and the last c.
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell.py::_lstm_kernel
// (wrapper lstm_cell), which the JAX package reaches through
// kernels/ops.py::lstm_cell_fused, one step per call, and scans over the
// look-back with lax.scan (src/repro/models/forecaster.py:94-119).  Same
// function at each step: z = x.Wx + h.Wh + b with fp32 accumulation, gates
// [i|f|g|o] along the columns of wx (I, 4H) and wh (H, 4H);
// c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c').  h' and c' are
// rounded to the input dtype after every step, as the step's outputs are,
// so the layer is the scan of the step.  At T = 1 it is the step.
//
// What bounds it on an H100: at the serving shape (T=8, B=256, I=1, H=64,
// fp32) the layer does 68 MFLOP, about 1.0 us of fp32 non-tensor work at
// 67 TFLOP/s, and moves about 0.67 MB (x, h0, c0 and the weights read
// once, every h and the last c written once), 0.2 us of HBM time.  The
// steps are serial, so what a launch costs is T times the latency of one
// step on one SM.  The design keeps everything a step needs on chip: the
// weights come into shared memory once per launch (the bulk copy, see
// csrc/recurrent_layer.cuh), h is exchanged through shared memory and c
// stays in registers, so a step reads nothing from device memory but the
// next x, which is loaded while the step computes.
//
// Design: a block owns `rows` batch rows (2 at the serving shape: 128
// blocks on 132 SMs) and hc hidden columns.  KS = 2 or 4 lanes share a
// column j and RPT = 1 or 2 of the rows; each sums its share of k for all
// four gates of those rows in fp32 registers, so each weight read from
// shared memory feeds RPT FMAs, and a butterfly of shuffles adds the
// shares; lane ks then finishes row ks, its c in a register throughout.
// Where the weights do not fit one block's shared memory (H = 128 and 256
// in fp32), a cluster of 2-8 blocks splits the columns and exchanges h'
// through distributed shared memory.  fp32 stays on the CUDA cores (TF32
// would miss the fp32 tolerance); bf16 reads its weights as bf16 and
// accumulates in fp32.  The entry points launch on the calling thread's
// current device, which the Python wrapper sets; they never change it.
#include "recurrent_layer.cuh"

namespace {

constexpr int kGates = 4;

template <typename T, int RPT, int KS>
__global__ void __launch_bounds__(layer::kMaxThreads, 1)
    lstm_layer_kernel(const T* __restrict__ x_seq, const T* __restrict__ h0,
                      const T* __restrict__ c0, const T* __restrict__ wx,
                      const T* __restrict__ wh, const T* __restrict__ b,
                      T* __restrict__ h_seq, T* __restrict__ c_out,
                      layer::Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  LAYER_STAMP(0);
  const layer::Layout<T, kGates> L(d);
  const int row0 = blockIdx.x * d.rows;
  const int j0 = blockIdx.y * L.hc;
  const int nvalid = min(L.hc, d.H - j0);
  layer::prologue<T, kGates>(d, L, smem, x_seq, h0, wx, wh, b, row0, j0,
                             nvalid);
  const T* W = reinterpret_cast<const T*>(smem + L.w_off);
  const T* bias = reinterpret_cast<const T*>(smem + L.b_off);
  float* rowbuf = reinterpret_cast<float*>(smem + L.rowbuf_off);

  LAYER_STAMP(6);
  const layer::Place at = layer::Place::of<RPT, KS>(d, L.hc, nvalid);
  const int j = j0 + at.jl;
  const int row = row0 + at.r0 + at.ks;  // the row this lane finishes
  float c = at.finishes && row < d.B  // its c, in a register throughout
                ? layer::load(c0 + static_cast<size_t>(row) * d.H + j)
                : 0.0f;

  layer::NextX<T> next_x;
  for (int t = 0; t < d.T; ++t) {
    const float* cur = rowbuf + (t & 1) * d.rows * L.kw;
    float* nxt = rowbuf + ((t + 1) & 1) * d.rows * L.kw;
    next_x.load_step(d, x_seq, t + 1, row0);
    LAYER_STAMP(8 + 4 * t);
    float a[kGates][RPT];
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      // the bias enters once, in lane 0's share
      const float bg =
          at.ks == 0 ? layer::load(bias + g * L.hc + at.jl) : 0.0f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) a[g][r] = bg;
    }
    layer::accumulate<T, kGates, RPT, KS>(cur + at.r_read * L.kw, L.kw,
                                          W + at.jl, L.hc, L.ws, 0, L.kw,
                                          at.ks, a);
    layer::reduce_lanes<kGates, RPT, KS>(a);
    LAYER_STAMP(9 + 4 * t);
    if (at.finishes) {
      float z[kGates];
      layer::pick(a, at.ks, z);
      const float c_new =
          layer::sigmoid(z[1]) * c + layer::sigmoid(z[0]) * tanhf(z[2]);
      const float h_new =
          layer::round_to(layer::sigmoid(z[3]) * tanhf(c_new), h_seq);
      c = layer::round_to(c_new, h_seq);
      if (row < d.B) {
        layer::store(h_seq + (static_cast<size_t>(t) * d.B + row) * d.H + j,
                     h_new);
      }
      if (t + 1 < d.T) {
        layer::publish_h(d, nxt, (at.r0 + at.ks) * L.kw + L.i4 + j, h_new);
      }
    }
    LAYER_STAMP(10 + 4 * t);
    if (t + 1 < d.T) {
      next_x.put(d, nxt, L.kw);
      layer::step_barrier(d);
      LAYER_STAMP(11 + 4 * t);
    }
  }
  if (at.finishes && row < d.B) {
    layer::store(c_out + static_cast<size_t>(row) * d.H + j, c);
  }
}

template <typename T, int RPT, int KS>
int launch_plan(const void* x_seq, const void* h0, const void* c0,
                const void* wx, const void* wh, const void* b, void* h_seq,
                void* c_out, const layer::Dims& d, void* stream) {
  static std::atomic<int> smem_opted_in{48 * 1024};
  const layer::Layout<T, kGates> L(d);
  if (layer::bad_dims(d, RPT, KS, L.hc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return layer::launch(
      lstm_layer_kernel<T, RPT, KS>, &smem_opted_in, L.bytes, d,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(x_seq),
      static_cast<const T*>(h0), static_cast<const T*>(c0),
      static_cast<const T*>(wx), static_cast<const T*>(wh),
      static_cast<const T*>(b), static_cast<T*>(h_seq), static_cast<T*>(c_out),
      d);
}

template <typename T>
int launch(const void* x_seq, const void* h0, const void* c0, const void* wx,
           const void* wh, const void* b, void* h_seq, void* c_out, int T_,
           int B, int I, int H, int cluster, int rows, int rows_per_thread,
           int k_split, int threads, void* stream) {
  const layer::Dims d{T_, B, I, H, cluster, rows, threads};
  return layer::dispatch(rows_per_thread, k_split, [&](auto rpt, auto ks) {
    return launch_plan<T, decltype(rpt)::value, decltype(ks)::value>(
        x_seq, h0, c0, wx, wh, b, h_seq, c_out, d, stream);
  });
}

}  // namespace

extern "C" {

// x_seq (T, B, I), h0 and c0 (B, H), wx (I, 4H), wh (H, 4H), b (4H) in;
// h_seq (T, B, H) and c_out (B, H) out; then the sizes and the launch plan
// of kernels/_cuda.py::cell_plan
int repro_lstm_cell_f32(const void* x_seq, const void* h0, const void* c0,
                        const void* wx, const void* wh, const void* b,
                        void* h_seq, void* c_out, int T, int B, int I, int H,
                        int cluster, int rows, int rows_per_thread,
                        int k_split, int threads, void* stream) {
  return launch<float>(x_seq, h0, c0, wx, wh, b, h_seq, c_out, T, B, I, H,
                       cluster, rows, rows_per_thread, k_split, threads,
                       stream);
}

int repro_lstm_cell_bf16(const void* x_seq, const void* h0, const void* c0,
                         const void* wx, const void* wh, const void* b,
                         void* h_seq, void* c_out, int T, int B, int I, int H,
                         int cluster, int rows, int rows_per_thread,
                         int k_split, int threads, void* stream) {
  return launch<__nv_bfloat16>(x_seq, h0, c0, wx, wh, b, h_seq, c_out, T, B,
                               I, H, cluster, rows, rows_per_thread, k_split,
                               threads, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
