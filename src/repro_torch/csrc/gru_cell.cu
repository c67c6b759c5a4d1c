// GRU layer for Hopper (sm_90a): the fused GRU cell scanned over a whole
// time-major sequence in one launch, writing every step's h.
//
// Replaces the TPU kernel src/repro/kernels/gru_cell.py::_gru_kernel
// (wrapper gru_cell), which the JAX package reaches through
// kernels/ops.py::gru_cell_fused, one step per call, and scans over the
// look-back with lax.scan (src/repro/models/forecaster.py:94-119).  Same
// function at each step: zx = x.Wx + b and zh = h.Wh with fp32
// accumulation and gates [z|r|h~] along the columns of wx (I, 3H) and
// wh (H, 3H), no hidden bias; z = sig(zx_z + zh_z), r = sig(zx_r + zh_r),
// h~ = tanh(zx_h + r * zh_h), h' = z h + (1 - z) h~.  h' is rounded to the
// input dtype after every step, as the step's output is, so the layer is
// the scan of the step.  At T = 1 it is the step.
//
// What bounds it on an H100: at the serving shape (T=8, B=256, H=64,
// fp32) the first layer (I=1) does 51 MFLOP, about 0.76 us at 67 TFLOP/s,
// the second (I=64) 101 MFLOP, about 1.5 us; their bytes take 0.1-0.2 us of
// HBM time.  The steps are serial, so a launch costs T times the latency
// of one step on one SM; as in csrc/lstm_cell.cu the weights come on chip
// once per launch, h stays in shared memory between steps and the next x
// is loaded while a step computes.
//
// Design: as csrc/lstm_cell.cu (see csrc/recurrent_layer.cuh for the
// layout, the weight copy and the cluster).  The x part and the h part of
// each gate are summed apart, since the reset gate scales only the h part
// of the candidate: six fp32 sums per row, in registers.
#include "recurrent_layer.cuh"

namespace {

constexpr int kGates = 3;

template <typename T, int RPT, int KS>
__global__ void __launch_bounds__(layer::kMaxThreads, 1)
    gru_layer_kernel(const T* __restrict__ x_seq, const T* __restrict__ h0,
                     const T* __restrict__ wx, const T* __restrict__ wh,
                     const T* __restrict__ b, T* __restrict__ h_seq,
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

  layer::NextX<T> next_x;
  for (int t = 0; t < d.T; ++t) {
    const float* cur = rowbuf + (t & 1) * d.rows * L.kw;
    float* nxt = rowbuf + ((t + 1) & 1) * d.rows * L.kw;
    next_x.load_step(d, x_seq, t + 1, row0);
    LAYER_STAMP(8 + 4 * t);
    float ax[kGates][RPT], ah[kGates][RPT];
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      // the bias enters once, in lane 0's share
      const float bg =
          at.ks == 0 ? layer::load(bias + g * L.hc + at.jl) : 0.0f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        ax[g][r] = bg;
        ah[g][r] = 0.0f;
      }
    }
    const float* rows = cur + at.r_read * L.kw;
    layer::accumulate<T, kGates, RPT, KS>(rows, L.kw, W + at.jl, L.hc, L.ws,
                                          0, L.i4, at.ks, ax);
    layer::accumulate<T, kGates, RPT, KS>(rows, L.kw, W + at.jl, L.hc, L.ws,
                                          L.i4, L.kw, at.ks, ah);
    layer::reduce_lanes<kGates, RPT, KS>(ax);
    layer::reduce_lanes<kGates, RPT, KS>(ah);
    LAYER_STAMP(9 + 4 * t);
    if (at.finishes) {
      float zx[kGates], zh[kGates];
      layer::pick(ax, at.ks, zx);
      layer::pick(ah, at.ks, zh);
      const float z = layer::sigmoid(zx[0] + zh[0]);
      const float rg = layer::sigmoid(zx[1] + zh[1]);
      const float h_tilde = tanhf(zx[2] + rg * zh[2]);
      const float h_prev = cur[(at.r0 + at.ks) * L.kw + L.i4 + j];
      const float h_new =
          layer::round_to(z * h_prev + (1.0f - z) * h_tilde, h_seq);
      const int row = row0 + at.r0 + at.ks;
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
}

template <typename T, int RPT, int KS>
int launch_plan(const void* x_seq, const void* h0, const void* wx,
                const void* wh, const void* b, void* h_seq,
                const layer::Dims& d, void* stream) {
  static std::atomic<int> smem_opted_in{48 * 1024};
  const layer::Layout<T, kGates> L(d);
  if (layer::bad_dims(d, RPT, KS, L.hc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return layer::launch(
      gru_layer_kernel<T, RPT, KS>, &smem_opted_in, L.bytes, d,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(x_seq),
      static_cast<const T*>(h0), static_cast<const T*>(wx),
      static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<T*>(h_seq), d);
}

template <typename T>
int launch(const void* x_seq, const void* h0, const void* wx, const void* wh,
           const void* b, void* h_seq, int T_, int B, int I, int H,
           int cluster, int rows, int rows_per_thread, int k_split,
           int threads, void* stream) {
  const layer::Dims d{T_, B, I, H, cluster, rows, threads};
  return layer::dispatch(rows_per_thread, k_split, [&](auto rpt, auto ks) {
    return launch_plan<T, decltype(rpt)::value, decltype(ks)::value>(
        x_seq, h0, wx, wh, b, h_seq, d, stream);
  });
}

}  // namespace

extern "C" {

// x_seq (T, B, I), h0 (B, H), wx (I, 3H), wh (H, 3H), b (3H) in; h_seq
// (T, B, H) out; then the sizes and the launch plan of
// kernels/_cuda.py::cell_plan
int repro_gru_cell_f32(const void* x_seq, const void* h0, const void* wx,
                       const void* wh, const void* b, void* h_seq, int T,
                       int B, int I, int H, int cluster, int rows,
                       int rows_per_thread, int k_split, int threads,
                       void* stream) {
  return launch<float>(x_seq, h0, wx, wh, b, h_seq, T, B, I, H, cluster, rows,
                       rows_per_thread, k_split, threads, stream);
}

int repro_gru_cell_bf16(const void* x_seq, const void* h0, const void* wx,
                        const void* wh, const void* b, void* h_seq, int T,
                        int B, int I, int H, int cluster, int rows,
                        int rows_per_thread, int k_split, int threads,
                        void* stream) {
  return launch<__nv_bfloat16>(x_seq, h0, wx, wh, b, h_seq, T, B, I, H,
                               cluster, rows, rows_per_thread, k_split,
                               threads, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
