// Backward of the LSTM layer for Hopper (sm_90a): the vector-Jacobian
// product of csrc/lstm_cell.cu's layer (the fused cell scanned over a
// time-major sequence) in one launch, for M clients, by back-propagation
// through time.
//
// Replaces no TPU kernel: the JAX package's custom_vjp cell takes the VJP
// of its plain oracle (src/repro/kernels/ops.py), which XLA fuses; here
// that VJP, recomputed and differentiated op by op under autograd, cost a
// few hundred launches a local step.  The function is that VJP: for the
// gate sums z = x.Wx + h.Wh + b of each step, i, f, o = sig(z_i, z_f,
// z_o), g = tanh(z_g), c' = f c + i g, h' = o tanh(c'):
//   dc  = dc' + dh' o (1 - tanh(c')^2)
//   dz_o = dh' tanh(c') o (1 - o)      dz_i = dc g i (1 - i)
//   dz_g = dc i (1 - g^2)              dz_f = dc c f (1 - f)
//   dh  = dz Wh^T,  dc_carry = dc f,   dx = dz Wx^T
//   dWx += x^T dz,  dWh += h^T dz,     db += sum over rows of dz
// with dh' the output's cotangent of the step plus the carry.  fp32 sums;
// in bf16 the inputs' values are read into fp32 and each gradient is
// rounded once to bf16.  The rounding of h and c to the input dtype that
// the forward applies after each step is passed through as the identity.
//
// What bounds it on an H100: at the training shape (M=100, T=8, B=64, I=1,
// H=64, fp32) the recompute, dh and the weight gradients are three times
// the layer's multiply-adds, 3 x 2 T B (I+H) 4H per client: 5.1 GFLOP,
// 76 us at 67 TFLOP/s; its bytes (the inputs, h_seq, the cotangents and
// the gradients once) take about 20 us of HBM time.  The steps are
// serial within a client, so what a launch costs is one client's walk on
// one SM.  Design (csrc/recurrent_bptt.cuh): one block per client, the
// weights and their gradients in shared memory, each step's three
// products as block-wide tiles of 4 x 4 in fp32 registers; the forward
// sweep that recomputes c adds a fourth product of three gates.  The
// entry points launch on the calling thread's current device, which the
// Python wrapper sets; they never change it.
#include "recurrent_bptt.cuh"

namespace {

struct Lstm {
  static constexpr int kGates = 4;
  // every sum over all of K (x, h and the bias), from its own W group
  __device__ static void sum_source(int g, int, int ka, int& wg, int& k0,
                                    int& k1) {
    wg = g, k0 = 0, k1 = ka;
  }
  __device__ static int dz_group(int wg, bool) { return wg; }
};

template <typename T, bool kSmem>
__global__ void __launch_bounds__(bptt::kMaxThreads, 1)
    lstm_bptt_kernel(const T* __restrict__ x_seq, const T* __restrict__ h0,
                     const T* __restrict__ c0, const T* __restrict__ wx,
                     const T* __restrict__ wh, const T* __restrict__ b,
                     const T* __restrict__ h_seq, const T* __restrict__ g_h,
                     const T* __restrict__ g_c, T* dx, T* dh0, T* dc0, T* dwx,
                     T* dwh, T* db, unsigned char* work, bptt::Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = Lstm::kGates;
  const bptt::Layout<T> L(d, G, true, kSmem);
  const int T_ = d.T, B = d.B, I = d.I, H = d.H, rows = d.rows;
  // this block's client: its slice of every array
  const size_t m = blockIdx.x;
  const size_t seq_in = m * T_ * B * I, seq_out = m * T_ * B * H;
  const size_t state = m * B * H, gh = static_cast<size_t>(G) * H;
  x_seq += seq_in;
  h0 += state;
  c0 += state;
  wx += m * I * gh;
  wh += m * H * gh;
  b += m * gh;
  h_seq += seq_out;
  g_h += seq_out;
  g_c += state;
  if (dx != nullptr) dx += seq_in;
  if (dh0 != nullptr) dh0 += state;
  if (dc0 != nullptr) dc0 += state;
  if (dwx != nullptr) dwx += m * I * gh;
  if (dwh != nullptr) dwh += m * H * gh;
  if (db != nullptr) db += m * gh;
  unsigned char* wk = work + m * L.work;
  T* W = reinterpret_cast<T*>(kSmem ? smem + L.w_off : wk + L.ww_off);
  float* dw =
      reinterpret_cast<float*>(kSmem ? smem + L.dw_off : wk + L.wdw_off);
  float* at = reinterpret_cast<float*>(smem + L.a_off);
  float* sz = reinterpret_cast<float*>(smem + L.z_off);
  float* dh = reinterpret_cast<float*>(smem + L.dh_off);
  float* cs = reinterpret_cast<float*>(smem + L.cs_off);
  float* c_of = reinterpret_cast<float*>(wk + L.wc_off);  // [T][rows][h4]
  const bool want_w = dwx != nullptr || dwh != nullptr || db != nullptr;

  bptt::stage_weights(L, G, W, wx, wh, b, I, H);
  if (want_w) {
    const size_t n = static_cast<size_t>(L.ka) * L.gw;
    for (size_t e = threadIdx.x; e < n; e += blockDim.x) dw[e] = 0.0f;
  }
  const int n_el = rows * L.h4;  // the elementwise passes: e -> (r, j)
  for (int row0 = 0; row0 < B; row0 += rows) {
    const int nr = min(rows, B - row0);
    bptt::begin_chunk(L.ka, L.as, at, nr);
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
      const int r = e / L.h4, j = e - r * L.h4;
      cs[e] = r < nr && j < H
                  ? layer::load(c0 + static_cast<size_t>(row0 + r) * H + j)
                  : 0.0f;
    }
    __syncthreads();
    // the forward sweep: c_t of every step, from the gates i, f, g
    for (int t = 0; t < T_; ++t) {
      bptt::stage_rows(L, at, x_seq + static_cast<size_t>(t) * B * I,
                       t > 0 ? h_seq + static_cast<size_t>(t - 1) * B * H
                             : h0,
                       I, H, row0, nr);
      __syncthreads();
      bptt::gate_sums<Lstm>(L, rows, at, W, sz, 3);
      __syncthreads();
      for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
        const int r = e / L.h4, j = e - r * L.h4;
        const float* z = sz + r * L.zs + j;
        const float c = layer::round_to(
            layer::sigmoid(z[L.h4]) * cs[e] +
                layer::sigmoid(z[0]) * tanhf(z[2 * L.h4]),
            h0);
        cs[e] = c;
        c_of[static_cast<size_t>(t) * n_el + e] = c;
      }
    }
    // the carried gradients start from the cotangent of c_T and zero
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
      const int r = e / L.h4, j = e - r * L.h4;
      cs[e] = r < nr && j < H
                  ? layer::load(g_c + static_cast<size_t>(row0 + r) * H + j)
                  : 0.0f;
      dh[e] = 0.0f;
    }
    for (int t = T_ - 1; t >= 0; --t) {
      bptt::stage_rows(L, at, x_seq + static_cast<size_t>(t) * B * I,
                       t > 0 ? h_seq + static_cast<size_t>(t - 1) * B * H
                             : h0,
                       I, H, row0, nr);
      __syncthreads();
      bptt::gate_sums<Lstm>(L, rows, at, W, sz, 4);
      __syncthreads();
      for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
        const int r = e / L.h4, j = e - r * L.h4;
        float* z = sz + r * L.zs + j;
        const float dh_in = dh[e];
        dh[e] = 0.0f;  // the products add dz Wh^T to it
        if (r >= nr || j >= H) {
          z[0] = z[L.h4] = z[2 * L.h4] = z[3 * L.h4] = 0.0f;
          continue;
        }
        const int row = row0 + r;
        const float dh_t =
            dh_in +
            layer::load(g_h + (static_cast<size_t>(t) * B + row) * H + j);
        const float i = layer::sigmoid(z[0]);
        const float f = layer::sigmoid(z[L.h4]);
        const float g = tanhf(z[2 * L.h4]);
        const float o = layer::sigmoid(z[3 * L.h4]);
        const float c = c_of[static_cast<size_t>(t) * n_el + e];
        const float c_prev =
            t > 0 ? c_of[static_cast<size_t>(t - 1) * n_el + e]
                  : layer::load(c0 + static_cast<size_t>(row) * H + j);
        const float tc = tanhf(c);
        const float dc = cs[e] + dh_t * o * (1.0f - tc * tc);
        z[0] = dc * g * i * (1.0f - i);
        z[L.h4] = dc * c_prev * f * (1.0f - f);
        z[2 * L.h4] = dc * i * (1.0f - g * g);
        z[3 * L.h4] = dh_t * tc * o * (1.0f - o);
        cs[e] = dc * f;
      }
      __syncthreads();
      bptt::back_products<Lstm>(
          L, rows, sz, W, dh,
          dx != nullptr ? dx + static_cast<size_t>(t) * B * I : nullptr, I,
          row0, nr);
      if (want_w) {
        bptt::weight_grads<Lstm>(L, layer::round_up(nr, 4), at, sz, dw,
                                 db != nullptr, dwx != nullptr,
                                 dwh != nullptr);
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
      const int r = e / L.h4, j = e - r * L.h4;
      if (r >= nr || j >= H) continue;
      const size_t at_out = static_cast<size_t>(row0 + r) * H + j;
      if (dh0 != nullptr) layer::store(dh0 + at_out, dh[e]);
      if (dc0 != nullptr) layer::store(dc0 + at_out, cs[e]);
    }
  }
  if (want_w) {
    __syncthreads();
    bptt::write_weight_grads(L, G, dw, dwx, dwh, db, I, H);
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, void* work,
           const bptt::Dims& d, int in_smem, void* stream) {
  if (bptt::bad_dims(d)) return static_cast<int>(cudaErrorInvalidValue);
  return bptt::dispatch(in_smem, [&](auto placement) {
    constexpr bool S = decltype(placement)::value;
    static std::atomic<int> smem_opted_in{48 * 1024};
    const bptt::Layout<T> L(d, Lstm::kGates, true, S);
    const auto p = [&](int i) { return static_cast<const T*>(in[i]); };
    const auto q = [&](int i) { return static_cast<T*>(out[i]); };
    return bptt::launch(lstm_bptt_kernel<T, S>, &smem_opted_in, L.smem,
                        d, static_cast<cudaStream_t>(stream), p(0), p(1),
                        p(2), p(3), p(4), p(5), p(6), p(7), p(8), q(0), q(1),
                        q(2), q(3), q(4), q(5),
                        static_cast<unsigned char*>(work), d);
  });
}

template <typename T>
int entry(const void* x_seq, const void* h0, const void* c0, const void* wx,
          const void* wh, const void* b, const void* h_seq, const void* g_h,
          const void* g_c, void* dx, void* dh0, void* dc0, void* dwx,
          void* dwh, void* db, void* work, int M, int T_, int B, int I, int H,
          int rows, int threads, int in_smem, void* stream) {
  const void* in[] = {x_seq, h0, c0, wx, wh, b, h_seq, g_h, g_c};
  void* out[] = {dx, dh0, dc0, dwx, dwh, db};
  return launch<T>(in, out, work, bptt::Dims{M, T_, B, I, H, rows, threads},
                   in_smem, stream);
}

}  // namespace

extern "C" {

// For M clients, each with its own weights: the forward's inputs x_seq
// (M, T, B, I), h0 and c0 (M, B, H), wx (M, I, 4H), wh (M, H, 4H), b
// (M, 4H), its output h_seq (M, T, B, H) and the cotangents of h_seq and
// c_T in; the gradients of the six inputs out, each null where it is not
// wanted; the workspace of kernels/_cuda.py::bptt_plan (M blocks' slices);
// then the sizes and the plan
int repro_lstm_bptt_f32(const void* x_seq, const void* h0, const void* c0,
                        const void* wx, const void* wh, const void* b,
                        const void* h_seq, const void* g_h, const void* g_c,
                        void* dx, void* dh0, void* dc0, void* dwx, void* dwh,
                        void* db, void* work, int M, int T, int B, int I,
                        int H, int rows, int threads, int in_smem,
                        void* stream) {
  return entry<float>(x_seq, h0, c0, wx, wh, b, h_seq, g_h, g_c, dx, dh0, dc0,
                      dwx, dwh, db, work, M, T, B, I, H, rows, threads,
                      in_smem, stream);
}

int repro_lstm_bptt_bf16(const void* x_seq, const void* h0, const void* c0,
                         const void* wx, const void* wh, const void* b,
                         const void* h_seq, const void* g_h, const void* g_c,
                         void* dx, void* dh0, void* dc0, void* dwx, void* dwh,
                         void* db, void* work, int M, int T, int B, int I,
                         int H, int rows, int threads, int in_smem,
                         void* stream) {
  return entry<__nv_bfloat16>(x_seq, h0, c0, wx, wh, b, h_seq, g_h, g_c, dx,
                              dh0, dc0, dwx, dwh, db, work, M, T, B, I, H,
                              rows, threads, in_smem, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
