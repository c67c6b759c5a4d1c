// Backward of the GRU layer for Hopper (sm_90a): the vector-Jacobian
// product of csrc/gru_cell.cu's layer in one launch, for M clients, by
// back-propagation through time.
//
// Replaces no TPU kernel, as csrc/lstm_bptt.cu: the JAX package takes the
// VJP of its plain oracle.  The function is that VJP: for the sums
// zx = x.Wx + b and zh = h.Wh of each step, z = sig(zx_z + zh_z),
// r = sig(zx_r + zh_r), n = tanh(zx_n + r zh_n), h' = z h + (1 - z) n:
//   dz_z = dh' (h - n) z (1 - z)      dn = dh' (1 - z) (1 - n^2)
//   dz_r = dn zh_n r (1 - r)
//   dzx = [dz_z | dz_r | dn],  dzh = [dz_z | dz_r | r dn]  (the reset gate
//   scales only the h part of the candidate)
//   dh  = dh' z + dzh Wh^T,   dx = dzx Wx^T
//   dWx += x^T dzx,  dWh += h^T dzh,  db += sum over rows of dzx
// fp32 sums; bf16 as in csrc/lstm_bptt.cu.  The rounding of h to the input
// dtype after each step is passed through as the identity.
//
// What bounds it on an H100: at the 1,000-client training shape (M=1000,
// T=8, B=64, I=1, H=64, fp32) three times the layer's multiply-adds,
// 3 x 2 T B (I+H) 3H per client: 38.3 GFLOP, 0.57 ms at 67 TFLOP/s; the
// bytes take about 0.1 ms.  Design as csrc/lstm_bptt.cu (see
// csrc/recurrent_bptt.cuh), with no forward sweep: every quantity of a step
// comes from its recomputed sums and h_{t-1}.
#include "recurrent_bptt.cuh"

namespace {

struct Gru {
  static constexpr int kGates = 3;
  // the sums [z | r | n_x | n_h]: z and r over all of K; the candidate's x
  // part (rows below kx: the bias and x) and its h part apart, both from
  // W's third group
  __device__ static void sum_source(int g, int kx, int ka, int& wg, int& k0,
                                    int& k1) {
    wg = g < 3 ? g : 2;
    k0 = g == 3 ? kx : 0;
    k1 = g == 2 ? kx : ka;
  }
  // dz of W's group wg: the candidate's h rows take r dn (group 3)
  __device__ static int dz_group(int wg, bool hpart) {
    return wg == 2 && hpart ? 3 : wg;
  }
};

template <typename T, bool kSmem>
__global__ void __launch_bounds__(bptt::kMaxThreads, 1)
    gru_bptt_kernel(const T* __restrict__ x_seq, const T* __restrict__ h0,
                    const T* __restrict__ wx, const T* __restrict__ wh,
                    const T* __restrict__ b, const T* __restrict__ h_seq,
                    const T* __restrict__ g_h, T* dx, T* dh0, T* dwx, T* dwh,
                    T* db, unsigned char* work, bptt::Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = Gru::kGates;
  const bptt::Layout<T> L(d, G, false, kSmem);
  const int T_ = d.T, B = d.B, I = d.I, H = d.H, rows = d.rows;
  // this block's client: its slice of every array
  const size_t m = blockIdx.x;
  const size_t seq_in = m * T_ * B * I, seq_out = m * T_ * B * H;
  const size_t state = m * B * H, gh = static_cast<size_t>(G) * H;
  x_seq += seq_in;
  h0 += state;
  wx += m * I * gh;
  wh += m * H * gh;
  b += m * gh;
  h_seq += seq_out;
  g_h += seq_out;
  if (dx != nullptr) dx += seq_in;
  if (dh0 != nullptr) dh0 += state;
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
  const bool want_w = dwx != nullptr || dwh != nullptr || db != nullptr;

  bptt::stage_weights(L, G, W, wx, wh, b, I, H);
  if (want_w) {
    const size_t n = static_cast<size_t>(L.ka) * L.gw;
    for (size_t e = threadIdx.x; e < n; e += blockDim.x) dw[e] = 0.0f;
  }
  const int n_el = rows * L.h4;  // the elementwise pass: e -> (r, j)
  for (int row0 = 0; row0 < B; row0 += rows) {
    const int nr = min(rows, B - row0);
    bptt::begin_chunk(L.ka, L.as, at, nr);
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) dh[e] = 0.0f;
    __syncthreads();
    for (int t = T_ - 1; t >= 0; --t) {
      bptt::stage_rows(L, at, x_seq + static_cast<size_t>(t) * B * I,
                       t > 0 ? h_seq + static_cast<size_t>(t - 1) * B * H
                             : h0,
                       I, H, row0, nr);
      __syncthreads();
      bptt::gate_sums<Gru>(L, rows, at, W, sz, 4);
      __syncthreads();
      for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
        const int r = e / L.h4, j = e - r * L.h4;
        float* s = sz + r * L.zs + j;
        const float dh_in = dh[e];
        dh[e] = 0.0f;
        if (r >= nr || j >= H) {
          s[0] = s[L.h4] = s[2 * L.h4] = s[3 * L.h4] = 0.0f;
          continue;
        }
        const float dh_t =
            dh_in +
            layer::load(g_h + (static_cast<size_t>(t) * B + row0 + r) * H + j);
        const float z = layer::sigmoid(s[0]);
        const float rg = layer::sigmoid(s[L.h4]);
        const float nh = s[3 * L.h4];
        const float n = tanhf(s[2 * L.h4] + rg * nh);
        const float h_prev = at[(L.kx + j) * L.as + r];
        const float dn = dh_t * (1.0f - z) * (1.0f - n * n);
        s[0] = dh_t * (h_prev - n) * z * (1.0f - z);
        s[L.h4] = dn * nh * rg * (1.0f - rg);
        s[2 * L.h4] = dn;
        s[3 * L.h4] = dn * rg;
        dh[e] = dh_t * z;  // the products add dzh Wh^T to it
      }
      __syncthreads();
      bptt::back_products<Gru>(
          L, rows, sz, W, dh,
          dx != nullptr ? dx + static_cast<size_t>(t) * B * I : nullptr, I,
          row0, nr);
      if (want_w) {
        bptt::weight_grads<Gru>(L, layer::round_up(nr, 4), at, sz, dw,
                                db != nullptr, dwx != nullptr,
                                dwh != nullptr);
      }
      __syncthreads();
    }
    if (dh0 != nullptr) {
      for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
        const int r = e / L.h4, j = e - r * L.h4;
        if (r < nr && j < H) {
          layer::store(dh0 + static_cast<size_t>(row0 + r) * H + j, dh[e]);
        }
      }
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
    const bptt::Layout<T> L(d, Gru::kGates, false, S);
    const auto p = [&](int i) { return static_cast<const T*>(in[i]); };
    const auto q = [&](int i) { return static_cast<T*>(out[i]); };
    return bptt::launch(gru_bptt_kernel<T, S>, &smem_opted_in, L.smem, d,
                        static_cast<cudaStream_t>(stream), p(0), p(1), p(2),
                        p(3), p(4), p(5), p(6), q(0), q(1), q(2), q(3), q(4),
                        static_cast<unsigned char*>(work), d);
  });
}

template <typename T>
int entry(const void* x_seq, const void* h0, const void* wx, const void* wh,
          const void* b, const void* h_seq, const void* g_h, void* dx,
          void* dh0, void* dwx, void* dwh, void* db, void* work, int M, int T_,
          int B, int I, int H, int rows, int threads, int in_smem,
          void* stream) {
  const void* in[] = {x_seq, h0, wx, wh, b, h_seq, g_h};
  void* out[] = {dx, dh0, dwx, dwh, db};
  return launch<T>(in, out, work, bptt::Dims{M, T_, B, I, H, rows, threads},
                   in_smem, stream);
}

}  // namespace

extern "C" {

// For M clients, each with its own weights: the forward's inputs x_seq
// (M, T, B, I), h0 (M, B, H), wx (M, I, 3H), wh (M, H, 3H), b (M, 3H), its
// output h_seq (M, T, B, H) and the cotangent of h_seq in; the gradients of
// the five inputs out, each null where it is not wanted; the workspace of
// kernels/_cuda.py::bptt_plan; then the sizes and the plan
int repro_gru_bptt_f32(const void* x_seq, const void* h0, const void* wx,
                       const void* wh, const void* b, const void* h_seq,
                       const void* g_h, void* dx, void* dh0, void* dwx,
                       void* dwh, void* db, void* work, int M, int T, int B,
                       int I, int H, int rows, int threads, int in_smem,
                       void* stream) {
  return entry<float>(x_seq, h0, wx, wh, b, h_seq, g_h, dx, dh0, dwx, dwh, db,
                      work, M, T, B, I, H, rows, threads, in_smem, stream);
}

int repro_gru_bptt_bf16(const void* x_seq, const void* h0, const void* wx,
                        const void* wh, const void* b, const void* h_seq,
                        const void* g_h, void* dx, void* dh0, void* dwx,
                        void* dwh, void* db, void* work, int M, int T, int B,
                        int I, int H, int rows, int threads, int in_smem,
                        void* stream) {
  return entry<__nv_bfloat16>(x_seq, h0, wx, wh, b, h_seq, g_h, dx, dh0, dwx,
                              dwh, db, work, M, T, B, I, H, rows, threads,
                              in_smem, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
