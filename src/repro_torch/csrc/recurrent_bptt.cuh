// What the recurrent-layer backward kernels csrc/lstm_bptt.cu and
// csrc/gru_bptt.cu share: the layout of a block's shared memory and of its
// slice of the workspace, the staging of the weights, and the three block-
// wide products of a step of back-propagation through time (BPTT).
//
// A BPTT kernel computes, in one launch, the vector-Jacobian product of a
// whole recurrent layer (csrc/{lstm,gru}_cell.cu) for M clients: one block
// per client (blockIdx.x), which walks that client's batch rows in chunks
// of `rows` and, for each chunk, the steps t = T-1 ... 0.  The rows of a
// batch are independent in the recurrence, and a block owns all of its
// client's rows, so the weight gradients are summed by one block in a fixed
// order (chunks, then steps, then rows): no atomics, and the same bits on
// every run.  Each step's gates are recomputed from [x_t | h_{t-1}], with
// h_{t-1} read from the forward's saved output; the LSTM's c_t, which the
// forward does not write, comes from one forward sweep over the chunk that
// recomputes the gates it needs and keeps each c_t in the workspace.
//
// Every operand lives in one "K" layout of 4 + i4 + h4 rows (i4, h4 = I, H
// rounded up to 4): row 0 the bias (its input a constant 1), rows 1-3 zero,
// then the x rows, then the h rows, so that the bias gradient is the weight
// gradient of row 0 and no tile of 4 rows straddles x and h:
//   W[ka][ws]        the weights in the input dtype, columns [G][h4], zero
//                    past I, H and in the padding
//   at[ka][as]       fp32, [1 | x_t | h_{t-1}] of the chunk's rows, by column
//                    (transposed), zero past the valid rows
//   sz[rows][zs]     fp32, the step's gate sums [4][h4] and then, in place,
//                    their gradients dz; four groups for both cells: LSTM
//                    [i|f|g|o], GRU [z|r|n_x|n_h] (the candidate's x part
//                    with the bias and its h part apart, since the reset
//                    gate scales only the h part)
//   dh[rows][h4]     fp32, the gradient carried into h_{t-1}
//   cs[rows][h4]     fp32, the LSTM's c in the sweep, then its carried dc
//   dw[ka][G*h4]     fp32, the weight gradients
// W and dw sit in shared memory where all of it fits (the training shapes
// of both cells), else both in the block's slice of a workspace in global
// memory, allocated by the wrapper, which also keeps the LSTM's c_t of
// every step.  kernels/_cuda.py::bptt_layout computes the same sizes.
#pragma once

#include "recurrent_layer.cuh"

namespace bptt {

constexpr int kSmemLimit = layer::kSmemLimit;
constexpr int kMaxThreads = 512;
constexpr int kMaxClients = layer::kMaxClients;
constexpr int kSplit = 4;  // lanes sharing the sums of one tile of dh / dx

using layer::load;
using layer::round_up;
using layer::store;

// the sizes of a launch, the same on the host and in every block
struct Dims {
  int M, T, B, I, H;
  int rows;     // batch rows of a chunk, a multiple of 4
  int threads;  // per block
};

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

template <typename T>
struct Layout {
  int i4, h4, kx, ka;  // x rows start at 4, h rows at kx; ka rows in all
  int gw, ws;          // W's columns G * h4, and its row stride: ws * sizeof
                       // (T) = 16 (mod 128) bytes, so that the rows of a
                       // tile that lanes read at one column fall on
                       // distinct banks
  int as, zs;          // row strides of at and sz
  size_t w_off, a_off, z_off, dh_off, cs_off, dw_off, smem;   // shared
  size_t ww_off, wdw_off, wc_off, work;  // the block's workspace

  // in_smem: W and dw in shared memory, else in the workspace
  __host__ __device__ Layout(const Dims& d, int G, bool lstm, bool in_smem) {
    constexpr int sz = static_cast<int>(sizeof(T));
    i4 = round_up(d.I, 4);
    h4 = round_up(d.H, 4);
    kx = 4 + i4;
    ka = kx + h4;
    gw = G * h4;
    const int period = 128 / sz;
    ws = gw + ((4 - gw) % period + period) % period;
    as = d.rows + 4;
    zs = 4 * h4 + 4;
    const size_t w_bytes = align16(static_cast<size_t>(ka) * ws * sz);
    const size_t dw_bytes = static_cast<size_t>(ka) * gw * 4;
    const size_t rh = static_cast<size_t>(d.rows) * h4 * 4;
    size_t at = 0;
    w_off = at;
    at += in_smem ? w_bytes : 0;
    a_off = at;
    at += static_cast<size_t>(ka) * as * 4;
    z_off = at;
    at += static_cast<size_t>(d.rows) * zs * 4;
    dh_off = at;
    at += rh;
    cs_off = at;
    at += lstm ? rh : 0;
    dw_off = at;
    at += in_smem ? dw_bytes : 0;
    smem = at;
    size_t wk = 0;
    ww_off = wk;
    wk += in_smem ? 0 : w_bytes;
    wdw_off = wk;
    wk += in_smem ? 0 : dw_bytes;
    wc_off = wk;
    wk += lstm ? static_cast<size_t>(d.T) * rh : 0;
    work = wk;
  }
};

// four consecutive elements of a row, as fp32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// W in the K layout: row 0 the bias, the x rows from wx (I, G*H), the h
// rows from wh (H, G*H), zero elsewhere.  Every element is written, so the
// copy needs no zeroing first.
template <typename T>
__device__ void stage_weights(const Layout<T>& L, int G, T* W, const T* wx,
                              const T* wh, const T* b, int I, int H) {
  const size_t n = static_cast<size_t>(L.ka) * L.ws;
  const int gh = G * H;
  for (size_t e = threadIdx.x; e < n; e += blockDim.x) {
    const int k = static_cast<int>(e / L.ws);
    const int c = static_cast<int>(e - static_cast<size_t>(k) * L.ws);
    const int g = c / L.h4, j = c - g * L.h4;
    float v = 0.0f;
    if (c < L.gw && j < H) {
      const int col = g * H + j;
      if (k == 0) {
        v = load(b + col);
      } else if (k >= 4 && k < 4 + I) {
        v = load(wx + static_cast<size_t>(k - 4) * gh + col);
      } else if (k >= L.kx && k < L.kx + H) {
        v = load(wh + static_cast<size_t>(k - L.kx) * gh + col);
      }
    }
    store(W + e, v);
  }
}

// at for a new chunk of nr valid rows: the bias row 1 on them, the rest 0
__device__ __forceinline__ void begin_chunk(int ka, int as, float* at,
                                           int nr) {
  const int n = ka * as;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    at[e] = e < as && e < nr ? 1.0f : 0.0f;
  }
}

// x_t and h_{t-1} of the chunk's valid rows into at (by column), read
// along each row so that neighbouring threads read neighbouring addresses
template <typename T>
__device__ void stage_rows(const Layout<T>& L, float* at, const T* x_t,
                           const T* h_prev, int I, int H, int row0, int nr) {
  for (int e = threadIdx.x; e < nr * I; e += blockDim.x) {
    const int r = e / I, i = e - r * I;
    at[(4 + i) * L.as + r] =
        load(x_t + static_cast<size_t>(row0 + r) * I + i);
  }
  for (int e = threadIdx.x; e < nr * H; e += blockDim.x) {
    const int r = e / H, j = e - r * H;
    at[(L.kx + j) * L.as + r] =
        load(h_prev + static_cast<size_t>(row0 + r) * H + j);
  }
}

// The gate sums of groups [0, groups) of sz: sz[r][g*h4 + j] = sum over
// k in [k0, k1) of at[k][r] * W[k][wg*h4 + j], with (wg, k0, k1) =
// Cell::sum_source(g): the sums the forward kernel takes, bias included.
// A thread takes a tile of 4 rows x 4 columns; neighbouring threads take
// neighbouring columns of the same rows, so their at reads are one
// broadcast and their W reads one contiguous run.
template <typename Cell, typename T>
__device__ void gate_sums(const Layout<T>& L, int rows, const float* at,
                          const T* W, float* sz, int groups) {
  const int n_ct = groups * L.h4 / 4;
  const int n_tiles = rows / 4 * n_ct;
  for (int tile = threadIdx.x; tile < n_tiles; tile += blockDim.x) {
    const int rt = tile / n_ct, c = (tile - rt * n_ct) * 4;
    const int g = c / L.h4, j = c - g * L.h4;
    int wg, k0, k1;
    Cell::sum_source(g, L.kx, L.ka, wg, k0, k1);
    const float* ap = at + rt * 4;
    const T* wp = W + wg * L.h4 + j;
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float a[4], w[4];
      load4(ap + k * L.as, a);
      load4(wp + static_cast<size_t>(k) * L.ws, w);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], w[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(sz + (rt * 4 + r) * L.zs + c) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// The products of dz with the weights: dh[r][j] += sum over the columns of
// dz[r][.] * W[kx + j][.] (dh holds the cell's direct term already) and,
// where dx_t is given, dx_t[row][i] = sum of dz[r][.] * W[4 + i][.], the
// dz group of each W group from Cell::dz_group.  A tile is 4 rows x 4 K
// rows; kSplit neighbouring lanes share it, lane q taking the column
// chunks q, q + kSplit, ..., and add their sums by shuffles (a fixed
// order).  The loop's trip count is the same in every thread, so every
// lane of a warp reaches the shuffles.
template <typename Cell, typename T>
__device__ void back_products(const Layout<T>& L, int rows, const float* sz,
                              const T* W, float* dh, T* dx_t, int I,
                              int row0, int nr) {
  const int nxt = dx_t != nullptr ? L.i4 / 4 : 0;
  const int nkt = nxt + L.h4 / 4;
  const int n_items = rows / 4 * nkt;
  const int q = threadIdx.x % kSplit, per = blockDim.x / kSplit;
  for (int base = 0; base < n_items; base += per) {
    const int item = base + static_cast<int>(threadIdx.x) / kSplit;
    const bool active = item < n_items;
    const int it = active ? item : 0;
    const int rt = it / nkt, kt = it - rt * nkt;
    const bool hpart = kt >= nxt;
    const int k = hpart ? L.kx + 4 * (kt - nxt) : 4 + 4 * kt;
    const float* zp = sz + rt * 4 * L.zs;
    float acc[4][4] = {};
#pragma unroll 1
    for (int wg = 0; wg < Cell::kGates; ++wg) {
      const int dz0 = Cell::dz_group(wg, hpart) * L.h4;
      const T* wp = W + static_cast<size_t>(k) * L.ws + wg * L.h4;
#pragma unroll 2
      for (int j = 4 * q; j < L.h4; j += 4 * kSplit) {
        float z[4][4], w[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) load4(zp + r * L.zs + dz0 + j, z[r]);
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(wp + i * L.ws + j, w[i]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[r][i] = fmaf(z[r][e], w[i][e], acc[r][i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = kSplit / 2; off > 0; off /= 2) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        }
      }
    }
    // lane q writes row q of the tile
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = acc[0][i];
#pragma unroll
      for (int r = 1; r < 4; ++r) v[i] = q == r ? acc[r][i] : v[i];
    }
    const int r = rt * 4 + q;
    if (active && hpart) {
      float* p = dh + r * L.h4 + (k - L.kx);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] += v[i];
    } else if (active && r < nr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k - 4 + i;
        if (col < I) {
          store(dx_t + static_cast<size_t>(row0 + r) * I + col, v[i]);
        }
      }
    }
  }
}

// The weight gradients of the step, added to dw: dw[k][c] += sum over the
// chunk's rows of at[k][r] * dz[r][Cell::dz_group(c's gate, k in h) ...].
// A thread owns a tile of 4 K rows x 4 columns for the whole step, so each
// element is summed by one thread in row order.  Tiles of a part whose
// gradient is not wanted (bias, x rows, h rows) are skipped.
template <typename Cell, typename T>
__device__ void weight_grads(const Layout<T>& L, int nr4, const float* at,
                             const float* sz, float* dw, bool want_b,
                             bool want_x, bool want_h) {
  const int n_ct = L.gw / 4;
  const int n_tiles = L.ka / 4 * n_ct;
  for (int tile = threadIdx.x; tile < n_tiles; tile += blockDim.x) {
    const int kt = tile / n_ct, c = (tile - kt * n_ct) * 4;
    const int k = kt * 4;
    const bool hpart = k >= L.kx;
    if (!(k == 0 ? want_b : hpart ? want_h : k >= 4 && want_x)) continue;
    const int wg = c / L.h4;
    const int dzc = Cell::dz_group(wg, hpart) * L.h4 + (c - wg * L.h4);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load4(dw + static_cast<size_t>(k + i) * L.gw + c, acc[i]);
    }
    for (int r = 0; r < nr4; r += 4) {
      float a[4][4], z[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(at + (k + i) * L.as + r, a[i]);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) load4(sz + (r + rr) * L.zs + dzc, z[rr]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][e] = fmaf(a[i][rr], z[rr][e], acc[i][e]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(dw + static_cast<size_t>(k + i) * L.gw + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// dw in the K layout out to the gradients of wx (I, G*H), wh (H, G*H) and
// b (G*H), each rounded once to the input dtype; null ones are skipped
template <typename T>
__device__ void write_weight_grads(const Layout<T>& L, int G, const float* dw,
                                   T* dwx, T* dwh, T* db, int I, int H) {
  const int gh = G * H;
  const int n = (I + H + 1) * gh;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k = e / gh, col = e - k * gh;
    const int g = col / H, j = col - g * H;
    const int c = g * L.h4 + j;
    if (k < I) {
      if (dwx != nullptr) {
        store(dwx + e, dw[static_cast<size_t>(4 + k) * L.gw + c]);
      }
    } else if (k < I + H) {
      if (dwh != nullptr) {
        store(dwh + static_cast<size_t>(k - I) * gh + col,
              dw[static_cast<size_t>(L.kx + k - I) * L.gw + c]);
      }
    } else if (db != nullptr) {
      store(db + col, dw[c]);
    }
  }
}

// Launch kernel on stream, one block of d.threads per client, with the
// dynamic shared memory of its layout (opted in above 48 KB).  Returns the
// launch's error code.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, std::atomic<int>* smem_opted_in, size_t smem,
           const Dims& d, cudaStream_t stream, Args... args) {
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int>(smem) > smem_opted_in->load()) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted_in->store(static_cast<int>(smem));
  }
  kernel<<<d.M, d.threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the sizes a kernel takes: the host plan (kernels/_cuda.py::bptt_plan)
// already checked them; a mismatch refuses the launch
inline bool bad_dims(const Dims& d) {
  return d.M < 1 || d.M > kMaxClients || d.T < 1 || d.B < 1 || d.I < 1 ||
         d.H < 1 || d.rows < 4 || d.rows % 4 != 0 || d.threads < 32 ||
         d.threads > kMaxThreads || d.threads % 32 != 0;
}

// f(in_smem) as a compile-time constant: the two placements of W and dw
// that kernels/_cuda.py::bptt_plan picks
template <typename F>
int dispatch(int in_smem, F&& f) {
  return in_smem ? f(std::true_type{}) : f(std::false_type{});
}

}  // namespace bptt
