// What the recurrent-layer kernels csrc/lstm_cell.cu and csrc/gru_cell.cu
// share: the shared-memory layout of a block, the staging of the gate
// weights into it with the Hopper bulk copy, the rows of [x | h] between
// steps, and the launch, with a thread-block cluster where one block's
// shared memory cannot hold the weights.
//
// A layer kernel runs one recurrent layer over the whole look-back in one
// launch: the gate weights come on chip once, h stays in shared memory and
// c in registers between steps.  The grid is (row blocks, column blocks,
// clients): a block owns `rows` batch rows and `hc` hidden columns of every
// gate of one client.  Each client (blockIdx.z, M of them) has its own
// inputs, state and weights, laid out one after another (x_seq (M, T, B,
// I), wx (M, I, G*H), ...); a block offsets every pointer to its client's
// slice first (client_slice) and then works as if M were 1, staging its
// own client's weights.
// Where the weights of all H columns fit one block, the cluster is 1 and
// hc = H; otherwise `cluster` blocks (2, 4 or 8, one cluster) split the
// columns, and each publishes its slice of h' to the others through
// distributed shared memory, then waits at one cluster barrier a step.
//
// Shared memory of a block, in this order (offsets in bytes, each a
// multiple of 16):
//   the mbarrier of the weight copy          16
//   W[kw][ws] in the input dtype, a row       rows 0..I-1: wx, i4..i4+H-1: wh,
//     [G][hc] then padding                   the rest zero (kw = i4 + h4)
//   bias[G][hc] in the input dtype
//   rowbuf[2][rows][kw] as fp32              [x_t | h_t] per batch row,
//                                            zero past I and past H; double
//                                            buffered, so one barrier a step
// with i4, h4 = I, H rounded up to 4, so the k loop's chunks of 2 or 4 of
// x | h never straddle x and h.  kernels/_cuda.py::cell_smem_bytes computes
// the same size.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

// Cycle stamps of thread 0 of block (0, 0, 0) at the phases of a launch, read
// by tools/cell_layer_stamps.py; compiled in only with -DLAYER_STAMPS, so
// the built kernels carry none.  0 entry, 1 mbarrier ready, 2 copies
// issued, 3 padding zeroed, 4 row buffers filled, 5 weights landed,
// 6 prologue done; step t: 8 + 4t top, +1 sums, +2 epilogue, +3 barrier.
#ifdef LAYER_STAMPS
__device__ unsigned long long layer_stamps[64];
#define LAYER_STAMP(i)                                                 \
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&           \
      threadIdx.x == 0 && (i) < 64)                                      \
  layer_stamps[(i)] = clock64()
extern "C" int repro_layer_stamps(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, layer_stamps, sizeof(layer_stamps)));
}
#else
#define LAYER_STAMP(i)
#endif

namespace layer {

namespace cg = cooperative_groups;

constexpr int kSmemLimit = 232448;  // dynamic shared memory of one sm_90 block
constexpr int kXRegs = 4;           // x values a thread carries to the next step
constexpr int kMaxThreads = 512;    // per block: leaves 128 registers a thread
constexpr int kMaxClients = 65535;  // gridDim.z

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// v rounded to the input dtype, as a step's outputs are
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Offsets, in elements, of client blockIdx.z's slices of a layer's arrays
// (G gates): the sequences (T, B, I) in and (T, B, H) out, the state
// (B, H), wx (I, G*H), wh (H, G*H) and the bias (G*H).  size_t, since
// M * T * B * H passes 2^31 at training sizes.
struct ClientSlice {
  size_t seq_in, seq_out, state, wx, wh, bias;
};

// the sizes of a launch, the same on the host and in every block; T, B,
// I, H are one client's
struct Dims {
  int M;        // clients, each with its own weights (gridDim.z)
  int T, B, I, H;
  int cluster;  // blocks splitting the hidden columns
  int rows;     // batch rows per block
  int threads;  // threads per block
};

template <int G>
__device__ __forceinline__ ClientSlice client_slice(const Dims& d) {
  const size_t m = blockIdx.z;
  const size_t gh = static_cast<size_t>(G) * d.H;
  return {m * d.T * d.B * d.I, m * d.T * d.B * d.H, m * d.B * d.H,
          m * d.I * gh, m * d.H * gh, m * gh};
}

template <typename T, int G>
struct Layout {
  int hc, i4, kw;  // columns per block, x | h widths
  int ws;          // W's row stride in elements: at least G * hc, and
                   // ws * sizeof(T) = 16 (mod 64) bytes, so rows stay
                   // 16-byte aligned for the bulk copy and the k-split
                   // lanes of a column read distinct banks (accumulate)
  size_t w_off, b_off, rowbuf_off, bytes;  // byte offsets into shared memory

  __host__ __device__ explicit Layout(const Dims& d) {
    constexpr int sz = static_cast<int>(sizeof(T));
    hc = d.cluster == 1 ? d.H : round_up((d.H + d.cluster - 1) / d.cluster, 8);
    i4 = round_up(d.I, 4);
    kw = i4 + round_up(d.H, 4);
    ws = G * hc + (((16 - G * hc * sz) % 64 + 64) % 64) / sz;
    w_off = 16;
    b_off = w_off + static_cast<size_t>(kw) * ws * sz;
    rowbuf_off = b_off + round_up(G * hc * sz, 16);
    bytes = rowbuf_off + sizeof(float) * 2 * d.rows * kw;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy n elements from global src to shared dst: the 16-byte multiple that
// the bulk copy can take where both addresses are 16-byte aligned (its
// bytes complete a transaction on bar), the rest with plain loads.
// Returns the bytes handed to the bulk copy.
template <typename T>
__device__ __forceinline__ uint32_t copy_segment(T* dst, const T* src, int n,
                                                 uint32_t bar, bool issue) {
  uint32_t bulk = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    bulk = static_cast<uint32_t>(n * sizeof(T)) & ~15u;
  }
  if (!issue) return bulk;
  if (bulk > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bulk), "r"(bar)
        : "memory");
  }
  for (int e = bulk / sizeof(T); e < n; ++e) dst[e] = src[e];
  return bulk;
}

// Stage this block's columns [j0, j0 + nvalid) of an (n_rows, G*H) weight
// matrix into rows [row0, row0 + n_rows) of W, each row [G][hc] at stride
// ws.  One segment a row where the block holds every column, one a row
// and gate otherwise; the segments go round the threads.  Returns, or with
// issue copies, this thread's bulk bytes.
template <typename T, int G>
__device__ uint32_t stage_weights(T* W, const T* w, int row0, int n_rows,
                                  int ws, int H, int hc, int j0, int nvalid,
                                  uint32_t bar, bool issue) {
  uint32_t bytes = 0;
  if (nvalid <= 0) return 0;
  const bool whole = hc == H;
  const int n_seg = whole ? n_rows : n_rows * G;
  for (int s = threadIdx.x; s < n_seg; s += blockDim.x) {
    const int k = whole ? s : s / G;
    const int g = whole ? 0 : s - k * G;
    T* dst = W + static_cast<size_t>(row0 + k) * ws + g * hc;
    const T* src = w + (static_cast<size_t>(k) * G + g) * H + j0;
    bytes += copy_segment(dst, src, whole ? G * H : nvalid, bar, issue);
  }
  return bytes;
}

// mbarrier helpers (shared::cta), as csrc/flash_attention.cu uses them
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// returns once phase `parity` of the barrier has completed; traps after
// about 2^30 tries rather than hang the card
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

// The prologue of a layer kernel: bring wx, wh and b for this block's
// columns into shared memory (the bulk copy for the aligned bytes, plain
// loads for the rest), zero the padding, fill rowbuf[0] with x_0 and h0
// and rowbuf[1] with zeros, and wait for it all across the cluster.
template <typename T, int G>
__device__ void prologue(const Dims& d, const Layout<T, G>& L,
                         unsigned char* smem, const T* x_seq, const T* h0,
                         const T* wx, const T* wh, const T* b, int row0,
                         int j0, int nvalid) {
  T* W = reinterpret_cast<T*>(smem + L.w_off);
  T* bias = reinterpret_cast<T*>(smem + L.b_off);
  float* rowbuf = reinterpret_cast<float*>(smem + L.rowbuf_off);
  const uint32_t bar = smem_addr(smem);
  if (threadIdx.x == 0) {
    mbar_init(bar, blockDim.x / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  LAYER_STAMP(1);
  // each warp announces its threads' bulk bytes in one arrival (arrivals
  // are atomics on one word), then the threads issue their copies; the
  // bias is a weight matrix of one row
  uint32_t mine = 0;
  for (int issue = 0; issue < 2; ++issue) {
    if (issue) {
      const uint32_t warp_bytes = __reduce_add_sync(0xffffffffu, mine);
      if (threadIdx.x % 32 == 0) mbar_arrive_expect_tx(bar, warp_bytes);
      __syncwarp();
    }
    mine = stage_weights<T, G>(W, wx, 0, d.I, L.ws, d.H, L.hc, j0, nvalid,
                               bar, issue) +
           stage_weights<T, G>(W, wh, L.i4, d.H, L.ws, d.H, L.hc, j0, nvalid,
                               bar, issue) +
           stage_weights<T, G>(bias, b, 0, 1, G * L.hc, d.H, L.hc, j0,
                               nvalid, bar, issue);
  }
  LAYER_STAMP(2);
  // zero the pad rows of W: I..i4 and i4+H..kw
  const int pad_x = (L.i4 - d.I) * L.ws;
  const int pad_h = (L.kw - L.i4 - d.H) * L.ws;
  for (int e = threadIdx.x; e < pad_x + pad_h; e += blockDim.x) {
    const size_t at = e < pad_x ? static_cast<size_t>(d.I) * L.ws + e
                                : static_cast<size_t>(L.i4 + d.H) * L.ws +
                                      (e - pad_x);
    store(W + at, 0.0f);
  }
  LAYER_STAMP(3);
  // the row buffers, four elements a thread at a time so that their loads
  // are in flight together
  const int n0 = d.rows * L.kw;
  for (int e0 = threadIdx.x; e0 < 2 * n0; e0 += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * blockDim.x;
      const int r = e / L.kw, k = e - r * L.kw, row = row0 + r;
      v[q] = 0.0f;
      if (e < n0 && row < d.B) {
        if (k < d.I) {
          v[q] = load(x_seq + static_cast<size_t>(row) * d.I + k);
        } else if (k >= L.i4 && k < L.i4 + d.H) {
          v[q] = load(h0 + static_cast<size_t>(row) * d.H + (k - L.i4));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < 2 * n0) rowbuf[e] = v[q];
    }
  }
  LAYER_STAMP(4);
  mbar_wait(bar, 0);
  LAYER_STAMP(5);
  // the cluster barrier also keeps every block's shared memory alive
  // before the first write from a peer
  if (d.cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// x_{t+1} of the block's rows, loaded into registers while step t computes
template <typename T>
struct NextX {
  float v[kXRegs];

  __device__ __forceinline__ void load_step(const Dims& d, const T* x_seq,
                                            int t, int row0) {
#pragma unroll
    for (int q = 0; q < kXRegs; ++q) {
      const int e = threadIdx.x + q * blockDim.x;
      v[q] = 0.0f;
      if (t < d.T && e < d.rows * d.I) {
        const int r = e / d.I, i = e - r * d.I;
        if (row0 + r < d.B) {
          v[q] = load(x_seq + (static_cast<size_t>(t) * d.B + row0 + r) * d.I +
                      i);
        }
      }
    }
  }

  __device__ __forceinline__ void put(const Dims& d, float* buf, int kw) {
#pragma unroll
    for (int q = 0; q < kXRegs; ++q) {
      const int e = threadIdx.x + q * blockDim.x;
      if (e < d.rows * d.I) {
        const int r = e / d.I;
        buf[r * kw + (e - r * d.I)] = v[q];
      }
    }
  }
};

// The gate sums of this thread's RPT rows over its share of k in
// [k_begin, k_end) (multiples of 4): a[g][r] += rows[r][k] * W[k][g][col].
// KS lanes (consecutive in the warp) share a column and split k into
// chunks of C, lane ks taking chunks ks, ks + KS, ...: C = 4 (one float4
// of x | h a row) for KS = 2, C = 2 for KS = 4.  With W's row stride
// (Layout::ws) the KS lanes' chunks fall on distinct banks, and each weight
// read from shared memory feeds RPT FMAs.  rows are the thread's rows of
// the current row buffer, stride kw; wcol is W at the thread's column.
template <typename T, int G, int RPT, int KS>
__device__ __forceinline__ void accumulate(const float* rows, int kw,
                                           const T* wcol, int hc, int ws,
                                           int k_begin, int k_end, int ks,
                                           float (&a)[G][RPT]) {
  constexpr int C = KS == 4 ? 2 : 4;
#pragma unroll 2
  for (int k = k_begin + C * ks; k < k_end; k += C * KS) {
    float v[RPT][C];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if constexpr (C == 4) {
        const float4 q = *reinterpret_cast<const float4*>(rows + r * kw + k);
        v[r][0] = q.x, v[r][1] = q.y, v[r][2] = q.z, v[r][3] = q.w;
      } else {
        const float2 q = *reinterpret_cast<const float2*>(rows + r * kw + k);
        v[r][0] = q.x, v[r][1] = q.y;
      }
    }
#pragma unroll
    for (int kk = 0; kk < C; ++kk) {
      const T* w = wcol + (k + kk) * ws;
      float wg[G];
#pragma unroll
      for (int g = 0; g < G; ++g) wg[g] = load(w + g * hc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
#pragma unroll
        for (int g = 0; g < G; ++g) a[g][r] = fmaf(v[r][kk], wg[g], a[g][r]);
      }
    }
  }
}

// the sums of the KS lanes of a column, in every one of them
template <int G, int RPT, int KS>
__device__ __forceinline__ void reduce_lanes(float (&a)[G][RPT]) {
#pragma unroll
  for (int off = KS / 2; off > 0; off /= 2) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        a[g][r] += __shfl_xor_sync(0xffffffffu, a[g][r], off);
      }
    }
  }
}

// out[g] = a[g][r] for a row r known only at run time, by selects, so the
// lanes of a warp that finish different rows stay converged
template <int G, int RPT>
__device__ __forceinline__ void pick(const float (&a)[G][RPT], int r,
                                     float (&out)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    out[g] = a[g][0];
#pragma unroll
    for (int q = 1; q < RPT; ++q) out[g] = r == q ? a[g][q] : out[g];
  }
}

// Where a thread works: lane ks of the KS that share hidden column jl of
// the block, for rows r0 .. r0 + RPT - 1 of the block; after the sums, lane
// ks < RPT finishes row r0 + ks.  Threads past the block's rows or columns
// run the loops on clamped rows (the shuffles need every lane) and write
// nothing.
struct Place {
  int ks, jl, r0, r_read;
  bool active;    // inside the block's rows and columns
  bool finishes;  // and finishes row r0 + ks

  template <int RPT, int KS>
  __device__ static Place of(const Dims& d, int hc, int nvalid) {
    static_assert(RPT <= KS, "each lane finishes at most one row");
    Place p;
    const int col_thread = threadIdx.x / KS;
    p.ks = threadIdx.x % KS;
    p.jl = col_thread % hc;
    p.r0 = col_thread / hc * RPT;
    p.active = p.r0 < d.rows && p.jl < nvalid;
    p.finishes = p.active && p.ks < RPT;
    p.r_read = min(p.r0, d.rows - RPT);
    return p;
  }
};

// h' of (row r, column i4 + j) into the next row buffer of every block of
// the cluster
__device__ __forceinline__ void publish_h(const Dims& d, float* next_buf,
                                          int at, float v) {
  if (d.cluster == 1) {
    next_buf[at] = v;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  for (int q = 0; q < d.cluster; ++q) {
    *cluster.map_shared_rank(next_buf + at, q) = v;
  }
}

__device__ __forceinline__ void step_barrier(const Dims& d) {
  if (d.cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Launch kernel on stream with the dynamic shared memory of its layout
// (opted in above 48 KB), a cluster of d.cluster blocks along y and the
// clients along z.
// Returns the launch's error code.
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d.B + d.rows - 1) / d.rows, d.cluster, d.M);
  cfg.blockDim = dim3(d.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = d.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = d.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// f(rows per thread, k-split) as compile-time constants: rows per thread
// 1 or 2 and k-split 2 or 4 are the kernel templates' four instances (the
// ones kernels/_cuda.py::cell_plan picks); another pair refuses
template <typename F>
int dispatch(int rows_per_thread, int k_split, F&& f) {
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using Four = std::integral_constant<int, 4>;
  const auto by_split = [&](auto rpt) {
    switch (k_split) {
      case 2: return f(rpt, Two{});
      case 4: return f(rpt, Four{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (rows_per_thread) {
    case 1: return by_split(One{});
    case 2: return by_split(Two{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the sizes a kernel takes: the host plan (kernels/_cuda.py::cell_plan)
// already checked them; a mismatch refuses the launch
inline bool bad_dims(const Dims& d, int rows_per_thread, int k_split,
                     int hc) {
  const bool cluster_ok = d.cluster == 1 || d.cluster == 2 ||
                          d.cluster == 4 || d.cluster == 8;
  return d.M < 1 || d.M > kMaxClients || d.T < 1 || d.B < 1 || d.I < 1 ||
         d.H < 1 || !cluster_ok ||
         d.rows < 1 || d.rows % rows_per_thread != 0 || d.threads < 32 ||
         d.threads > kMaxThreads || d.threads % 32 != 0 ||
         d.threads < hc * k_split * (d.rows / rows_per_thread) ||
         d.rows * d.I > kXRegs * d.threads;
}

}  // namespace layer
