// Banded semi-global Gotoh DP that returns path statistics, for Hopper.
//
// One thread block aligns one pair.  The DP sweeps anti-diagonals over a
// rolling window of W lanes (lane l of diagonal dd holds cell
// i = base[dd] + l, j = dd - i); each thread owns R consecutive lanes and
// keeps the H, E and F layers of the last two diagonals in registers.  The
// recurrence reads the neighbour lane of the previous diagonal: within a
// warp that is a shuffle, across warps the edge lanes go through shared
// memory, double-buffered so one barrier per diagonal suffices.  Both
// sequences are read once from the resident pool into shared memory.
//
// Per cell and layer the DP carries score, the last k match bits, the count
// of windows with >= match_id matches, and mcount << 16 | colcount (see
// ngspeciesid/ops/align_stats.py, which also holds the host side).  The
// result is one 16-int row per pair: the last-row endpoint tracker, then
// the last-column one, each (score, coord, hist, wsum, wcount, mcount,
// colcount, diagonal).
//
// Build (ngspeciesid/ops/stats_cuda.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libstatsdp.so stats_dp.cu

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kTableCols = 8;  // len1, len2, gap_open, k, match_id, off1, off2, -
constexpr int kRowCols = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Cell {
  int s;   // score
  int h;   // match bits of the last k columns
  int wc;  // windows with >= match_id matches so far
  int mc;  // mcount << 16 | colcount
};

struct Tracker {
  int s, coord, h, wc, mc, dd;
};

// Edge lanes a warp publishes for its neighbours: the first lane (read by
// the warp below as its right neighbour) and the last lane (read by the
// warp above as its left neighbour).
struct Edge {
  Cell hd1, layer, hd2;  // layer: ee for the first lane, ff for the last
};

__device__ __forceinline__ Cell fill_cell() { return Cell{kNeg, 0, 0, 0}; }

__device__ __forceinline__ Cell push(Cell c, int bit, int k, int mid,
                                     unsigned mask) {
  const unsigned h = ((static_cast<unsigned>(c.h) << 1) | bit) & mask;
  const int mc = c.mc + (bit << 16) + 1;
  c.wc += ((mc & 0xFFFF) >= k) & (__popc(h) >= mid);
  c.h = static_cast<int>(h);
  c.mc = mc;
  return c;
}

__device__ __forceinline__ Cell shfl_up(const Cell& c) {
  return Cell{__shfl_up_sync(~0u, c.s, 1), __shfl_up_sync(~0u, c.h, 1),
              __shfl_up_sync(~0u, c.wc, 1), __shfl_up_sync(~0u, c.mc, 1)};
}

__device__ __forceinline__ Cell shfl_down(const Cell& c) {
  return Cell{__shfl_down_sync(~0u, c.s, 1), __shfl_down_sync(~0u, c.h, 1),
              __shfl_down_sync(~0u, c.wc, 1), __shfl_down_sync(~0u, c.mc, 1)};
}

__device__ __forceinline__ Cell pick(bool p, const Cell& a, const Cell& b) {
  return p ? a : b;
}

// Value of lane (l - s) of `v` for own lane r, s in {-1, 0, 1}; `left` and
// `right` are the neighbouring threads' edge lanes.  Lanes outside [0, W)
// read as unreachable.
template <int R>
__device__ __forceinline__ Cell lane_src(const Cell (&v)[R], int r, int s,
                                         const Cell& left, const Cell& right,
                                         int l, int W) {
  const int src = l - s;
  if (src < 0 || src >= W) return fill_cell();
  if (s == 0) return v[r];
  if (s == 1) return r > 0 ? v[r > 0 ? r - 1 : 0] : left;
  return r < R - 1 ? v[r < R - 1 ? r + 1 : 0] : right;
}

__device__ __forceinline__ void track(Tracker& t, bool on, const Cell& c,
                                      int coord, int dd) {
  if (on && c.s >= t.s) t = Tracker{c.s, coord, c.h, c.wc, c.mc, dd};
}

__device__ __forceinline__ long long tracker_key(const Tracker& t) {
  return (static_cast<long long>(t.s) << 32) |
         static_cast<unsigned>(t.dd);
}

// Writes the tracker with the largest (score, diagonal) of the block: the
// corner-most endpoint on score ties, as ops/align._best_end picks it.
__device__ void reduce_tracker(const Tracker& t, int* out, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  long long key = tracker_key(t);
  long long best = key;
  for (int o = 16; o > 0; o >>= 1) {
    const long long other = __shfl_xor_sync(~0u, best, o);
    best = other > best ? other : best;
  }
  if (lane == 0) red[warp] = best;
  __syncthreads();
  best = red[0];
  for (int w = 1; w < nwarps; ++w) best = red[w] > best ? red[w] : best;
  const bool empty = static_cast<unsigned>(best) == 0u;  // no cell tracked
  if ((empty && threadIdx.x == 0) || (!empty && key == best)) {
    const Tracker e{kNeg, -1, 0, 0, 0, 0};
    const Tracker& w = empty ? e : t;
    out[0] = w.s;
    out[1] = w.coord;
    out[2] = w.h;
    out[3] = __popc(static_cast<unsigned>(w.h));
    out[4] = w.wc;
    out[5] = static_cast<int>(static_cast<unsigned>(w.mc) >> 16);
    out[6] = w.mc & 0xFFFF;
    out[7] = w.dd;
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    stats_dp_kernel(const uint8_t* __restrict__ pool,
                    const int* __restrict__ table,
                    const int* __restrict__ base, int* __restrict__ out,
                    int W, int band, int match, int mismatch, int gap_ext,
                    int n_cap) {
  extern __shared__ uint8_t seqs[];  // s1 at 0, s2 at n_cap
  __shared__ Edge lo_edge[2][kMaxWarps];
  __shared__ Edge hi_edge[2][kMaxWarps];
  __shared__ long long red[kMaxWarps];

  const int* row = table + static_cast<size_t>(blockIdx.x) * kTableCols;
  const int len1 = row[0], len2 = row[1], gopen = row[2], k = row[3],
            mid = row[4];
  const uint8_t* g1 = pool + row[5];
  const uint8_t* g2 = pool + row[6];
  const uint8_t* s1 = seqs;
  const uint8_t* s2 = seqs + n_cap;
  for (int x = threadIdx.x; x < len1; x += blockDim.x) seqs[x] = g1[x];
  for (int x = threadIdx.x; x < len2; x += blockDim.x) seqs[n_cap + x] = g2[x];
  __syncthreads();

  const unsigned mask = (1u << k) - 1u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int l0 = threadIdx.x * R;

  Cell hd1[R], hd2[R], ee[R], ff[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    hd1[r] = l0 + r == 0 ? Cell{0, 0, 0, 0} : fill_cell();  // cell (0, 0)
    hd2[r] = ee[r] = ff[r] = fill_cell();
  }
  Tracker trow{kNeg, -1, 0, 0, 0, 0}, tcol{kNeg, -1, 0, 0, 0, 0};

  int base_p1 = base[0], base_p2 = base[0];
  const int dmax = len1 + len2;
  for (int dd = 1; dd <= dmax; ++dd) {
    const int b = base[dd];
    const int d1 = b - base_p1;  // window slope since dd - 1: 0 or 1
    const int d2 = b - base_p2;  // since dd - 2: 0, 1 or 2
    base_p2 = base_p1;
    base_p1 = b;

    const int par = dd & 1;
    if (lane == 31) hi_edge[par][warp] = Edge{hd1[R - 1], ff[R - 1], hd2[R - 1]};
    if (lane == 0) lo_edge[par][warp] = Edge{hd1[0], ee[0], hd2[0]};
    __syncthreads();

    // neighbour edge lanes: the left one is thread t-1's last lane, the
    // right one thread t+1's first lane (shuffles run warp-uniformly)
    Cell l_hd1 = shfl_up(hd1[R - 1]), l_ff = shfl_up(ff[R - 1]),
         l_hd2 = shfl_up(hd2[R - 1]);
    Cell r_hd1 = shfl_down(hd1[0]), r_ee = shfl_down(ee[0]),
         r_hd2 = shfl_down(hd2[0]);
    if (lane == 0) {
      if (warp > 0) {
        const Edge& e = hi_edge[par][warp - 1];
        l_hd1 = e.hd1;
        l_ff = e.layer;
        l_hd2 = e.hd2;
      } else {
        l_hd1 = l_ff = l_hd2 = fill_cell();
      }
    }
    if (lane == 31) {
      if (warp + 1 < nwarps) {
        const Edge& e = lo_edge[par][warp + 1];
        r_hd1 = e.hd1;
        r_ee = e.layer;
        r_hd2 = e.hd2;
      } else {
        r_hd1 = r_ee = r_hd2 = fill_cell();
      }
    }

    Cell hn[R], en[R], fn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = l0 + r;
      const int iv = b + l, jv = dd - iv;
      const bool in_seq = iv >= 1 && iv <= len1 && jv >= 1 && jv <= len2;
      bool interior = in_seq;
      if (band > 0)
        interior = interior && (jv - band) * len1 <= iv * len2 &&
                   iv * len2 <= (jv + band + 1) * len1 - 1;
      const bool boundary = (iv == 0 && jv >= 0 && jv <= len2) ||
                            (jv == 0 && iv <= len1);
      const bool valid = interior || boundary;

      // E: gap in s1, predecessor (i, j-1) on dd-1
      const Cell h_e = lane_src<R>(hd1, r, -d1, l_hd1, r_hd1, l, W);
      const Cell e_e = lane_src<R>(ee, r, -d1, l_hd1, r_ee, l, W);
      const int eo = h_e.s - gopen, ex = e_e.s - gap_ext;
      Cell e = pick(eo >= ex, h_e, e_e);
      e.s = max(eo, ex);
      e = push(e, 0, k, mid, mask);
      // F: gap in s2, predecessor (i-1, j) on dd-1
      const Cell h_f = lane_src<R>(hd1, r, 1 - d1, l_hd1, r_hd1, l, W);
      const Cell f_f = lane_src<R>(ff, r, 1 - d1, l_ff, r_hd1, l, W);
      const int fo = h_f.s - gopen, fx = f_f.s - gap_ext;
      Cell f = pick(fo >= fx, h_f, f_f);
      f.s = max(fo, fx);
      f = push(f, 0, k, mid, mask);
      // diagonal: (i-1, j-1) on dd-2 plus the substitution column
      const int bit = in_seq && s1[iv - 1] == s2[jv - 1];
      Cell d = lane_src<R>(hd2, r, 1 - d2, l_hd2, r_hd2, l, W);
      d.s += bit ? match : mismatch;
      d = push(d, bit, k, mid, mask);

      // H choice (traceback tie-break: diag > up > left)
      const int h_no_e = max(d.s, f.s);
      Cell h = pick(e.s > h_no_e, e, pick(f.s > d.s, f, d));
      h.s = max(h_no_e, e.s);
      if (boundary) {
        // a path restarts here after i + j = dd leading gap columns
        h = Cell{0, 0, mid <= 0 ? max(dd - k + 1, 0) : 0, dd};
      }
      if (!valid) h.s = kNeg;

      const bool in_window = l < W;
      track(trow, in_window && valid && iv == len1, h, jv, dd);
      track(tcol, in_window && valid && jv == len2, h, iv, dd);
      hn[r] = h;
      en[r] = e;
      fn[r] = f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      hd2[r] = hd1[r];
      hd1[r] = hn[r];
      ee[r] = en[r];
      ff[r] = fn[r];
    }
  }

  int* o = out + static_cast<size_t>(blockIdx.x) * kRowCols;
  reduce_tracker(trow, o, red);
  reduce_tracker(tcol, o + 8, red);
}

template <int R>
cudaError_t launch(cudaStream_t stream, int B, int threads, size_t smem,
                   const uint8_t* pool, const int* table, const int* base,
                   int* out, int W, int band, int match, int mismatch,
                   int gap_ext, int n_cap) {
  // a block may use only 48 KB of shared memory in all unless the kernel
  // opts into more; the two sequences alone take up to 64 KB
  cudaError_t err = cudaFuncSetAttribute(
      stats_dp_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  stats_dp_kernel<R><<<B, threads, smem, stream>>>(
      pool, table, base, out, W, band, match, mismatch, gap_ext, n_cap);
  return cudaGetLastError();
}

ffi::Error StatsDpImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> pool,
                       ffi::Buffer<ffi::S32> table, ffi::Buffer<ffi::S32> base,
                       ffi::ResultBuffer<ffi::S32> out, int32_t W,
                       int32_t band, int32_t match, int32_t mismatch,
                       int32_t gap_ext, int32_t n_cap, int32_t m_cap,
                       int32_t lanes_per_thread) {
  const auto dims = table.dimensions();
  if (dims.size() != 2 || dims[1] != kTableCols)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "pair table must be (B, 8) int32");
  const int B = static_cast<int>(dims[0]);
  const int R = lanes_per_thread;
  const int threads = ((W + R - 1) / R + 31) / 32 * 32;
  if (threads > kMaxThreads)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "window too wide for one block");
  const size_t smem = static_cast<size_t>(n_cap) + m_cap;
  cudaError_t err;
  switch (R) {
    case 1:
      err = launch<1>(stream, B, threads, smem, pool.typed_data(),
                      table.typed_data(), base.typed_data(),
                      out->typed_data(), W, band, match, mismatch, gap_ext,
                      n_cap);
      break;
    case 2:
      err = launch<2>(stream, B, threads, smem, pool.typed_data(),
                      table.typed_data(), base.typed_data(),
                      out->typed_data(), W, band, match, mismatch, gap_ext,
                      n_cap);
      break;
    case 4:
      err = launch<4>(stream, B, threads, smem, pool.typed_data(),
                      table.typed_data(), base.typed_data(),
                      out->typed_data(), W, band, match, mismatch, gap_ext,
                      n_cap);
      break;
    case 8:
      err = launch<8>(stream, B, threads, smem, pool.typed_data(),
                      table.typed_data(), base.typed_data(),
                      out->typed_data(), W, band, match, mismatch, gap_ext,
                      n_cap);
      break;
    default:
      return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                        "lanes_per_thread must be 1, 2, 4 or 8");
  }
  if (err != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(NgsidStatsDp, StatsDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("W")
                                  .Attr<int32_t>("band")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_ext")
                                  .Attr<int32_t>("n_cap")
                                  .Attr<int32_t>("m_cap")
                                  .Attr<int32_t>("lanes_per_thread"));
