// K1: events -> voxel grid, with or without its normalisation, hand-written
// for Hopper (sm_90a).  The grid is written once, by tiles, and never
// zero-filled or updated with global atomics.
//
// Replaces the TPU kernel eemflow_tpu/ops/pallas/voxel_scatter.py
// voxel_scatter_pallas (pallas_call at :186), which runs one program per
// (batch, bin) over time-sorted event ranges found by a searchsorted,
// because a TPU core runs its grid in order and has no scatter atomics;
// and, in voxelize mode, the normalisation its caller runs after it as XLA
// code (eemflow_tpu/events/voxel.py normalize_voxel_grid, :332-343).
//
// Semantics (events/voxel.py): events [B, N, 4] float32 (t, x, y, p),
// time-sorted, the first n_valid[b] real.  ts = (bins-1)*(t-t0)/dT with
// t0 = t[b,0], dT = t[b,n_valid-1]-t0 (0 -> 1); the event votes p*(1-dt)
// into bin floor(ts) and p*dt into bin floor(ts)+1, p == 0 meaning -1.
// Padding, out-of-frame events and floor(ts) < 0 vote nothing.  ts is
// computed with explicit round-to-nearest intrinsics, in the JAX order: an
// FMA contraction could move an event across a bin boundary, which changes
// a cell by up to 1, not by a rounding error.  The normalisation works per
// sample over the nonzero cells: mean, sample std (ddof = 1), the
// denominator 1 unless n > 1 and std > 0; zero cells stay zero.
//
// Bound on this card: bytes.  Both entry points must read each valid event
// once (16 B) and write the [B, bins, H, W] grid once (720x1280x5 float32
// = 18.4 MB a sample); nothing else.  The earlier design zero-filled the
// grid (a second full write) and added every vote with a global atomic; its
// caller then normalised with a dozen tensor ops, each a full pass.  This
// one, for tiles of 32x32 pixels (all bins of a tile in one CTA's shared
// memory, 20 KB at 5 bins):
//
//   1. vox_bin, one pass over the events (a CTA per slice of at most
//      EVENTS_PER_CTA valid events of a sample): each event's votes are
//      counted per tile in shared memory, the counts scanned, the votes
//      sorted by tile in shared memory as 8-byte records (cell in the tile,
//      weight) and written out as the CTA's own run, with its per-tile
//      counts and starts.  No CTA reads another's rows, so nothing is
//      zeroed or scanned across CTAs; the records (a few MB against the
//      grid's 18.4 MB a sample) stay in the 50 MB L2;
//   2. vox_tiles, a CTA per tile: it gathers its records from the G runs,
//      adds them into its cells with shared-memory atomics and writes every
//      cell of the tile once, zeros included, with streaming stores (the
//      records stay in L2).  In voxelize mode this pass writes nothing: it
//      reduces the tile's nonzero count, sum and sum of squares into
//      per-tile partials (float32 over a thread's cells, float64 across
//      threads and tiles), and the last CTA of a sample (an atomic ticket,
//      reset by vox_bin) reduces them in tile order into the sample's mean
//      and 1/std;
//   3. voxelize only: vox_tiles again, adding the records again and writing
//      the normalised tile once, (v - mean) times 1/std rounded once: within
//      an ulp of the division.  Re-adding the records (a few MB, in L2)
//      costs less than writing the raw grid and normalising it in place
//      (the grid read and written again), which was timed and dropped.
//
// So scatter takes 2 launches and voxelize 3; the grid is written once and
// each valid event read once.  The sums are still order-free: shared-memory
// atomics add a cell's votes in no fixed order, as the global atomics of
// the earlier design did, so cells agree with the plain version to
// rounding, not bit for bit; the record order within a CTA's run varies too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                // pixels a tile side
constexpr int TILE_PIX = TILE * TILE;
constexpr int MAX_BINS = 48;            // bins * 4 KB of shared memory a tile CTA
constexpr int BIN_THREADS = 1024;
constexpr int EPT = 4;                  // events a vox_bin thread holds
constexpr int EVENTS_PER_CTA = BIN_THREADS * EPT;
constexpr int TILE_THREADS = 256;
constexpr int GATHER = 4;               // records a tile thread loads before it adds them
constexpr int MAX_SMEM = 232448;        // what one block may opt into on sm_90

enum Mode { SCATTER = 0, VOXELIZE = 1 };

struct Frame {
  int bins, H, W, TX, T, N;
  int G;  // vox_bin CTAs per sample, each over at most EVENTS_PER_CTA events
  int R;  // record slots of one vox_bin CTA: two votes per event of its slice
};

// the votes of one event: 1 (the left vote, bin tis) or 3 (and the right,
// bin tis + 1), 0 for none; tile and cell are those of the left vote
__device__ __forceinline__ int event_votes(const float4 e, float t0, float dT, const Frame& f,
                                           int& tile, int& cell, float& wl, float& wr) {
  const float ts = __fdiv_rn(__fmul_rn((float)(f.bins - 1), __fsub_rn(e.x, t0)), dT);
  const float tis = floorf(ts);
  const float dts = __fsub_rn(ts, tis);
  // float -> int truncates toward zero, as astype(int32) does
  const int x = (int)e.y;
  const int y = (int)e.z;
  if (x < 0 || x >= f.W || y < 0 || y >= f.H || !(tis >= 0.0f) || !(tis < (float)f.bins)) return 0;
  const float pol = (e.w == 0.0f) ? -1.0f : e.w;
  wl = __fmul_rn(pol, __fsub_rn(1.0f, dts));
  wr = __fmul_rn(pol, dts);
  tile = (y / TILE) * f.TX + x / TILE;
  cell = (int)tis * TILE_PIX + (y % TILE) * TILE + x % TILE;
  return __fadd_rn(tis, 1.0f) < (float)f.bins ? 3 : 1;
}

// exclusive prefix sum of v[0, n) in place, by the whole block; returns
// the total to every thread
__device__ int block_exclusive_scan(int* v, int n, int* warp_sums) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += v[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int inc = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += o;
    }
    if (lane < nw) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = inc - own + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = v[i];
    v[i] = run;
    run += c;
  }
  const int total = warp_sums[nw - 1];
  __syncthreads();
  return total;
}

// 1. one pass over the events: each CTA takes a slice of at most
// EVENTS_PER_CTA valid events of its sample, counts their votes per tile,
// sorts them by tile in shared memory and writes them out as one run of
// records with its per-tile counts and starts (its own rows: no other CTA
// reads or writes them, so nothing is zeroed or scanned across CTAs)
__global__ void __launch_bounds__(BIN_THREADS) vox_bin(const float4* __restrict__ events,
                                                       const int* __restrict__ n_valid,
                                                       int* __restrict__ counts, int* __restrict__ starts,
                                                       uint2* __restrict__ records, int* __restrict__ ticket,
                                                       Frame f) {
  extern __shared__ uint2 stage[];  // [2 * EVENTS_PER_CTA] records, then [T] counters
  int* hist = reinterpret_cast<int*>(stage + 2 * EVENTS_PER_CTA);
  __shared__ int warp_sums[32];
  const int g = blockIdx.x, b = blockIdx.y;
  const float4* ev = events + (size_t)b * f.N;
  const int nv = max(0, min(n_valid[b], f.N));
  const int chunk = (nv + f.G - 1) / f.G;
  const int begin = min(nv, g * chunk), end = min(nv, begin + chunk);
  float4 e[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int i = begin + u * BIN_THREADS + threadIdx.x;
    if (i < end) e[u] = ev[i];
  }
  float t0 = 0.0f, dT = 1.0f;
  if (nv > 0) {
    t0 = ev[0].x;
    dT = __fsub_rn(ev[nv - 1].x, t0);
    if (dT == 0.0f) dT = 1.0f;
  }
  for (int t = threadIdx.x; t < f.T; t += blockDim.x) hist[t] = 0;
  if (g == 0 && threadIdx.x == 0) ticket[b] = 0;
  __syncthreads();
  int m[EPT], tile[EPT], cell[EPT];
  float wl[EPT], wr[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    m[u] = 0;
    if (begin + u * BIN_THREADS + (int)threadIdx.x < end)
      m[u] = event_votes(e[u], t0, dT, f, tile[u], cell[u], wl[u], wr[u]);
    if (m[u]) atomicAdd(&hist[tile[u]], m[u] == 3 ? 2 : 1);
  }
  __syncthreads();
  const size_t row = ((size_t)b * f.G + g) * f.T;
  for (int t = threadIdx.x; t < f.T; t += blockDim.x) counts[row + t] = hist[t];
  const int total = block_exclusive_scan(hist, f.T, warp_sums);
  for (int t = threadIdx.x; t < f.T; t += blockDim.x) starts[row + t] = hist[t];
  __syncthreads();  // every start is out before hist becomes the cursors
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    if (!m[u]) continue;
    const int slot = atomicAdd(&hist[tile[u]], m[u] == 3 ? 2 : 1);
    stage[slot] = make_uint2((unsigned)cell[u], __float_as_uint(wl[u]));
    if (m[u] == 3) stage[slot + 1] = make_uint2((unsigned)(cell[u] + TILE_PIX), __float_as_uint(wr[u]));
  }
  __syncthreads();
  uint2* out = records + ((size_t)b * f.G + g) * f.R;
  for (int i = threadIdx.x; i < total; i += blockDim.x) out[i] = stage[i];
}

struct Stats {
  float mean, inv_denom;  // 1 / the float32 denominator, rounded once: within an ulp of dividing
};

// s += v with the rounding error kept in lost (Kahan): s - lost is the sum
__device__ __forceinline__ void kahan_add(float& s, float& lost, float v) {
  const float y = __fsub_rn(v, lost);  // v less what the sum overshot so far
  const float t = __fadd_rn(s, y);
  lost = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// three doubles summed over the block, in a fixed order; the result in
// thread 0
__device__ void block_sum3(double& a, double& b, double& c, double* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (lane == 0) {
    scratch[3 * warp] = a;
    scratch[3 * warp + 1] = b;
    scratch[3 * warp + 2] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = c = 0.0;
    for (int w = 0; w < nw; ++w) {
      a += scratch[3 * w];
      b += scratch[3 * w + 1];
      c += scratch[3 * w + 2];
    }
  }
  __syncthreads();
}

// what one vox_tiles launch does with its summed tile: write it, reduce it
// into the sample's statistics, or write it normalised
enum Pass { WRITE_RAW, STATS, WRITE_NORM };

// 2. and 3.: one CTA per tile
template <Pass P>
__global__ void __launch_bounds__(TILE_THREADS) vox_tiles(const uint2* __restrict__ records,
                                                          const int* __restrict__ counts,
                                                          const int* __restrict__ starts,
                                                          double* __restrict__ partials, Stats* __restrict__ stats,
                                                          int* __restrict__ ticket, float* __restrict__ grid,
                                                          Frame f) {
  extern __shared__ float cells[];  // [bins][TILE][TILE], then the G runs' sources and offsets
  size_t* run_src = reinterpret_cast<size_t*>(cells + f.bins * TILE_PIX);
  int* run_off = reinterpret_cast<int*>(run_src + f.G);
  __shared__ double red[3 * TILE_THREADS / 32];
  __shared__ int total_sm, last;
  const int t = blockIdx.x, b = blockIdx.y;
  const int ncell = f.bins * TILE_PIX;
  // this tile's run of records from each vox_bin CTA of the sample, loaded
  // by all threads while they zero the cells; warp 0 then turns the run
  // lengths into offsets
  for (int g = threadIdx.x; g < f.G; g += blockDim.x) {
    const size_t row = ((size_t)b * f.G + g) * f.T + t;
    run_off[g] = counts[row];
    run_src[g] = ((size_t)b * f.G + g) * f.R + starts[row];
  }
  float4* c4 = reinterpret_cast<float4*>(cells);
  for (int c = threadIdx.x; c < ncell / 4; c += blockDim.x) c4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (threadIdx.x < 32) {
    int carry = 0;
    for (int g0 = 0; g0 < f.G; g0 += 32) {
      const int g = g0 + threadIdx.x;
      const int c = g < f.G ? run_off[g] : 0;
      int inc = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, d);
        if ((int)threadIdx.x >= d) inc += o;
      }
      if (g < f.G) run_off[g] = carry + inc - c;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (threadIdx.x == 0) total_sm = carry;
  }
  __syncthreads();
  const int n = total_sm;
  // GATHER records a thread at a time: their loads in flight together
  for (int r0 = 0; r0 < n; r0 += GATHER * TILE_THREADS) {
    uint2 v[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int r = r0 + u * TILE_THREADS + threadIdx.x;
      if (r < n) {
        int lo = 0, hi = f.G - 1;  // the last run that starts at or before r
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (run_off[mid] <= r) lo = mid;
          else hi = mid - 1;
        }
        v[u] = records[run_src[lo] + (r - run_off[lo])];
      }
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u)
      if (r0 + u * TILE_THREADS + (int)threadIdx.x < n) atomicAdd(&cells[v[u].x], __uint_as_float(v[u].y));
  }
  __syncthreads();
  const int y0 = (t / f.TX) * TILE, x0 = (t % f.TX) * TILE;
  const size_t hw = (size_t)f.H * f.W;
  float* out = grid + (size_t)b * f.bins * hw;
  if (P != STATS) {
    Stats st = {0.0f, 1.0f};
    if (P == WRITE_NORM) st = stats[b];
    for (int c = threadIdx.x; c < ncell; c += blockDim.x) {
      const int bin = c / TILE_PIX, y = y0 + (c / TILE) % TILE, x = x0 + c % TILE;
      if (y >= f.H || x >= f.W) continue;
      float v = cells[c];
      if (P == WRITE_NORM && v != 0.0f) v = __fmul_rn(__fsub_rn(v, st.mean), st.inv_denom);
      __stcs(out + bin * hw + (size_t)y * f.W + x, v);  // streaming: the records stay in L2
    }
  }
  if (P == STATS) {
    // cells outside the frame hold no vote, so they are zero and count
    // nothing; a thread's cells are summed in compensated float32 (a
    // float64 conversion a cell cost more than the rest of this pass), the
    // threads' sums in float64
    int own_cnt = 0;
    float own_sum = 0.0f, own_sq = 0.0f, lost_sum = 0.0f, lost_sq = 0.0f;
    for (int c = threadIdx.x; c < ncell; c += blockDim.x) {
      const float v = cells[c];
      if (v != 0.0f) {
        ++own_cnt;
        kahan_add(own_sum, lost_sum, v);
        kahan_add(own_sq, lost_sq, __fmul_rn(v, v));
      }
    }
    double cnt = own_cnt, sum = (double)own_sum - lost_sum, sq = (double)own_sq - lost_sq;
    block_sum3(cnt, sum, sq, red);
    if (threadIdx.x == 0) {
      double* p = partials + 3 * ((size_t)b * f.T + t);
      p[0] = cnt;
      p[1] = sum;
      p[2] = sq;
      __threadfence();
      last = atomicAdd(&ticket[b], 1) == f.T - 1;
    }
    __syncthreads();
    if (last) {
      // every tile of the sample has published its partials: reduce them
      // in tile order, read past L1 (another SM wrote them)
      __threadfence();
      cnt = sum = sq = 0.0;
      const double* p = partials + (size_t)b * f.T * 3;
      for (int k0 = 0; k0 < f.T; k0 += GATHER * TILE_THREADS) {
        double v[GATHER][3];
#pragma unroll
        for (int u = 0; u < GATHER; ++u) {
          const int k = k0 + u * TILE_THREADS + threadIdx.x;
#pragma unroll
          for (int q = 0; q < 3; ++q) v[u][q] = k < f.T ? __ldcg(p + 3 * k + q) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < GATHER; ++u) {
          cnt += v[u][0];
          sum += v[u][1];
          sq += v[u][2];
        }
      }
      block_sum3(cnt, sum, sq, red);
      if (threadIdx.x == 0) {
        // the JAX rules: mean over the nonzero cells, ddof = 1, the
        // denominator 1 unless n > 1 and std > 0
        const double mean = sum / fmax(cnt, 1.0);
        const double m2 = fmax(sq - sum * mean, 0.0);
        const float std_ = (float)sqrt(m2 / fmax(cnt - 1.0, 1.0));
        Stats st;
        st.mean = (float)mean;
        st.inv_denom = (cnt > 1.0 && std_ > 0.0f) ? __frcp_rn(std_) : 1.0f;
        stats[b] = st;
      }
    }
  }
}

Frame make_frame(int N, int bins, int H, int W) {
  Frame f;
  f.bins = bins;
  f.H = H;
  f.W = W;
  f.TX = (W + TILE - 1) / TILE;
  f.T = f.TX * ((H + TILE - 1) / TILE);
  f.N = N;
  f.G = max(1, (N + EVENTS_PER_CTA - 1) / EVENTS_PER_CTA);
  f.R = 2 * ((N + f.G - 1) / f.G);
  return f;
}

size_t align_up(size_t v) { return (v + 255) & ~(size_t)255; }

// the scratch buffer's parts, in bytes from its start
struct Layout {
  size_t records, partials, stats, counts, starts, ticket, total;
};

Layout layout(int B, const Frame& f) {
  Layout l;
  size_t at = 0;
  l.records = at;
  at = align_up(at + (size_t)B * f.G * f.R * sizeof(uint2));
  l.partials = at;
  at = align_up(at + (size_t)B * f.T * 3 * sizeof(double));
  l.stats = at;
  at = align_up(at + (size_t)B * sizeof(Stats));
  l.counts = at;
  at = align_up(at + (size_t)B * f.G * f.T * sizeof(int));
  l.starts = at;
  at = align_up(at + (size_t)B * f.G * f.T * sizeof(int));
  l.ticket = at;
  at = align_up(at + (size_t)B * sizeof(int));
  l.total = at;
  return l;
}

size_t tile_smem(const Frame& f) {
  return (size_t)f.bins * TILE_PIX * sizeof(float) + (size_t)f.G * (sizeof(size_t) + sizeof(int));
}

size_t bin_smem(const Frame& f) { return 2 * EVENTS_PER_CTA * sizeof(uint2) + (size_t)f.T * sizeof(int); }

// opt the kernel into more than 48 KB of dynamic shared memory, once per
// device and size
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[64];
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return e;
}

template <Pass P>
cudaError_t launch_tiles(const Layout& l, char* s, float* grid, int B, const Frame& f, cudaStream_t stream) {
  const size_t smem = tile_smem(f);
  cudaError_t e = allow_smem<vox_tiles<P>>(smem);
  if (e != cudaSuccess) return e;
  vox_tiles<P><<<dim3(f.T, B), TILE_THREADS, smem, stream>>>(
      reinterpret_cast<const uint2*>(s + l.records), reinterpret_cast<const int*>(s + l.counts),
      reinterpret_cast<const int*>(s + l.starts), reinterpret_cast<double*>(s + l.partials),
      reinterpret_cast<Stats*>(s + l.stats), reinterpret_cast<int*>(s + l.ticket), grid, f);
  return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch voxel_grid_launch needs for these shapes.
extern "C" long long voxel_grid_scratch_bytes(int B, int N, int bins, int H, int W) {
  return (long long)layout(B, make_frame(N, bins, H, W)).total;
}

// events: [B, N, 4] float32, 16-byte aligned; n_valid: [B] int32;
// grid: [B, bins, H, W] float32, written whole (no zero-fill needed);
// scratch: voxel_grid_scratch_bytes(...) bytes, 256-byte aligned.
// mode 0: the unnormalised grid (2 launches); 1: the normalised grid,
// adding the records again to write it (3 launches).
extern "C" int voxel_grid_launch(const float* events, const int* n_valid, float* grid, void* scratch,
                                 int B, int N, int bins, int H, int W, int mode, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (N < 0 || bins <= 0 || bins > MAX_BINS || mode < SCATTER || mode > VOXELIZE)
    return (int)cudaErrorInvalidValue;
  const Frame f = make_frame(N, bins, H, W);
  if (bin_smem(f) > MAX_SMEM || tile_smem(f) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Layout l = layout(B, f);
  char* s = static_cast<char*>(scratch);

  cudaError_t e = allow_smem<vox_bin>(bin_smem(f));
  if (e != cudaSuccess) return (int)e;
  vox_bin<<<dim3(f.G, B), BIN_THREADS, bin_smem(f), stream>>>(
      reinterpret_cast<const float4*>(events), n_valid, reinterpret_cast<int*>(s + l.counts),
      reinterpret_cast<int*>(s + l.starts), reinterpret_cast<uint2*>(s + l.records),
      reinterpret_cast<int*>(s + l.ticket), f);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if (mode == SCATTER) return (int)launch_tiles<WRITE_RAW>(l, s, grid, B, f, stream);
  if ((e = launch_tiles<STATS>(l, s, grid, B, f, stream)) != cudaSuccess) return (int)e;
  return (int)launch_tiles<WRITE_NORM>(l, s, grid, B, f, stream);
}

extern "C" const char* eemflow_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
