// Block-per-cell traversal over the cell-major slot layout, shared by the
// pair kernel (packed_lj_force.cu) and the order-CV kernels (values, force
// and fused LJ + CV: order_cv.cuh).
//
// One block owns one i cell.  It stages the rows of its 27 neighbour cells
// in shared memory once, compacted to the rows the caller keeps, in the
// order (column (ox, oy), z offset oz, rank), with ox, oy, oz each -1..1,
// the order of the plain sweeps' offsets; a neighbour past a box face is
// seen at x_j + h u (cell_geom.cuh).  Then one warp takes one kept row of
// the cell at a time and its 32 lanes split the staged rows; the rows that
// pass the caller's cheap test (r^2 against a cut-off) are queued in order
// and handed out one per lane, 32 at a time, to the caller's pair math, so
// a warp runs the costly math with all lanes busy rather than once for
// every lane that has a partner.  Where the output is one sum over all
// pairs rather than one row per i, a warp keeps its queue across all its
// i rows (warp_sweep_rows) and runs the math only when 32 hits are ready.
//
// Staging is two passes over the 27 cap rows, one warp per column (ox, oy)
// at a time.  The lanes of a warp take the column's 3 cells along z at 10
// ranks each: consecutive cells along z are consecutive slots (slot = rank
// C + cell), so one load instruction reads about 10 sectors rather than
// 30.  (1) ballots of the caller's keep test and the kept count of each
// neighbour cell; an exclusive scan of the 27 counts; (2) each kept row
// written at its scanned index.  The keep test sees every rank, so real
// rows need not form a prefix of a cell's ranks.  The own cell (offset 13)
// has zero shift, so its staged rows are the i rows' own coordinates, and
// `islot` maps them back to their slots.
//
// Everything is in a fixed order for a given input: the staged order, the
// queue order (the staged order of the hits), the rows each lane takes and
// the shuffle trees that sum them.  No atomics: two calls give the same
// bits.

#pragma once

#include <cuda_runtime.h>

#include "cell_geom.cuh"

namespace cell_stage {

constexpr int kColumns = 9;
constexpr int kOffsets = 27;
constexpr int kSelf = 13;     // offset (0, 0, 0): column 4, z offset 0
constexpr int kRanksPerIt = 10;  // ranks of each of a column's 3 cells
constexpr int kLanesUsed = 3 * kRanksPerIt;
constexpr int kQueue = 64;    // hit-queue entries per warp
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int n_its(int cap) {
  return (cap + kRanksPerIt - 1) / kRanksPerIt;
}

// Shared-memory scratch of one block, besides the staged rows.
struct Scratch {
  unsigned* mask;  // (9, n_its): ballots of the keep test
  int* off;        // (28,): start of each neighbour cell's kept rows
  int* islot;      // (cap,): slot of each kept row of the own cell
  int* queue;      // (warps, kQueue): hit queues
};

// Bytes of Scratch for a block of `warps` warps.
__host__ __device__ inline size_t scratch_bytes(int cap, int warps) {
  return sizeof(int) * (static_cast<size_t>(kColumns) * n_its(cap) +
                        (kOffsets + 1) + cap + warps * kQueue);
}

// Lays Scratch out at `base` (4-byte aligned).
__device__ inline Scratch scratch_at(void* base, int cap) {
  Scratch sc;
  sc.mask = static_cast<unsigned*>(base);
  sc.off = reinterpret_cast<int*>(sc.mask + kColumns * n_its(cap));
  sc.islot = sc.off + kOffsets + 1;
  sc.queue = sc.islot + cap;
  return sc;
}

struct Grid {
  int n_pad;
  int cap;
  int cx, cy, cz;
  const float* box;  // (n, kBoxRow) f32 geometry rows in device memory
};

// Fractional coordinates of a Cartesian point, f = h^-1 p (h upper
// triangular, core/box.py).
__device__ inline float3 fractional(float3 p, const cell_geom::HBox& h) {
  const float fz = p.z / h.Lz;
  const float fy = (p.y - h.yzLz * fz) / h.Ly;
  const float fx = (p.x - h.xyLy * fy - h.xzLz * fz) / h.Lx;
  return make_float3(fx, fy, fz);
}

// Stages the kept rows of the 27 neighbour cells of `cell`.  keep(o, j, p)
// decides the row at slot j of neighbour cell o (offset (o / 9 - 1,
// o / 3 % 3 - 1, o % 3 - 1)), p being its position with the cell's shift
// applied; it must give the same answer when called twice.  store(q, j, p)
// writes that row to staged index q.  h is the block's cell matrix (in
// shared or constant memory: a register copy would cost the order kernels
// their occupancy).  Ends with __syncthreads(); returns the number of
// staged rows.  sc.off[13] and sc.off[14] bound the own cell's rows.
template <class Keep, class Store>
__device__ int stage_neighbours(const float* __restrict__ r, const Grid& g,
                                const cell_geom::HBox& h, int cell,
                                const Scratch& sc, Keep keep, Store store) {
  const int C = g.cx * g.cy * g.cz;
  const int its = n_its(g.cap);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int iz = cell % g.cz;
  const int iy = (cell / g.cz) % g.cy;
  const int ix = cell / (g.cy * g.cz);
  // this lane's z offset and rank within an iteration, and the lanes of
  // its z offset
  const int dz = lane % 3;
  const int kk = lane / 3;
  const bool live = lane < kLanesUsed;
  const unsigned cell_lanes = 0x09249249u << dz & ((1u << kLanesUsed) - 1u);
  const unsigned lower = (1u << lane) - 1u;
  for (int c = warp; c < kColumns; c += n_warps) {
    const int o = 3 * c + dz;
    float3 sh;
    const int jcell = cell_geom::neighbour_cell(
        ix, iy, iz, c / 3 - 1, c % 3 - 1, dz - 1, g.cx, g.cy, g.cz, h, &sh);
    int count = 0;
    for (int it = 0; it < its; ++it) {
      const int k = it * kRanksPerIt + kk;
      bool kept = false;
      if (live && k < g.cap) {
        const int j = k * C + jcell;
        kept = keep(o, j, make_float3(r[j] + sh.x, r[g.n_pad + j] + sh.y,
                                      r[2 * g.n_pad + j] + sh.z));
      }
      const unsigned m = __ballot_sync(kFull, kept);
      if (lane == 0) sc.mask[c * its + it] = m;
      count += __popc(m & cell_lanes);
    }
    if (lane < 3) sc.off[o + 1] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sc.off[0] = 0;
    for (int o = 0; o < kOffsets; ++o) sc.off[o + 1] += sc.off[o];
  }
  __syncthreads();
  for (int c = warp; c < kColumns; c += n_warps) {
    const int o = 3 * c + dz;
    float3 sh;
    const int jcell = cell_geom::neighbour_cell(
        ix, iy, iz, c / 3 - 1, c % 3 - 1, dz - 1, g.cx, g.cy, g.cz, h, &sh);
    const int start = live ? sc.off[o] : 0;
    int base = start;
    for (int it = 0; it < its; ++it) {
      const unsigned m = sc.mask[c * its + it];
      if ((m >> lane) & 1u) {
        const int j = (it * kRanksPerIt + kk) * C + jcell;
        const int q = base + __popc(m & cell_lanes & lower);
        store(q, j, make_float3(r[j] + sh.x, r[g.n_pad + j] + sh.y,
                                r[2 * g.n_pad + j] + sh.z));
        if (o == kSelf) sc.islot[q - start] = j;
      }
      base += __popc(m & cell_lanes);
    }
  }
  __syncthreads();
  return sc.off[kOffsets];
}

// True when rank k of the own cell was not kept (a vacant slot: its outputs
// are written as zero by the caller).
__device__ inline bool own_dropped(const Scratch& sc, int cap, int k) {
  const int bit = (k % kRanksPerIt) * 3 + 1;  // z offset 0
  return !((sc.mask[4 * n_its(cap) + k / kRanksPerIt] >> bit) & 1u);
}

// One warp's sweep of one i row over the n_rows staged rows: hit(q) is the
// cheap test, pair(q) the math of a hit.  Hits are queued in staged order
// in `queue` (this warp's kQueue entries) and run 32 at a time, one per
// lane; the last fewer than 32 run on the first lanes.  Called by all 32
// lanes of the warp.
template <class Hit, class Pair>
__device__ void warp_sweep(int n_rows, int* queue, Hit hit, Pair pair) {
  const int lane = threadIdx.x & 31;
  int qn = 0;
  for (int base = 0; base < n_rows; base += 32) {
    const int q = base + lane;
    const bool h = q < n_rows && hit(q);
    const unsigned m = __ballot_sync(kFull, h);
    if (h) queue[qn + __popc(m & ((1u << lane) - 1u))] = q;
    qn += __popc(m);
    __syncwarp();
    if (qn >= 32) {
      pair(queue[lane]);
      qn -= 32;
      __syncwarp();
      if (lane < qn) queue[lane] = queue[32 + lane];
      __syncwarp();
    }
  }
  if (lane < qn) pair(queue[lane]);
  __syncwarp();
}

// One warp's sweep of its i rows i = first, first + stride, ... < end (staged
// indices) over the n_rows staged rows, with one hit queue kept across the
// rows: hit(i, q) is the cheap test, pair(i, q) the math of a hit.  The
// queue holds the (i, q) hits in the order (i, then staged order) and runs
// them 32 at a time, one per lane, whenever 32 are ready; the last fewer
// than 32 run on the first lanes.  For outputs summed over every pair (no
// per-row output).  Staged indices are below 2^16 (27 cap rows fit in 227
// KB only for cap < 540).  Called by all 32 lanes of the warp.
template <class Hit, class Pair>
__device__ void warp_sweep_rows(int first, int end, int stride, int n_rows,
                                int* queue, Hit hit, Pair pair) {
  const int lane = threadIdx.x & 31;
  int qn = 0;
  for (int i = first; i < end; i += stride) {
    for (int base = 0; base < n_rows; base += 32) {
      const int q = base + lane;
      const bool h = q < n_rows && hit(i, q);
      const unsigned m = __ballot_sync(kFull, h);
      if (h) queue[qn + __popc(m & ((1u << lane) - 1u))] = (i << 16) | q;
      qn += __popc(m);
      __syncwarp();
      if (qn >= 32) {
        const int e = queue[lane];
        pair(e >> 16, e & 0xffff);
        qn -= 32;
        __syncwarp();
        if (lane < qn) queue[lane] = queue[32 + lane];
        __syncwarp();
      }
    }
  }
  if (lane < qn) {
    const int e = queue[lane];
    pair(e >> 16, e & 0xffff);
  }
  __syncwarp();
}

// The code a launch returns when a block's shared memory does not fit.
constexpr int kSmemTooLarge = -2;

// Host side: lets `kernel` take `dynamic` bytes of dynamic shared memory
// beside its `fixed` bytes of static shared memory.  Past the 48 KB a
// block gets without opting in, sets the opt-in attribute.  Returns 0, a
// CUDA error, or kSmemTooLarge past the card's opt-in limit.
template <class Kernel>
int request_smem(Kernel kernel, size_t dynamic, size_t fixed) {
  if (dynamic + fixed <= 48 * 1024) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dynamic + fixed > static_cast<size_t>(optin)) return kSmemTooLarge;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dynamic)));
}

// Sum over the warp by a shuffle tree; the result is lane 0's.
__device__ inline float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

}  // namespace cell_stage
