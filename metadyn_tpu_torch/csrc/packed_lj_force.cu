// Lennard-Jones pair force over the cell-major slot layout (sentinel layout).
//
// Replaces the TPU kernel `packed_lj_force_pallas2` in
// metadyn_tpu/ops/packed_pallas2.py, variant (a): uniform sigma and epsilon,
// vacant slots parked at the coordinate sentinel VACANT_X (1e7) and culled by
// the r^2 tests alone, orthorhombic box.
//
// Layout (ops/packed.py): positions are a (3, Npad) f32 array, slot =
// rank * C + cell, cell = (ix * cy + iy) * cz + iz.  A cell's partners are the
// `cap` rows of each of the 27 neighbour cells; a neighbour that wraps past a
// box face is seen at x_j + s * L with s in {-1, 0, 1}.
//
// What bounds it on Hopper: not device memory.  The whole position array is
// 3 * Npad * 4 bytes (1.3 MB at 62.5k particles, cap 40), which stays resident
// in the 50 MB L2.  The cost is the partner-coordinate reads from L1/L2
// (27 * cap rows of 12 bytes per i slot) and the pair arithmetic.
//
// Design: one thread per i slot sweeps all 27 * cap partners.  No Newton
// halving, so no thread writes another slot's force: no atomics, no rollback
// buffer, and a deterministic result, at twice the pair evaluations of the
// halved TPU kernel.  The threads of a warp hold consecutive cells of one
// rank, so for a given (offset, row) their partner reads are consecutive
// addresses and coalesce.  The TPU kernel's rolled partner stacks, 128-lane
// padding and (1, 128) scalar rows exist for its VMEM layout and are not
// carried over: the kernel indexes the neighbour cell directly.
//
// Energy and diagonal virial are 1/2 of the sums over ordered pairs.  Each
// thread sums in registers, the block reduces in shared memory into one row
// of a (n_blocks, 4) partials buffer that every block writes in full, and a
// second one-block kernel sums the rows in a fixed order (in double).  With
// WithEnergy = false none of this is compiled in.
//
// Every output element is written: vacant slots get f = 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kVacantThr = 1.0e6f;  // ops/packed.py VACANT_THR

struct Params {
  int n_pad;
  int cap;
  int cx, cy, cz;
  float Lx, Ly, Lz;
  float rc2;      // r_cut^2
  float sig2;     // sigma^2
  float eps4;     // 4 * epsilon
  float e_shift;  // 4 eps ((sigma/rc)^12 - (sigma/rc)^6), or 0 without shift
};

// Neighbour index along one axis and the Cartesian periodic shift that goes
// with it: s = floor((i + o) / c) in {-1, 0, 1}.
__device__ __forceinline__ int wrap_axis(int i, int o, int c, float L,
                                         float* shift) {
  int j = i + o;
  *shift = 0.0f;
  if (j < 0) {
    j += c;
    *shift = -L;
  } else if (j >= c) {
    j -= c;
    *shift = L;
  }
  return j;
}

template <bool WithEnergy>
__global__ void __launch_bounds__(kThreads)
lj_force_kernel(const float* __restrict__ r, float* __restrict__ f,
                float* __restrict__ partials, Params p) {
  const int C = p.cx * p.cy * p.cz;
  const int n_pad = p.n_pad;
  const float* __restrict__ rx = r;
  const float* __restrict__ ry = r + n_pad;
  const float* __restrict__ rz = r + 2 * n_pad;
  const int s = blockIdx.x * kThreads + threadIdx.x;

  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  float e = 0.0f, wx = 0.0f, wy = 0.0f, wz = 0.0f;
  if (s < n_pad) {
    const float xi = rx[s];
    const float yi = ry[s];
    const float zi = rz[s];
    // A vacant i slot sits at VACANT_X and has no force.  Vacant partners
    // need no test: they are ~1e7 away, so r^2 >= rc^2 culls them.
    if (xi < kVacantThr) {
      const int cell = s % C;
      const int iz = cell % p.cz;
      const int iy = (cell / p.cz) % p.cy;
      const int ix = cell / (p.cy * p.cz);
      for (int ox = -1; ox <= 1; ++ox) {
        float sx;
        const int jx = wrap_axis(ix, ox, p.cx, p.Lx, &sx);
        for (int oy = -1; oy <= 1; ++oy) {
          float sy;
          const int jy = wrap_axis(iy, oy, p.cy, p.Ly, &sy);
          for (int oz = -1; oz <= 1; ++oz) {
            float sz;
            const int jz = wrap_axis(iz, oz, p.cz, p.Lz, &sz);
            const int jcell = (jx * p.cy + jy) * p.cz + jz;
            for (int k = 0; k < p.cap; ++k) {
              const int j = k * C + jcell;
              const float dx = xi - (rx[j] + sx);
              const float dy = yi - (ry[j] + sy);
              const float dz = zi - (rz[j] + sz);
              const float r2 = dx * dx + dy * dy + dz * dz;
              // r2 > 1e-12 drops the slot itself (r2 == 0 exactly)
              if (r2 < p.rc2 && r2 > 1.0e-12f) {
                const float inv = 1.0f / r2;
                const float s2 = p.sig2 * inv;
                const float s6 = s2 * s2 * s2;
                const float s12 = s6 * s6;
                const float coef = p.eps4 * (12.0f * s12 - 6.0f * s6) * inv;
                fx += coef * dx;
                fy += coef * dy;
                fz += coef * dz;
                if (WithEnergy) {
                  e += p.eps4 * (s12 - s6) - p.e_shift;
                  wx += coef * dx * dx;
                  wy += coef * dy * dy;
                  wz += coef * dz * dz;
                }
              }
            }
          }
        }
      }
    }
    f[s] = fx;
    f[n_pad + s] = fy;
    f[2 * n_pad + s] = fz;
  }

  if (WithEnergy) {
    __shared__ float sh[4][kThreads];
    sh[0][threadIdx.x] = e;
    sh[1][threadIdx.x] = wx;
    sh[2][threadIdx.x] = wy;
    sh[3][threadIdx.x] = wz;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) {
        for (int q = 0; q < 4; ++q) {
          sh[q][threadIdx.x] += sh[q][threadIdx.x + half];
        }
      }
      __syncthreads();
    }
    if (threadIdx.x < 4) {
      partials[blockIdx.x * 4 + threadIdx.x] = sh[threadIdx.x][0];
    }
  }
}

// One block: out[q] = 1/2 * sum_b partials[b, q], q = (PE, Wxx, Wyy, Wzz).
// Thread t sums rows t, t + kThreads, ... in order, then a tree in shared
// memory: the same order on every call.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                       float* __restrict__ out) {
  __shared__ double sh[4][kThreads];
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    for (int q = 0; q < 4; ++q) acc[q] += partials[b * 4 + q];
  }
  for (int q = 0; q < 4; ++q) sh[q][threadIdx.x] = acc[q];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      for (int q = 0; q < 4; ++q) {
        sh[q][threadIdx.x] += sh[q][threadIdx.x + half];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < 4) out[threadIdx.x] = static_cast<float>(0.5 * sh[threadIdx.x][0]);
}

}  // namespace

extern "C" {

// Threads per block of the force kernel: the partials buffer has
// ceil(n_pad / threads) rows.
int packed_lj_force_threads() { return kThreads; }

// r: (3, n_pad) f32; f: (3, n_pad) f32 out.  With with_energy != 0,
// partials: (ceil(n_pad / threads), 4) f32 scratch and out: (4,) f32 =
// (PE, Wxx, Wyy, Wzz); otherwise both may be null.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int packed_lj_force(const float* r, float* f, float* partials, float* out,
                    int n_pad, int cap, int cx, int cy, int cz,
                    float Lx, float Ly, float Lz, float rc2, float sig2,
                    float eps4, float e_shift, int with_energy,
                    void* stream) {
  Params p{n_pad, cap, cx, cy, cz, Lx, Ly, Lz, rc2, sig2, eps4, e_shift};
  const int n_blocks = (n_pad + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_energy) {
    lj_force_kernel<true><<<n_blocks, kThreads, 0, st>>>(r, f, partials, p);
    reduce_partials_kernel<<<1, kThreads, 0, st>>>(partials, n_blocks, out);
  } else {
    lj_force_kernel<false><<<n_blocks, kThreads, 0, st>>>(r, f, nullptr, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
