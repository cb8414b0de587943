// The EPaxos execution block around the closure, for Hopper (sm_90a).
//
// The EPaxos step (paxi_tpu_torch/protocols/epaxos/sim.py) orders each
// replica's committed window graph: it builds the adjacency A from the
// deps plane, closes it with the closure kernel (csrc/closure.cu) and
// reads the closed cube back into per-instance masks.  The JAX package
// leaves both passes to XLA (paxi_tpu/protocols/epaxos/sim.py, no Pallas
// kernel), so these two kernels replace no TPU kernel: in eager PyTorch the
// passes went one bool byte a thread through broadcasts, a per-owner
// torch.cat, two 6.4 GB movedim copies and three strided `any`
// reductions, about 70 GB a round at 500k graphs of 80 nodes.  Their plain
// PyTorch versions, which define the semantics, are dep_graph_plain and
// exec_masks_plain in paxi_tpu_torch/ops/exec_graph.py, which binds these
// entry points through ctypes, checks every argument and picks the tiling.
//
// Layouts (bool as one byte 0/1, every tensor contiguous; graph b = r*G + g
// of replica r and group g; a node k = owner*I + instance):
//   deps (R, NN, R, G) int32 absolute instance ids, -1 for none; base (R,
//   R, G) int32 window bases; committed, fblock, executed, exec_ok, needed
//   (R, NN, G); adj and reach (R*G, NN, NN), the closure's own input and
//   output, so no copy sits between the kernels.
//
// dep_graph_kernel.  A dep of k on owner q below q's window gives no edge,
// inside it an edge k -> q*I + (dep - base) when k is committed, above it
// sets fblock[k].  A block takes a tile of up to `tg` consecutive groups of
// one replica: their graphs are one contiguous run of tg*NN*NN output
// bytes, built in shared memory (zeroed, then at most R bytes set a row)
// and written in whole 16-byte units, the ragged ends a byte at a time;
// a graph wider than the buffer goes out in chunks of the buffer.
// Threads walk a chunk's rows group-fastest, so the deps, base, committed
// and fblock planes move in runs of consecutive groups.
//   Bound: bytes.  4*R*NN*R*G + 4*R*R*G + R*NN*G read, R*G*NN*NN + R*NN*G
//   written: 4.09 GB at 5 x 16 x 100k groups, 1.22 ms at 3.35 TB/s.
//
// exec_masks_kernel.  With reach the closed cube, row bits R_k (reach[k,
// .]), column bits C_k (reach[., k]) and the plane bits Cm, F, E of a graph:
//   blocked[k] = any(R_k & (~Cm | F)) | F[k]
//   ready[k]   = Cm[k] & ~blocked[k] & ~E[k]
//   exec_ok[k] = ready[k] & ~any(R_k & ~C_k & ~E)
//   needed[k]  = ~Cm[k] & any(C_k & Cm & ~E)
// (needed without the step's new executions: see exec_masks_plain).  A
// block takes a tile of consecutive groups of one replica as above and
// turns each graph's bytes into bits once.  A row word comes from eight
// 4-byte loads, each four bytes 0/1 made four bits by one multiply (rows on
// 4-byte boundaries; else a warp's ballot over 32 consecutive bytes).  A
// column word comes from the row words: a warp transposes each 32 x 32
// block of them with five rounds of shuffles, so the transpose costs no
// second read of the bytes (a chunk that holds only some of a row's words
// takes a thread's 32 rows of one column, lanes on consecutive columns).
// The tile's bytes are staged in shared memory with 16-byte loads while a
// tile of several groups fits (80 nodes: four), else read where they lie
// (the CLI's 320 and 384 nodes: more blocks an SM, faster on the card); the
// bits of a chunk of words (every word of a row while they fit) sit in
// shared memory, each node's three OR-reductions accumulate over the
// chunks, and the masks go out group-fastest.
//   Bound: bytes.  R*G*NN*NN + 3*R*NN*G read, 2*R*NN*G written: 3.40 GB at
//   5 x 16 x 100k groups, 1.02 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t tile_groups(int64_t g, int tg) {
  return (g + tg - 1) / tg;
}

// Bytes 0/1 of x (torch bool storage) as four bits, byte i to bit i.
__device__ __forceinline__ uint32_t nib_of(uint32_t x) {
  return (x * 0x01020408u) >> 24;
}

// A 32 x 32 bit block across a warp, lane r holding row r (bit c of it
// column c), transposed: lane c then holds column c (bit r of it row r).
// Level j swaps the off-diagonal j x j blocks of every 2j x 2j block.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t keep[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                            0x33333333u, 0x55555555u};
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int j = 16 >> l;
    const uint32_t m = keep[l];
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~m) | ((y & ~m) >> j) : (x & m) | ((y & m) << j);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
dep_graph_kernel(const int32_t* __restrict__ deps,
                 const int32_t* __restrict__ base,
                 const uint8_t* __restrict__ committed,
                 uint8_t* __restrict__ adj, uint8_t* __restrict__ fblock,
                 int R, int I, int64_t G, int tg_max, int chunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int NN = R * I;
  const int64_t nn2 = (int64_t)NN * NN;
  const int64_t per_r = tile_groups(G, tg_max);
  const int r = (int)(blockIdx.x / per_r);
  const int64_t g0 = (blockIdx.x % per_r) * tg_max;
  const int tg = (int)(G - g0 < tg_max ? G - g0 : tg_max);
  // the tile's output bytes [t0, t1), its chunks from t0's 16-byte unit
  const uintptr_t t0 = (uintptr_t)(adj + ((int64_t)r * G + g0) * nn2);
  const uintptr_t t1 = t0 + (uintptr_t)(tg * nn2);
  uint4* s4 = reinterpret_cast<uint4*>(smem);
  for (uintptr_t c = t0 & ~(uintptr_t)15; c < t1; c += chunk) {
    const uintptr_t lo = c > t0 ? c : t0;
    const uintptr_t hi = c + chunk < t1 ? c + chunk : t1;
    for (int u = threadIdx.x; u < chunk / 16; u += blockDim.x)
      s4[u] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    // the tile's rows (gl * NN + i) with a byte in [lo, hi)
    const int64_t row_lo = (int64_t)(lo - t0) / NN;
    const int64_t row_hi = (int64_t)(hi - 1 - t0) / NN;
    const int gl_lo = (int)(row_lo / NN), gl_hi = (int)(row_hi / NN);
    const int i_lo = gl_lo == gl_hi ? (int)(row_lo % NN) : 0;
    const int i_hi = gl_lo == gl_hi ? (int)(row_hi % NN) : NN - 1;
    const int ngl = gl_hi - gl_lo + 1, ni = i_hi - i_lo + 1;
    for (int t = threadIdx.x; t < ngl * ni; t += blockDim.x) {
      const int gl = gl_lo + t % ngl, i = i_lo + t / ngl;
      const int64_t row = (int64_t)gl * NN + i;
      if (row < row_lo || row > row_hi) continue;
      const int64_t g = g0 + gl;
      const int64_t at = ((int64_t)r * NN + i) * G + g;
      const bool src = committed[at] != 0;
      const uintptr_t row_at = t0 + (uintptr_t)(row * NN);
      bool fb = false;
#pragma unroll 4
      for (int q = 0; q < R; ++q) {
        const int32_t tgt = deps[(((int64_t)r * NN + i) * R + q) * G + g];
        if (tgt < 0) continue;
        // int32 wrap-around, as the plain version's subtraction
        const int32_t b = base[((int64_t)r * R + q) * G + g];
        const int32_t rel = (int32_t)((uint32_t)tgt - (uint32_t)b);
        if (rel >= I) {
          fb = true;
        } else if (rel >= 0 && src) {
          const uintptr_t a = row_at + (uintptr_t)(q * I + rel);
          if (a >= lo && a < hi) smem[a - c] = 1;
        }
      }
      if (row_at >= lo) fblock[at] = fb;     // once: the chunk it starts in
    }
    __syncthreads();
    for (uintptr_t u = c + 16 * (uintptr_t)threadIdx.x; u < hi;
         u += 16 * (uintptr_t)blockDim.x) {
      if (u >= lo && u + 16 <= hi) {
        *reinterpret_cast<uint4*>(u) = s4[(u - c) / 16];
      } else {
        for (int k = 0; k < 16; ++k)
          if (u + k >= lo && u + k < hi)
            *reinterpret_cast<uint8_t*>(u + k) = smem[u + k - c];
      }
    }
    __syncthreads();                       // the next chunk zeroes the buffer
  }
}

// Shared memory of exec_masks_kernel, in this order: the staged graph
// bytes (16-byte units, when staged), row bits and column bits (tg * NN
// nodes of `ws` words), the plane bits (tg * 3 * W words: Cm, F, E), the
// plane bytes and the accumulators (tg * NN bytes each: committed, fblock,
// executed, then blocked, cross-SCC, needed).
__host__ __device__ __forceinline__ int64_t stage_units(int64_t nn2, int tg) {
  return (tg * nn2 + 15) / 16 + 1;
}

__global__ void __launch_bounds__(kThreads)
exec_masks_kernel(const uint8_t* __restrict__ reach,
                  const uint8_t* __restrict__ committed,
                  const uint8_t* __restrict__ fblock,
                  const uint8_t* __restrict__ executed,
                  uint8_t* __restrict__ exec_ok, uint8_t* __restrict__ needed,
                  int NN, int64_t G, int tg_max, int staged, int wc, int ws) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W = (NN + 31) / 32;
  const int64_t nn2 = (int64_t)NN * NN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t per_r = tile_groups(G, tg_max);
  const int r = (int)(blockIdx.x / per_r);
  const int64_t g0 = (blockIdx.x % per_r) * tg_max;
  const int tg = (int)(G - g0 < tg_max ? G - g0 : tg_max);
  const uint8_t* graphs = reach + ((int64_t)r * G + g0) * nn2;

  uint8_t* p = smem;
  uint4* stage = reinterpret_cast<uint4*>(p);
  if (staged) p += 16 * stage_units(nn2, tg_max);
  uint32_t* rowbits = reinterpret_cast<uint32_t*>(p);
  p += 4 * (int64_t)tg_max * NN * ws;
  uint32_t* colbits = reinterpret_cast<uint32_t*>(p);
  p += 4 * (int64_t)tg_max * NN * ws;
  uint32_t* vbits = reinterpret_cast<uint32_t*>(p);
  p += 4 * (int64_t)tg_max * 3 * W;
  uint8_t* pcm = p;
  uint8_t* pfb = pcm + tg_max * NN;
  uint8_t* pex = pfb + tg_max * NN;
  uint8_t* acc_blk = pex + tg_max * NN;
  uint8_t* acc_cross = acc_blk + tg_max * NN;
  uint8_t* acc_need = acc_cross + tg_max * NN;

  for (int t = threadIdx.x; t < NN * tg; t += blockDim.x) {
    const int gl = t % tg, i = t / tg, k = gl * NN + i;
    const int64_t at = ((int64_t)r * NN + i) * G + g0 + gl;
    pcm[k] = committed[at] != 0;
    pfb[k] = fblock[at] != 0;
    pex[k] = executed[at] != 0;
    acc_blk[k] = acc_cross[k] = acc_need[k] = 0;
  }
  const uint8_t* src = graphs;
  if (staged) {
    const uintptr_t a0 = (uintptr_t)graphs;
    const uint4* from = reinterpret_cast<const uint4*>(a0 & ~(uintptr_t)15);
    const int64_t units = ((int64_t)(a0 & 15) + tg * nn2 + 15) / 16;
    for (int64_t u = threadIdx.x; u < units; u += blockDim.x)
      stage[u] = __ldg(from + u);
    src = reinterpret_cast<const uint8_t*>(stage) + (a0 & 15);
  }
  __syncthreads();
  const bool rows4 = NN % 4 == 0 && ((uintptr_t)src & 3) == 0;
  for (int t = warp; t < tg * W; t += nwarps) {
    const int gl = t / W, w = t % W, k = 32 * w + lane;
    const bool in = k < NN;
    const uint32_t cm = __ballot_sync(kFull, in && pcm[gl * NN + k]);
    const uint32_t fb = __ballot_sync(kFull, in && pfb[gl * NN + k]);
    const uint32_t ex = __ballot_sync(kFull, in && pex[gl * NN + k]);
    if (lane == 0) {
      vbits[(gl * 3 + 0) * W + w] = cm;
      vbits[(gl * 3 + 1) * W + w] = fb;
      vbits[(gl * 3 + 2) * W + w] = ex;
    }
  }
  for (int w0 = 0; w0 < W; w0 += wc) {
    const int nw = W - w0 < wc ? W - w0 : wc;
    // row words (node k = gl * NN + i of the tile starts at byte k * NN):
    // rows on 4-byte boundaries, a thread's word from eight 4-byte loads;
    // else a warp's ballot over 32 consecutive bytes
    if (rows4) {
      for (int k = threadIdx.x; k < tg * NN; k += blockDim.x) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            src + (int64_t)k * NN) + 8 * w0;
        for (int wl = 0; wl < nw; ++wl) {
          const int nq = (NN - 32 * (w0 + wl)) / 4;
          uint32_t word = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (q < nq) word |= nib_of(row[8 * wl + q]) << (4 * q);
          rowbits[k * ws + wl] = word;
        }
      }
    } else {
      for (int k = warp; k < tg * NN; k += nwarps) {
        const uint8_t* row = src + (int64_t)k * NN + 32 * w0 + lane;
        for (int wl = 0; wl < nw; ++wl) {
          const bool bit = 32 * (w0 + wl) + lane < NN && row[32 * wl] != 0;
          const uint32_t word = __ballot_sync(kFull, bit);
          if (lane == 0) rowbits[k * ws + wl] = word;
        }
      }
    }
    __syncthreads();
    if (nw == W) {
      // column words: every row word is here, so each 32 x 32 block of
      // them is transposed in a warp
      for (int t = warp; t < tg * W * W; t += nwarps) {
        const int gl = t / (W * W), wr = t / W % W, wb = t % W;
        const int row = 32 * wr + lane, c = 32 * wb + lane;
        const uint32_t x = transpose32(
            row < NN ? rowbits[(gl * NN + row) * ws + wb] : 0u, lane);
        if (c < NN) colbits[(gl * NN + c) * ws + wr] = x;
      }
    } else {
      // column words of a chunk: a thread's 32 rows of one column, lanes
      // on consecutive columns
      for (int k = threadIdx.x; k < tg * NN; k += blockDim.x) {
        const int c = k % NN;
        const uint8_t* col = src + (int64_t)(k - c) * NN + c
                             + (int64_t)32 * w0 * NN;
        for (int wl = 0; wl < nw; ++wl, col += (int64_t)32 * NN) {
          const int nr = NN - 32 * (w0 + wl) < 32 ? NN - 32 * (w0 + wl) : 32;
          uint32_t word = 0;
#pragma unroll 8
          for (int s = 0; s < nr; ++s)
            word |= (uint32_t)(col[s * NN] != 0) << s;
          colbits[k * ws + wl] = word;
        }
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < tg * NN; t += blockDim.x) {
      const uint32_t* v = vbits + (t / NN) * 3 * W;
      uint32_t blk = 0, cross = 0, need = 0;
      for (int wl = 0; wl < nw; ++wl) {
        const int w = w0 + wl;
        const uint32_t rb = rowbits[t * ws + wl], cb = colbits[t * ws + wl];
        const uint32_t cm = v[w], fb = v[W + w], ex = v[2 * W + w];
        blk |= rb & (~cm | fb);
        cross |= rb & ~cb & ~ex;
        need |= cb & cm & ~ex;
      }
      acc_blk[t] |= blk != 0;
      acc_cross[t] |= cross != 0;
      acc_need[t] |= need != 0;
    }
    __syncthreads();                       // the next chunk's bits overwrite
  }
  for (int t = threadIdx.x; t < NN * tg; t += blockDim.x) {
    const int gl = t % tg, i = t / tg, k = gl * NN + i;
    const int64_t at = ((int64_t)r * NN + i) * G + g0 + gl;
    const bool cm = pcm[k], ex = pex[k];
    const bool blocked = acc_blk[k] || pfb[k];
    const bool ready = cm && !blocked && !ex;
    exec_ok[at] = ready && !acc_cross[k];
    needed[at] = !cm && acc_need[k];
  }
}

// Lets `kern` take `shmem` bytes of dynamic shared memory; refuses a grid
// of more blocks than its x dimension holds.
template <typename K>
int prepare(K kern, int64_t blocks, int shmem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (e != cudaSuccess) return (int)e;
  return blocks <= 0x7fffffff ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" int paxi_dep_graph(const int32_t* deps, const int32_t* base,
                              const uint8_t* committed, uint8_t* adj,
                              uint8_t* fblock, int r, int i, int64_t g,
                              int tg, int chunk, void* stream) {
  if (r <= 0 || i <= 0 || g <= 0) return 0;
  if (tg < 1 || chunk < 16 || chunk % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)r * ((g + tg - 1) / tg);
  cudaStream_t s = (cudaStream_t)stream;
  const int err = prepare(dep_graph_kernel, blocks, chunk);
  if (err != 0) return err;
  dep_graph_kernel<<<(unsigned)blocks, kThreads, chunk, s>>>(
      deps, base, committed, adj, fblock, r, i, g, tg, chunk);
  return (int)cudaGetLastError();
}

extern "C" int paxi_exec_masks(const uint8_t* reach, const uint8_t* committed,
                               const uint8_t* fblock, const uint8_t* executed,
                               uint8_t* exec_ok, uint8_t* needed, int r,
                               int nn, int64_t g, int tg, int staged, int wc,
                               int ws, int shmem, void* stream) {
  if (r <= 0 || nn <= 0 || g <= 0) return 0;
  const int w = (nn + 31) / 32;
  const int64_t nn2 = (int64_t)nn * nn;
  const int64_t need = (staged ? 16 * stage_units(nn2, tg) : 0)
                       + 8 * (int64_t)tg * nn * ws + 12 * (int64_t)tg * w
                       + 6 * (int64_t)tg * nn;
  if (tg < 1 || wc < 1 || wc > w || ws < wc || shmem < need)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)r * ((g + tg - 1) / tg);
  cudaStream_t s = (cudaStream_t)stream;
  const int err = prepare(exec_masks_kernel, blocks, shmem);
  if (err != 0) return err;
  exec_masks_kernel<<<(unsigned)blocks, kThreads, shmem, s>>>(
      reach, committed, fblock, executed, exec_ok, needed, nn, g, tg, staged,
      wc, ws);
  return (int)cudaGetLastError();
}
