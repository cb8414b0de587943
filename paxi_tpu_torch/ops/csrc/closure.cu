// Boolean transitive closure of a batch of graphs, for Hopper (sm_90a).
//
// Replaces the TPU kernel paxi_tpu/ops/closure.py closure_pallas (body
// _closure_kernel): n_iter squarings r <- r | r.r of each bool[N, N]
// adjacency matrix, with no implicit identity (a node reaches itself only
// through a cycle).  The TPU kernel squares a float32 copy padded to a
// multiple of 128 on the matrix unit, at any N.  Here the same relation A+
// (every path of length >= 1) comes from Warshall's algorithm on bit rows,
// with nothing padded and no float involved, so the result is exact by
// construction, at any N as well.  The plain PyTorch version is
// closure_plain in paxi_tpu_torch/ops/closure.py, which binds this entry
// point through ctypes, checks every argument and routes the launch
// (closure_route): a warp a graph up to kWarpMaxN nodes, a block a graph
// above.
//
// Bound on an H100: the larger of bytes and word operations.  The kernel
// must read B*N*N bytes and write as many (6.4 GB at 500k graphs of 80
// nodes: 1.91 ms at 3.35 TB/s).  Warshall needs at most N*N*ceil(N/32) word
// and-ors a graph (each of N steps ORs row k into every row that has bit
// k); at the int32 rate (16.7 T a second) that is 0.57 ms at 500k x 80,
// 0.63 ms at 20k x 256, 0.326 ms at 3,072 x 384 (bytes: 0.270 ms) and 0.628
// ms at 10,240 x 320 (bytes: 0.626 ms).  Tensor cores do not pay: an int8
// wgmma squaring needs log2(N) * 2 N^3 operations, about 3.1 T at 3,072 x
// 384, ~1.6 ms at the card's dense int8 rate, five times Warshall's bound.
//
// The warp kernel (N <= kWarpMaxN).  One warp per graph; lane l holds rows
// l, l+32, ... as W = ceil(N/32) uint32 words in registers (slot s holds
// row 32s + l).
//   in:   the 32 rows of slot s are one contiguous run of 32N bytes (a
//         "chunk").  Lane 0 of each warp stages its chunks in shared
//         memory with 1-D bulk copies (cp.async.bulk, completed on an
//         mbarrier), two stages a warp, so the next chunk (and the next
//         graph's first ones) arrive while the warp works.  A bulk copy
//         wants 16-byte aligned addresses and sizes, so it copies the
//         16-byte aligned window around the chunk (at most 15 bytes more on
//         either side, in the same 16-byte granules as the chunk's own
//         bytes) and the chunk is read at its offset in the window: any
//         byte offset of the input (N = 130 graphs, sliced inputs) works.
//   step: for k = 0..N-1 row k is broadcast from lane k % 32 (slot k / 32,
//         a compile-time index) with W shuffles, and each lane ORs it into
//         every row of its own that has bit k, branch-free (acc |= rowk &
//         mask).  Row k does not change during step k, so the in-place
//         update is exact; no barrier and no shared memory are touched.
//   out:  each slot's rows are expanded back to bytes in a per-warp shared
//         buffer at the output's offset modulo 16, then written with
//         16-byte streaming stores and byte stores at the ragged ends.
// Bits and bytes move between registers and the staged rows in one of two
// ways, chosen per launch:
//   row vectors (N = 16 mod 32 and both tensors 16-byte aligned; N = 80,
//         the EPaxos path of five replicas): every row starts 16-byte
//         aligned, and rows an odd multiple of 16 bytes apart put 8 lanes'
//         16-byte accesses in distinct banks.  A lane loads its own row 16
//         bytes at a time and turns each 32-bit word of bytes 0/1 into four
//         bits with one multiply ((x * 0x01020408) >> 24), and back ((nib *
//         0x00204081) & 0x01010101): 15 shared loads and 15 stores a lane
//         for a graph of 80 nodes.
//   general: a row's word v is one __ballot_sync over 32 consecutive
//         bytes, and goes back as a shuffle of the word and one byte a lane
//         (N x W of each a graph: the shared-memory and shuffle pipe, not
//         the bytes, then bounds the kernel).
// The grid is persistent: as many blocks as fit on the card, each warp
// walks graphs g, g + warps, ...  No integer division per byte anywhere.
//
// The block kernel (N > kWarpMaxN, and N = 224 or 256 on aligned tensors,
// where it ran faster than the warp kernel's general path: the wrapper's
// BLOCK_FROM_N, scripts/torch_closure_routes.py).  A warp
// can no longer hold a graph's rows (W x W words a lane: 144 at N = 384),
// so a block of T threads takes a graph, its bit rows stored once: 32W rows
// (the last 32-row panel padded with zero rows) of wp words, beside 8
// tables of 16 rows, in shared memory while they fit in the 227 KB of a
// block (N up to 1,184), else in a global scratch buffer that the
// wrapper allocates (a block an SM, each with its own rows; they stay in
// the 50 MB L2 at the widths tested).  Warshall runs 32 steps at a time,
// blocked by panels: steps k = 32kb..32kb+31 go through panel kb (rows
// 32kb..).
//   D*:   lane p of every warp loads panel row p's word kb (its edges inside
//         the panel) and closes the 32 x 32 bit matrix in registers, 32
//         shuffle steps: D*[p] = panel nodes p reaches through the panel.
//   panel: P[p] = row p | OR of the rows b in D*[p] (all at the panel's
//         start): p's reach through every node below 32(kb + 1).  The
//         warps share the 4-word chunks of the 32 rows (32 and-ors a word,
//         masks from D*[p]); P[p] becomes entry 1 << (p % 4) of table p / 4.
//         One barrier.
//   tables: entry e of table t = OR of P[4t + j] over the bits j of e
//         (entry 0 stays zero).  One barrier.
//   rows: every row i then ORs in P[b] for each bit b of its own word kb,
//         read at the panel's start: row i's reach through every node below
//         32(kb + 1) (a path's first panel node b is in word kb, and P[b]
//         holds the rest).  The 8 nibbles of word kb pick one entry of each
//         table, so a lane ORs 8 rows into its own, 4 words at a time (the
//         method of Four Russians): 8 16-byte loads from shared memory and
//         32 ORs a chunk, where 32 masked panel rows would take 32 loads and
//         128 and-ors, and shared memory, which delivers 128 bytes a clock
//         (a 16-byte load is 512 bytes to a warp), would bound the kernel.
//         A warp whose rows all have word kb zero skips the panel.  One
//         barrier.
//   Rows change in place: no row is read by another thread between the
//   barriers of a panel, so the result is Warshall's exactly.  Three
//   barriers a panel, 3W a graph, against N for a barrier a step.
//   in/out: a warp takes 4 rows at a time, their loads issued together
//         (one at a time, the graph's bytes arrived too slowly to keep up).
//         With N = 0 mod 16 and 16-byte aligned tensors (the EPaxos widths:
//         320 = 5 x 64, 384 = 3 x 128) lane j turns bytes [16j, 16j + 16)
//         into 16 bits with the multiplies above and lanes 2m and 2m + 1
//         join into word m, and back with 16-byte streaming stores; else
//         word v is a ballot over its 32 bytes and goes back a byte a lane.
// The row stride in shared memory has an odd count of 16-byte units, so a
// lane-per-row 16-byte access, and a table lookup of 8 lanes, meets few
// bank conflicts.  The grid is persistent in shared memory (as many blocks
// as fit); in global memory it is what the wrapper allocated scratch for.
// A block moves its graph's bytes and closes its panels one after the
// other; a second set of rows, written and read a slice a panel while the
// other closes, did not pay on the card (fewer blocks fit), so each block
// has one set.  The wrapper gives a block about three rows a thread.
// Its work a graph: 8 N W^2 ORs for the rows, 1,024 W^2 and-ors for the
// panels and 224 W^2 ORs for the tables, a third of Warshall's N^2 W at
// N = 384 (which the int32 bound above counts), so the bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpMaxN = 256;            // widest graph of the warp kernel
constexpr int kWarps = 4;                 // warps (graphs in flight) a block
constexpr int kStages = 2;                // staged chunks a warp
constexpr int kBarBytes = 128;            // the blocks' mbarriers, padded
constexpr int kBlockMaxThreads = 512;     // the block kernel's threads at most
constexpr int kInRows = 4;                // rows a warp loads at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Bytes a stage (and the output buffer) take for graphs of n nodes: a
// chunk's 16-byte aligned window.
__host__ __device__ __forceinline__ int stage_bytes(int n) {
  return (32 * n + 32 + 15) & ~15;
}

// Bytes 0/1 of x (torch bool storage) as four bits, byte i to bit i.
__device__ __forceinline__ uint32_t nib_of(uint32_t x) {
  return (x * 0x01020408u) >> 24;
}

// The low four bits of x as four bytes 0/1, bit i to byte i.
__device__ __forceinline__ uint32_t bytes_of(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

// kRowVec: N = 16 mod 32 and 16-byte aligned tensors, so every staged row
// starts 16-byte aligned; a lane loads and stores its own rows 16 bytes at
// a time.
// The register cap: left to itself ptxas settles at 56-64 registers and
// spills in the W = 2..4 instances; 128 (168 for W = 8, whose rows alone
// take 64) keeps every instance free of spills (nvcc -Xptxas -v).
template <int W, bool kRowVec>
__global__ void __maxnreg__(W >= 8 ? 168 : 128)
closure_kernel(const uint8_t* adj, uint8_t* out, int64_t batch, int n) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t nn = (int64_t)n * n;
  const int chunk = 32 * n;
  const int sbytes = stage_bytes(n);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp * kStages;
  uint8_t* stage = smem + kBarBytes + warp * (kStages + 1) * sbytes;
  uint8_t* obuf = stage + kStages * sbytes;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int64_t g0 = (int64_t)blockIdx.x * kWarps + warp;
  // chunk q of this warp: graph g0 + (q / W) * warps, slot q % W
  auto fetch = [&](int64_t q) {
    const int64_t g = g0 + (q / W) * warps;
    if (g >= batch) return;                       // the same for the warp
    const int c = (int)(q % W);
    const uint8_t* src = adj + g * nn + (int64_t)c * chunk;
    const int nrows = min(32, n - 32 * c);
    uint64_t* b = &bar[q % kStages];
    uint8_t* dst = stage + (q % kStages) * sbytes;
    // the generic reads of this stage are done (__syncwarp before the call)
    fence_proxy_async();
    if (lane == 0) {
      const uintptr_t a0 = (uintptr_t)src & ~(uintptr_t)15;
      const uintptr_t a1 =
          ((uintptr_t)src + nrows * n + 15) & ~(uintptr_t)15;
      mbar_expect_tx(b, (unsigned)(a1 - a0));
      bulk_load(dst, (const void*)a0, (unsigned)(a1 - a0), b);
    }
  };

  int64_t q = 0;
  for (int s = 0; s < kStages; ++s) fetch(s);
  for (int64_t g = g0; g < batch; g += warps) {
    uint32_t rows[W][W];
    // in: bit rows from the staged bytes
#pragma unroll
    for (int s = 0; s < W; ++s) {
#pragma unroll
      for (int v = 0; v < W; ++v) rows[s][v] = 0u;
      const int st = (int)(q % kStages);
      mbar_wait(&bar[st], (unsigned)((q / kStages) & 1));
      const uint8_t* src = adj + g * nn + (int64_t)s * chunk;
      const uint8_t* buf = stage + st * sbytes + ((uintptr_t)src & 15);
      const int nrows = min(32, n - 32 * s);
      if (kRowVec) {
        // my own row: 16 bytes a load, four bits from each 32-bit word
        if (lane < nrows) {
          const uint4* row =
              reinterpret_cast<const uint4*>(buf + lane * n);
#pragma unroll
          for (int j = 0; j < 2 * W; ++j) {
            if (16 * j < n) {
              const uint4 b = row[j];
              const uint32_t bits = nib_of(b.x) | nib_of(b.y) << 4
                                    | nib_of(b.z) << 8 | nib_of(b.w) << 12;
              rows[s][j >> 1] |= bits << (16 * (j & 1));
            }
          }
        }
      } else {
        for (int L = 0; L < nrows; ++L) {
#pragma unroll
          for (int v = 0; v < W; ++v) {
            const int col = v * 32 + lane;
            const uint32_t w =
                __ballot_sync(kFull, col < n && buf[L * n + col]);
            if (lane == L) rows[s][v] = w;
          }
        }
      }
      __syncwarp();
      fetch(q + kStages);
      ++q;
    }

    // step: Warshall, k = 32 s + L
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const int kmax = min(32, n - 32 * s);
      for (int L = 0; L < kmax; ++L) {
        uint32_t rk[W];
#pragma unroll
        for (int v = 0; v < W; ++v) rk[v] = __shfl_sync(kFull, rows[s][v], L);
#pragma unroll
        for (int t = 0; t < W; ++t) {
          // all ones where bit k of row t is set
          const uint32_t m =
              (uint32_t)((int32_t)(rows[t][s] << (31 - L)) >> 31);
#pragma unroll
          for (int v = 0; v < W; ++v) rows[t][v] |= rk[v] & m;
        }
      }
    }

    // out: bytes of each slot's rows through the shared buffer
#pragma unroll
    for (int s = 0; s < W; ++s) {
      uint8_t* dst = out + g * nn + (int64_t)s * chunk;
      const int nrows = min(32, n - 32 * s);
      const int len = nrows * n;
      const int off = (int)((uintptr_t)dst & 15);
      uint8_t* ob = obuf + off;
      if (kRowVec) {
        // my own row: four bits to a 32-bit word of bytes, 16 bytes a store
        if (lane < nrows) {
          uint4* row = reinterpret_cast<uint4*>(ob + lane * n);
#pragma unroll
          for (int j = 0; j < 2 * W; ++j) {
            if (16 * j < n) {
              const uint32_t bits = rows[s][j >> 1] >> (16 * (j & 1));
              row[j] = make_uint4(bytes_of(bits), bytes_of(bits >> 4),
                                  bytes_of(bits >> 8), bytes_of(bits >> 12));
            }
          }
        }
      } else {
        for (int L = 0; L < nrows; ++L) {
#pragma unroll
          for (int v = 0; v < W; ++v) {
            const uint32_t w = __shfl_sync(kFull, rows[s][v], L);
            const int col = v * 32 + lane;
            if (col < n) ob[L * n + col] = (uint8_t)((w >> lane) & 1u);
          }
        }
      }
      // the chunk's bytes, contiguous in the buffer: 16-byte stores
      __syncwarp();
      const int head = min((16 - off) & 15, len);
      const int nvec = (len - head) >> 4;
      if (lane < head) dst[lane] = ob[lane];
      const uint4* sv = reinterpret_cast<const uint4*>(ob + head);
      uint4* dv = reinterpret_cast<uint4*>(dst + head);
      for (int i = lane; i < nvec; i += 32) __stcs(dv + i, sv[i]);
      const int t0 = head + (nvec << 4);
      if (lane < len - t0) dst[t0 + lane] = ob[t0 + lane];
      __syncwarp();
    }
  }
}

// ---- the block kernel: graphs above kWarpMaxN nodes ---------------------

// V consecutive words at p (16-byte aligned for V = 4, 8-byte for V = 2).
template <int V>
__device__ __forceinline__ void ld_words(uint32_t (&x)[V], const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}

template <int V>
__device__ __forceinline__ void st_words(uint32_t* p, const uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
  }
}

// m[b] is all ones where bit b of w is set.
__device__ __forceinline__ void masks_of(uint32_t (&m)[32], uint32_t w) {
#pragma unroll
  for (int b = 0; b < 32; ++b)
    m[b] = (uint32_t)((int32_t)(w << (31 - b)) >> 31);
}

// dst[off, off + V) = src[off, off + V) | the OR of the 32 rows at
// panel + b * stride (words off..) whose mask m[b] is set: one and-or
// (LOP3) a word a row.
template <int V>
__device__ __forceinline__ void chunk_or(uint32_t* dst, const uint32_t* src,
                                         const uint32_t* panel, int stride,
                                         int off, const uint32_t (&m)[32]) {
  uint32_t x[V];
  ld_words<V>(x, src + off);
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    uint32_t y[V];
    ld_words<V>(y, panel + b * stride + off);
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] |= y[v] & m[b];
  }
  st_words<V>(dst + off, x);
}

// Table entry t[off..] = OR of t1[j][off..] over the bits j of e (the
// single-bit entries of its table), V words.
template <int V>
__device__ __forceinline__ void entry_or(uint32_t* t, const uint32_t* t1,
                                         int wp, int e, int off) {
  uint32_t x[V];
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if ((e >> j) & 1) {
      uint32_t y[V];
      ld_words<V>(y, t1 + ((1 << j) * wp) + off);
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] |= y[v];
    }
  }
  st_words<V>(t + off, x);
}

// row[off, off + V) |= the 8 table entries at ent[g] + off.
template <int V>
__device__ __forceinline__ void row_lookup(uint32_t* row,
                                           const uint32_t* const (&ent)[8],
                                           int off) {
  uint32_t x[V];
  ld_words<V>(x, row + off);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    uint32_t y[V];
    ld_words<V>(y, ent[g] + off);
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] |= y[v];
  }
  st_words<V>(row + off, x);
}

// The words of chunk c of a row: 4, or 2 for a last chunk of 1 or 2 words
// (a stored row has wp >= 4 ceil(W/4) words, zero past W).
__device__ __forceinline__ bool chunk_is_full(int c, int w) {
  return 4 * c + 4 <= w || (w & 3) == 3;
}

// kVec: N = 0 mod 16 and 16-byte aligned tensors: bytes <-> bits 16 bytes
// a lane, a row a warp.  kShared: the tables and the bit rows in shared
// memory, else in scratch (a block's own 128 table entries, then its 32 W
// rows, wp words each).
template <bool kVec, bool kShared>
__global__ void __launch_bounds__(kBlockMaxThreads)
closure_block_kernel(const uint8_t* adj, uint8_t* out, int64_t batch, int n,
                     int wp, uint32_t* scratch) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int w = (n + 31) >> 5;           // words a row, and 32-row panels
  const int rows = 32 * w;               // the last panel padded with zeros
  const int nchunks = (w + 3) >> 2;
  const int64_t nn = (int64_t)n * n;
  uint32_t* base = kShared ? sm
                           : scratch + (int64_t)blockIdx.x * (rows + 128) * wp;
  uint32_t* tbl = base;                  // 8 tables x 16 entries x wp words
  uint32_t* bits = base + 128 * wp;      // the bit rows
  // entry 0 of every table stays zero
  for (int i = tid; i < 8 * wp; i += nthreads)
    tbl[(i / wp) * 16 * wp + i % wp] = 0u;

  for (int64_t g = blockIdx.x; g < batch; g += gridDim.x) {
    // in: every stored word of every stored row, zero past the graph; a
    // warp takes kInRows rows at a time, their loads issued together
    const uint8_t* a = adj + g * nn;
    for (int i0 = warp; i0 < rows; i0 += kInRows * nwarps) {
      if (kVec) {
        // lane j turns bytes [16j, 16j + 16) into 16 bits; lanes 2m and
        // 2m + 1 make word m
        const int nseg = n >> 4;
        for (int j0 = 0; j0 < 2 * wp; j0 += 32) {
          const int j = j0 + lane;
          uint4 v[kInRows];
#pragma unroll
          for (int u = 0; u < kInRows; ++u) {
            const int i = i0 + u * nwarps;
            v[u] = i < n && j < nseg
                       ? __ldcs(reinterpret_cast<const uint4*>(
                             a + (int64_t)i * n + 16 * j))
                       : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < kInRows; ++u) {
            const int i = i0 + u * nwarps;
            const uint32_t b16 = nib_of(v[u].x) | nib_of(v[u].y) << 4
                                 | nib_of(v[u].z) << 8 | nib_of(v[u].w) << 12;
            const uint32_t hi = __shfl_down_sync(kFull, b16, 1);
            if (i < rows && !(j & 1) && (j >> 1) < wp)
              bits[(int64_t)i * wp + (j >> 1)] = b16 | hi << 16;
          }
        }
      } else {
        // word v of a row is a ballot over its 32 bytes
        for (int v = 0; v < wp; ++v) {
          const int col = 32 * v + lane;
          uint8_t byte[kInRows];
#pragma unroll
          for (int u = 0; u < kInRows; ++u) {
            const int i = i0 + u * nwarps;
            byte[u] = i < n && col < n ? a[(int64_t)i * n + col] : 0;
          }
#pragma unroll
          for (int u = 0; u < kInRows; ++u) {
            const int i = i0 + u * nwarps;
            const uint32_t word = __ballot_sync(kFull, byte[u] != 0);
            if (lane == 0 && i < rows) bits[(int64_t)i * wp + v] = word;
          }
        }
      }
    }
    __syncthreads();

    // Warshall, 32 steps (one panel, kb) at a time
    for (int kb = 0; kb < w; ++kb) {
      const uint32_t* prow = bits + (int64_t)(32 * kb) * wp;
      // D*: lane p holds panel row p's word kb (its edges inside the
      // panel), closed by 32 Warshall steps in registers; every warp
      // computes it, so no barrier is needed before the panel
      uint32_t d = prow[lane * wp + kb];
#pragma unroll
      for (int L = 0; L < 32; ++L) {
        const uint32_t dk = __shfl_sync(kFull, d, L);
        d |= dk & (uint32_t)((int32_t)(d << (31 - L)) >> 31);
      }
      // the closed panel: P[p] = row p | the rows b of D*[p], chunks dealt
      // out over the warps, a lane a panel row, written as entry 1 << (p %
      // 4) of table p / 4
      {
        uint32_t m[32];
        masks_of(m, d);
        uint32_t* dst = tbl + ((lane >> 2) * 16 + (1 << (lane & 3))) * wp;
        for (int c = warp; c < nchunks; c += nwarps) {
          if (chunk_is_full(c, w))
            chunk_or<4>(dst, prow + lane * wp, prow, wp, 4 * c, m);
          else
            chunk_or<2>(dst, prow + lane * wp, prow, wp, 4 * c, m);
        }
      }
      __syncthreads();
      // the tables' other entries: entry e of table t is the OR of the
      // closed rows 4t + j over the bits j of e
      for (int idx = tid; idx < 128 * nchunks; idx += nthreads) {
        const int e = idx & 15, t = (idx >> 4) & 7, c = idx >> 7;
        if (__popc(e) < 2) continue;
        uint32_t* te = tbl + (t * 16 + e) * wp;
        const uint32_t* t1 = tbl + t * 16 * wp;
        if (chunk_is_full(c, w)) entry_or<4>(te, t1, wp, e, 4 * c);
        else entry_or<2>(te, t1, wp, e, 4 * c);
      }
      __syncthreads();
      // every row ORs in the closed panel rows its word kb names: the 8
      // entries its 8 nibbles pick
      for (int i0 = warp * 32; i0 < n; i0 += nthreads) {
        const int i = i0 + lane;
        uint32_t* row = bits + (int64_t)(i < n ? i : 0) * wp;
        const uint32_t word = i < n ? row[kb] : 0u;
        if (!__any_sync(kFull, word != 0u) || i >= n) continue;
        const uint32_t* ent[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          ent[t] = tbl + (t * 16 + ((word >> (4 * t)) & 15u)) * wp;
        for (int c = 0; c < nchunks; ++c) {
          if (chunk_is_full(c, w)) row_lookup<4>(row, ent, 4 * c);
          else row_lookup<2>(row, ent, 4 * c);
        }
      }
      __syncthreads();
    }

    // out
    uint8_t* o = out + g * nn;
    for (int i = warp; i < n; i += nwarps) {
      const uint32_t* row = bits + (int64_t)i * wp;
      if (kVec) {
        for (int j = lane; j < (n >> 4); j += 32) {
          const uint32_t h = row[j >> 1] >> (16 * (j & 1));
          __stcs(reinterpret_cast<uint4*>(o + (int64_t)i * n + 16 * j),
                 make_uint4(bytes_of(h), bytes_of(h >> 4), bytes_of(h >> 8),
                            bytes_of(h >> 12)));
        }
      } else {
        for (int v = 0; v < w; ++v) {
          const uint32_t word = row[v];
          const int col = 32 * v + lane;
          if (col < n) o[(int64_t)i * n + col] = (uint8_t)((word >> lane) & 1u);
        }
      }
    }
    __syncthreads();                     // the next graph reuses the rows
  }
}

// Blocks of `threads` threads that fit on the card at once with `shmem`
// bytes each (at least one an SM), capped at `want`.
template <typename K>
int resident_blocks(K kern, int threads, size_t shmem, int64_t want,
                    int64_t* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, threads, shmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = want < resident ? want : resident;
  return 0;
}

template <int W, bool kRowVec>
int launch_as(const uint8_t* adj, uint8_t* out, int64_t batch, int n,
              size_t shmem, cudaStream_t stream) {
  auto kern = closure_kernel<W, kRowVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = 0;
  const int err = resident_blocks(kern, kWarps * 32, shmem,
                                  (batch + kWarps - 1) / kWarps, &blocks);
  if (err != 0) return err;
  kern<<<(unsigned)blocks, kWarps * 32, shmem, stream>>>(adj, out, batch, n);
  return (int)cudaGetLastError();
}

template <int W>
int launch_warp(const uint8_t* adj, uint8_t* out, int64_t batch, int n,
                bool row_vec, size_t shmem, cudaStream_t stream) {
  return row_vec ? launch_as<W, true>(adj, out, batch, n, shmem, stream)
                 : launch_as<W, false>(adj, out, batch, n, shmem, stream);
}

template <bool kVec, bool kShared>
int launch_block(const uint8_t* adj, uint8_t* out, int64_t batch, int n,
                 int wp, int threads, size_t shmem, uint32_t* scratch,
                 int64_t grid, cudaStream_t stream) {
  auto kern = closure_block_kernel<kVec, kShared>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = grid;
  if (kShared) {
    const int err = resident_blocks(kern, threads, shmem, batch, &blocks);
    if (err != 0) return err;
  }
  kern<<<(unsigned)blocks, threads, shmem, stream>>>(adj, out, batch, n, wp,
                                                      scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// adj and out are torch bool storage, one byte per element (0 or 1),
// contiguous bool[batch, n, n], at any byte offset.  The caller routes
// (paxi_tpu_torch/ops/closure.py closure_route): variant 0 the warp kernel
// (n <= kWarpMaxN), 1 the block kernel with its bit rows and tables in
// shared memory, 2 with them in `scratch` (grid blocks of 32 ceil(n/32) + 128
// rows of wp words each); vec the 16-byte row conversion; wp the stored
// row's words; threads a block; shmem the dynamic shared memory of a block.
// Returns the CUDA error code of the launch, cudaErrorInvalidValue for
// parameters that do not fit n.
extern "C" int paxi_transitive_closure(const uint8_t* adj, uint8_t* out,
                                       int64_t batch, int n, int variant,
                                       int vec, int wp, int threads,
                                       int shmem, void* scratch,
                                       int64_t grid, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int bad = (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)adj & 15) == 0
                       && ((uintptr_t)out & 15) == 0;
  const int w = (n + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    if (n > kWarpMaxN || (vec && !(n % 32 == 16 && aligned))
        || (size_t)shmem
           < kBarBytes + (size_t)kWarps * (kStages + 1) * stage_bytes(n))
      return bad;
    switch (w) {
      case 1: return launch_warp<1>(adj, out, batch, n, vec, shmem, s);
      case 2: return launch_warp<2>(adj, out, batch, n, vec, shmem, s);
      case 3: return launch_warp<3>(adj, out, batch, n, vec, shmem, s);
      case 4: return launch_warp<4>(adj, out, batch, n, vec, shmem, s);
      case 5: return launch_warp<5>(adj, out, batch, n, vec, shmem, s);
      case 6: return launch_warp<6>(adj, out, batch, n, vec, shmem, s);
      case 7: return launch_warp<7>(adj, out, batch, n, vec, shmem, s);
      default: return launch_warp<8>(adj, out, batch, n, vec, shmem, s);
    }
  }
  if ((variant != 1 && variant != 2) || wp % 4 != 0 || wp < 4 * ((w + 3) / 4)
      || threads < 32 || threads > kBlockMaxThreads || threads % 32 != 0
      || (vec && !(n % 16 == 0 && aligned)))
    return bad;
  uint32_t* rows = (uint32_t*)scratch;
  if (variant == 1) {
    if ((size_t)shmem < (size_t)(32 * w + 128) * wp * 4) return bad;
    return vec ? launch_block<true, true>(adj, out, batch, n, wp, threads,
                                          shmem, nullptr, 0, s)
               : launch_block<false, true>(adj, out, batch, n, wp, threads,
                                           shmem, nullptr, 0, s);
  }
  if (rows == nullptr || grid < 1) return bad;
  return vec ? launch_block<true, false>(adj, out, batch, n, wp, threads,
                                         shmem, rows, grid, s)
             : launch_block<false, false>(adj, out, batch, n, wp, threads,
                                          shmem, rows, grid, s);
}
