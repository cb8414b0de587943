// Boolean transitive closure of a batch of small graphs, for Hopper (sm_90a).
//
// Replaces the TPU kernel paxi_tpu/ops/closure.py closure_pallas (body
// _closure_kernel): n_iter squarings r <- r | r.r of each bool[N, N]
// adjacency matrix, with no implicit identity (a node reaches itself only
// through a cycle).  The TPU kernel squares a float32 copy padded to a
// multiple of 128 on the matrix unit.  Here the same relation A+ (every
// path of length >= 1) comes from Warshall's algorithm on bit rows, with
// nothing padded and no float involved, so the result is exact by
// construction.  The plain PyTorch version is closure_plain in
// paxi_tpu_torch/ops/closure.py, which binds this entry point through
// ctypes and checks every argument.
//
// Bound on an H100: bytes.  The kernel must read B*N*N bytes and write as
// many (6.4 GB at 500k graphs of 80 nodes: 1.91 ms at 3.35 TB/s).
// Warshall needs at most N*N*ceil(N/32) word and-ors a graph (each of N
// steps ORs row k into every row that has bit k): at the int32 rate that
// is 0.57 ms at 500k x 80 and 0.63 ms at 20k x 256, both under the bytes'
// time.
//
// Design.  One warp per graph; lane l holds rows l, l+32, ... as W =
// ceil(N/32) uint32 words in registers (slot s holds row 32s + l).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 256;                // widest graph taken (W = 8)
constexpr int kWarps = 4;                 // warps (graphs in flight) a block
constexpr int kStages = 2;                // staged chunks a warp
constexpr int kBarBytes = 128;            // the blocks' mbarriers, padded
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

template <int W, bool kRowVec>
int launch_as(const uint8_t* adj, uint8_t* out, int64_t batch, int n,
              cudaStream_t stream) {
  const size_t shmem =
      kBarBytes + (size_t)kWarps * (kStages + 1) * stage_bytes(n);
  auto kern = closure_kernel<W, kRowVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    kWarps * 32, shmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = (batch + kWarps - 1) / kWarps;
  const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > resident) blocks = resident;
  kern<<<(unsigned)blocks, kWarps * 32, shmem, stream>>>(adj, out, batch, n);
  return (int)cudaGetLastError();
}

template <int W>
int launch(const uint8_t* adj, uint8_t* out, int64_t batch, int n,
           cudaStream_t stream) {
  const bool row_vec = n % 32 == 16 && ((uintptr_t)adj & 15) == 0
                       && ((uintptr_t)out & 15) == 0;
  return row_vec ? launch_as<W, true>(adj, out, batch, n, stream)
                 : launch_as<W, false>(adj, out, batch, n, stream);
}

}  // namespace

// adj and out are torch bool storage, one byte per element (0 or 1),
// contiguous bool[batch, n, n], at any byte offset.  Returns the CUDA error
// code of the launch (cudaErrorInvalidValue for an n above kMaxN).
extern "C" int paxi_transitive_closure(const uint8_t* adj, uint8_t* out,
                                       int64_t batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((n + 31) / 32) {
    case 1: return launch<1>(adj, out, batch, n, s);
    case 2: return launch<2>(adj, out, batch, n, s);
    case 3: return launch<3>(adj, out, batch, n, s);
    case 4: return launch<4>(adj, out, batch, n, s);
    case 5: return launch<5>(adj, out, batch, n, s);
    case 6: return launch<6>(adj, out, batch, n, s);
    case 7: return launch<7>(adj, out, batch, n, s);
    default: return launch<8>(adj, out, batch, n, s);
  }
}
