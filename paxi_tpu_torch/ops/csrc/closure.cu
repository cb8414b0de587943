// Boolean transitive closure of a batch of small graphs, for Hopper (sm_90a).
//
// Replaces the TPU kernel paxi_tpu/ops/closure.py closure_pallas (body
// _closure_kernel): n_iter squarings r <- r | r.r of each bool[N, N]
// adjacency matrix, with no implicit identity (a node reaches itself only
// through a cycle).  The TPU kernel squares a float32 copy padded to a
// multiple of 128 on the matrix unit; here nothing is padded and no float
// is involved, so the result is exact by construction.  The plain PyTorch
// version is closure_plain in paxi_tpu_torch/ops/closure.py, which binds
// this entry point through ctypes and checks every argument.
//
// Design.  Each block holds several whole matrices, one thread per row.
// Rows are bit-packed into W = ceil(N/32) uint32 words in shared memory.
// The block's matrices are one contiguous run of bytes: it is read with
// 16-byte loads, neighbouring threads on neighbouring addresses, and each
// nonzero byte sets its bit with a shared-memory atomicOr (the graphs are
// sparse, so there are few).  A squaring forms, for row i,
// row_i | OR over the set bits k of row_i of row_k, into a second buffer;
// the block then synchronises and swaps the buffers.  When a squaring
// changes no row of the block the rest are identities and the block stops
// early.  The result is written back as bytes with 16-byte stores.  The
// unaligned head and tail of a block's run go byte by byte.
//
// Bound on an H100 (3.35 TB/s): the kernel must read B*N*N bytes and write
// as many; the bit operations per set bit are few, so it is bound by
// bytes.  Speed is later work: building the graph bit-packed in the caller
// (a 32x smaller read) and fusing the layout copies around the call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 256;                // widest graph taken
constexpr int kRowsPerBlock = 512;        // threads of a block, at most

// Flat byte f of a block's run is row f / n, column f % n.
template <int W>
__device__ __forceinline__ void set_bit(uint32_t* m, int f, int n) {
  const int r = f / n, c = f - r * n;
  atomicOr(&m[r * W + (c >> 5)], 1u << (c & 31));
}

template <int W>
__device__ __forceinline__ uint8_t get_bit(const uint32_t* m, int f, int n) {
  const int r = f / n, c = f - r * n;
  return (uint8_t)((m[r * W + (c >> 5)] >> (c & 31)) & 1u);
}

// Bytes before the first 16-byte boundary of p, at most len.
__device__ __forceinline__ int head_bytes(const void* p, int len) {
  const int h = (int)((16 - ((uintptr_t)p & 15)) & 15);
  return h < len ? h : len;
}

template <int W>
__global__ void closure_kernel(const uint8_t* __restrict__ adj,
                               uint8_t* __restrict__ out, int64_t batch,
                               int n, int n_iter, int mats_per_block) {
  extern __shared__ uint32_t smem[];
  const int rows = mats_per_block * n;    // rows of a full block
  uint32_t* cur = smem;
  uint32_t* nxt = smem + (int64_t)rows * W;

  const int64_t mat0 = (int64_t)blockIdx.x * mats_per_block;
  int64_t left = batch - mat0;
  const int mats = left < mats_per_block ? (int)left : mats_per_block;
  const int my_rows = mats * n;           // rows this block really holds
  const int64_t nn = (int64_t)n * n;
  const uint8_t* src = adj + mat0 * nn;
  uint8_t* dst = out + mat0 * nn;

  const int len = my_rows * n;            // bytes of this block's graphs
  const int tid = threadIdx.x, nt = blockDim.x;

  // load: clear the bit rows, then set a bit per nonzero byte
  for (int i = tid; i < my_rows * W; i += nt) cur[i] = 0;
  __syncthreads();
  {
    const int head = head_bytes(src, len);
    const int n_vec = (len - head) >> 4;
    const uint4* vec = reinterpret_cast<const uint4*>(src + head);
    for (int f = tid; f < head; f += nt) {
      if (src[f]) set_bit<W>(cur, f, n);
    }
    for (int v0 = tid; v0 < n_vec; v0 += 4 * nt) {
      uint4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {      // four loads in flight
        const int v = v0 + u * nt;
        q[u] = v < n_vec ? vec[v] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f0 = head + ((v0 + u * nt) << 4);
        const uint32_t part[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t word = part[j];
          while (word) {                 // one pass per nonzero byte
            const int b = (__ffs(word) - 1) >> 3;
            set_bit<W>(cur, f0 + (j << 2) + b, n);
            word &= ~(0xffu << (b << 3));
          }
        }
      }
    }
    for (int f = head + (n_vec << 4) + tid; f < len; f += nt) {
      if (src[f]) set_bit<W>(cur, f, n);
    }
  }
  __syncthreads();

  const int row = threadIdx.x;
  const bool active = row < my_rows;
  for (int it = 0; it < n_iter; ++it) {
    int changed = 0;
    if (active) {
      const uint32_t* m = cur + (row / n) * n * W;   // this row's matrix
      uint32_t own[W], acc[W];
#pragma unroll
      for (int v = 0; v < W; ++v) own[v] = acc[v] = cur[row * W + v];
#pragma unroll
      for (int v = 0; v < W; ++v) {
        uint32_t bits = own[v];
        while (bits) {
          int k = v * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
#pragma unroll
          for (int u = 0; u < W; ++u) acc[u] |= m[k * W + u];
        }
      }
#pragma unroll
      for (int v = 0; v < W; ++v) {
        nxt[row * W + v] = acc[v];
        changed |= acc[v] != own[v];
      }
    }
    // every read of cur is done once all threads pass this barrier
    const int any = __syncthreads_or(changed);
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;    // a fixed point: later squarings change nothing
  }

  // cur holds the result; write it back as bytes, 16 a store
  const int head = head_bytes(dst, len);
  const int n_vec = (len - head) >> 4;
  uint4* vec = reinterpret_cast<uint4*>(dst + head);
  for (int f = tid; f < head; f += nt) dst[f] = get_bit<W>(cur, f, n);
  for (int v = tid; v < n_vec; v += nt) {
    const int f0 = head + (v << 4);
    int r = f0 / n, c = f0 - r * n;
    uint32_t part[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t x = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        x |= ((cur[r * W + (c >> 5)] >> (c & 31)) & 1u) << (b << 3);
        if (++c == n) {
          c = 0;
          ++r;
        }
      }
      part[j] = x;
    }
    vec[v] = make_uint4(part[0], part[1], part[2], part[3]);
  }
  for (int f = head + (n_vec << 4) + tid; f < len; f += nt) {
    dst[f] = get_bit<W>(cur, f, n);
  }
}

template <int W>
int launch(const uint8_t* adj, uint8_t* out, int64_t batch, int n,
           int n_iter, cudaStream_t stream) {
  int mats_per_block = kRowsPerBlock / n;
  if (mats_per_block < 1) mats_per_block = 1;
  int threads = ((mats_per_block * n + 31) / 32) * 32;
  size_t shmem = 2 * (size_t)mats_per_block * n * W * sizeof(uint32_t);
  int64_t blocks = (batch + mats_per_block - 1) / mats_per_block;
  closure_kernel<W><<<(unsigned int)blocks, threads, shmem, stream>>>(
      adj, out, batch, n, n_iter, mats_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// adj and out are torch bool storage, one byte per element (0 or 1),
// contiguous bool[batch, n, n].  Returns the CUDA error code of the launch
// (cudaErrorInvalidValue for an n above kMaxN or a grid too large).
extern "C" int paxi_transitive_closure(const uint8_t* adj, uint8_t* out,
                                       int64_t batch, int n, int n_iter,
                                       void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxN || n_iter < 1) return (int)cudaErrorInvalidValue;
  int mats_per_block = n > kRowsPerBlock ? 1 : kRowsPerBlock / n;
  if ((batch + mats_per_block - 1) / mats_per_block > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch ((n + 31) / 32) {
    case 1: return launch<1>(adj, out, batch, n, n_iter, s);
    case 2: return launch<2>(adj, out, batch, n, n_iter, s);
    case 3: return launch<3>(adj, out, batch, n, n_iter, s);
    case 4: return launch<4>(adj, out, batch, n, n_iter, s);
    case 5: return launch<5>(adj, out, batch, n, n_iter, s);
    case 6: return launch<6>(adj, out, batch, n, n_iter, s);
    case 7: return launch<7>(adj, out, batch, n, n_iter, s);
    default: return launch<8>(adj, out, batch, n, n_iter, s);
  }
}
