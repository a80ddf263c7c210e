// K4: the all-gather of the sharded engines.
//
// Replaces round_tpu/parallel/ici.py::_ring_kernel (pl.pallas_call at
// ici.py:162, behind ring_exchange): on every one of p shards,
//     out[:, d*cols:(d+1)*cols] = shard d's x        (x is [rows, cols])
// for int32 codes or int8 bit-planes; any cols, any itemsize.
//
// The TPU kernel forwards chunks around a ring in p-1 dependent steps,
// because a TPU has only neighbour links.  A card reaches every peer of its
// host in one hop, so here each shard PUSHES its own chunk straight into
// slot `me` of every peer's out: p-1 remote writes and the local one, the
// same bytes as the ring without the chain.  It is a copy, bound by bytes:
// each block copies a grid-stride share of the chunk to all p destinations
// with 16-byte accesses where the pointers, the row length and the output's
// pitch (p * row) allow, else with 4-byte or single-byte accesses (int8
// rows of 44 bytes, and the slot offset me * row, break wider alignment).
//
// Arrival is signalled in the kernel, as the TPU kernel's semaphores do.
// After its writes a block fences at system scope and stores the call's
// epoch, with release, into flags[dest][me][block] of every destination;
// before it exits it polls, with acquire, flags[me][peer][block] of every
// peer until each holds the epoch.  So when a device's launch has ended,
// every block of every peer has written its share into that device's
// outputs.  Epochs only grow: no flag is reset, and a flag of an earlier
// call never passes for this one.
//
// Blocks that spin on flags written by other blocks must all be resident.
// Shards that share a device therefore go in ONE launch (blockIdx.y is the
// shard), and the caller bounds gridDim.x * gridDim.y by a share of
// ring_exchange_max_blocks().  A block that waits longer than timeout_ns
// gives up and sets *status, so a peer that never launched ends in an
// error, not in a hung card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;  // parallel/ici.py::MAX_SHARDS
constexpr int kMaxBlocks = 64;  // parallel/ici.py::MAX_BLOCKS

struct RingArgs {
  char* outs[kMaxShards];       // [rows, p * row_bytes] of every shard
  const char* xs[kMaxShards];   // [rows, row_bytes] of every shard
  unsigned* flags[kMaxShards];  // [p, kMaxBlocks] on every shard's device
  int* status;                  // 0, or 1 + the peer a block gave up on
  long long rows;
  long long row_bytes;
  long long timeout_ns;
  int p;
  int rank_base;
  unsigned epoch;
};

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// This block's share of x ([rows, row_bytes], dense) into o (row pitch
// `pitch`), in units of V.
template <typename V>
__device__ __forceinline__ void copy_rows(const char* __restrict__ x,
                                          char* __restrict__ o,
                                          long long rows, long long row_bytes,
                                          long long pitch) {
  const long long per_row = row_bytes / (long long)sizeof(V);
  const long long total = rows * per_row;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += stride) {
    const long long r = e / per_row;
    const long long c = (e - r * per_row) * (long long)sizeof(V);
    *reinterpret_cast<V*>(o + r * pitch + c) =
        *reinterpret_cast<const V*>(x + r * row_bytes + c);
  }
}

__global__ void __launch_bounds__(kThreads)
ring_exchange_kernel(const RingArgs a) {
  const int me = a.rank_base + (int)blockIdx.y;
  const long long pitch = a.row_bytes * a.p;
  const char* x = a.xs[me];
  for (int k = 0; k < a.p; ++k) {
    const int dest = (me + k) % a.p;  // the local slot first, then the peers
    char* o = a.outs[dest] + (long long)me * a.row_bytes;
    const unsigned long long align =
        (unsigned long long)(uintptr_t)x | (unsigned long long)(uintptr_t)o |
        (unsigned long long)a.row_bytes | (unsigned long long)pitch;
    if ((align & 15) == 0) {
      copy_rows<uint4>(x, o, a.rows, a.row_bytes, pitch);
    } else if ((align & 3) == 0) {
      copy_rows<uint32_t>(x, o, a.rows, a.row_bytes, pitch);
    } else {
      copy_rows<uint8_t>(x, o, a.rows, a.row_bytes, pitch);
    }
  }
  // every thread's writes are ordered before the flags at system scope
  __threadfence_system();
  __syncthreads();
  const unsigned slot = (unsigned)me * kMaxBlocks + blockIdx.x;
  if ((int)threadIdx.x < a.p) {
    st_release_sys(a.flags[threadIdx.x] + slot, a.epoch);
  }
  // wait for the matching block of every peer (and of this shard itself)
  if ((int)threadIdx.x < a.p) {
    const unsigned* f =
        a.flags[me] + (unsigned)threadIdx.x * kMaxBlocks + blockIdx.x;
    const unsigned long long t0 = global_ns();
    while ((int)(ld_acquire_sys(f) - a.epoch) < 0) {
      __nanosleep(64);
      if ((long long)(global_ns() - t0) > a.timeout_ns) {
        atomicExch(a.status, 1 + (int)threadIdx.x);
        break;
      }
    }
  }
  __syncthreads();
}

}  // namespace

extern "C" {

// The blocks of the kernel one device keeps resident at once, or <= 0 when
// the query fails.
int ring_exchange_max_blocks(int device) {
  int prev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&prev) != cudaSuccess) return -1;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_exchange_kernel, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  cudaSetDevice(prev);
  return err == cudaSuccess ? per_sm * sms : -1;
}

// Let kernels on `device` write into memory of `peer`.  Returns a CUDA
// error code; cudaErrorPeerAccessUnsupported when the cards cannot reach
// each other.
int ring_enable_peer(int device, int peer) {
  int can = 0, prev = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  if ((err = cudaGetDevice(&prev)) != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky code
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)err;
}

// One launch for the n_local shards rank_base .. rank_base + n_local - 1,
// which lie on the current device, on `stream`.  outs, xs and flags are
// host arrays of p device pointers (by rank).  nb blocks per shard.
// Returns cudaGetLastError().
int ring_exchange_launch(void* const* outs, void* const* xs,
                         void* const* flags, int* status, int rows, int cols,
                         int itemsize, int p, int rank_base, int n_local,
                         int nb, unsigned epoch, long long timeout_ns,
                         void* stream) {
  if (p < 1 || p > kMaxShards || nb < 1 || nb > kMaxBlocks || n_local < 1 ||
      rank_base < 0 || rank_base + n_local > p) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0 || cols <= 0 || itemsize <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  RingArgs a;
  for (int r = 0; r < p; ++r) {
    a.outs[r] = (char*)outs[r];
    a.xs[r] = (const char*)xs[r];
    a.flags[r] = (unsigned*)flags[r];
  }
  a.status = status;
  a.rows = rows;
  a.row_bytes = (long long)cols * itemsize;
  a.timeout_ns = timeout_ns;
  a.p = p;
  a.rank_base = rank_base;
  a.epoch = epoch;
  ring_exchange_kernel<<<dim3((unsigned)nb, (unsigned)n_local), kThreads, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
