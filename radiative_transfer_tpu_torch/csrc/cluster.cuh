// The thread block cluster machinery of the wavefront kernels (df_sweep.cu:
// B6 df_bdf2_kernel and B14 df_halo_bdf2_kernel; sweep.cu: B1 bdf2_kernel
// and B2 multistep_kernel; adjoint.cu: B11 fwd_record_k_kernel, B10
// bwd_kernel and B12 bwd_k_kernel), which run one row's tiles (B14: one
// chain's) on the C blocks of a cluster, tile t on block t mod C, and hand
// each (step, phase) slot's state from tile t to tile t+1 through
// distributed shared memory (B10 and B12 count their sub-tiles from the
// row's end and hand each slot's state upstream):
// * a per-slot mailbox of F floats and an mbarrier of one arrival a phase
//   (Mailbox), opened by every block before any block sends;
// * the send: `mapa` to the next block's copy of the slot's mailbox,
//   `st.shared::cluster` of the mail, `mbarrier.arrive.release.cluster`;
// * the receive: thread 0's `mbarrier.try_wait.parity.acquire.cluster` on
//   the block's parity bit, then a read of its own mailbox;
// * on the host, how many clusters of C blocks the card holds at once, the
//   largest C (at most the slots, the tiles and max_cluster) at which every
//   row's cluster of a launch is resident, and the cluster launch.
//
// Why no "mailbox free" signal is needed, and why one parity bit a block
// serves every slot: block b = t mod C reads its mailbox for slot s once a
// tile, before it runs slot s of tile t. The next write to it carries tile
// t+C's input and comes from tile t+C-1, after tile t+C-1 ran slot s, which
// needed tile t+C-2's slot-s message, and so on back to tile t+1, which
// needed tile t's slot-s message, sent after tile t ran slot s, after it
// read its mailbox. Each link is a release (the sender's arrive) and an
// acquire (the receiver's wait) at cluster scope, so the read happens
// before the overwrite. The same chain keeps an mbarrier at most one phase
// ahead of its waiter: the arrival for tile t+C comes after tile t's wait
// completed. Every tile a block waits for waits on all its slots' barriers
// once, so the block flips its one parity bit after each such tile. The
// chain also orders a slot's shared state: the read of it that a block's
// sender makes for tile t precedes (in that thread's order) its release,
// so it precedes the write of the same slot that thread 0 makes when the
// block receives tile t+C's mail. All of it needs the chain unbroken: a
// tile that waits on no mail (a chain's first) may only be tile 0 of its
// cluster, or it could run ahead and overwrite a mailbox its successor's
// block has not read yet (B14 runs each of a row's two chains on a cluster
// of its own for this).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <utility>

#include "tiles.cuh"

namespace {

constexpr int kMaxCluster = 16;  // blocks a row (above 8 non-portable)

// Per slot: a mailbox of F floats and an mbarrier (one arrival a phase).
template <int F, int S>
struct Mailbox {
  float mail[S][F];
  alignas(8) uint64_t bar[S];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared variable in cluster block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(const uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

// Thread 0 initialises the first `slots` barriers to one arrival a phase;
// the cluster-wide sync that follows makes every block's barriers exist
// before any block arrives on them.
template <int F, int S>
__device__ __forceinline__ void open_mailboxes(Mailbox<F, S>& mb,
                                               int slots) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_addr(&mb.bar[s])),
                   "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cooperative_groups::this_cluster().sync();
}

// No block leaves while a cluster peer may still address its mailboxes.
__device__ __forceinline__ void close_mailboxes() {
  cooperative_groups::this_cluster().sync();
}

// Every thread of the cluster: the global and shared writes before it are
// visible to every block of the cluster after it (release and acquire at
// cluster scope). B10's and B12's prologue scratch and gradient partials
// cross blocks this way.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Thread 0 only: waits for slot s's mail of the phase `parity` (acquire at
// cluster scope) and returns it. No barrier follows: the caller copies the
// mail into the slot's shared state, which the other threads first read
// after the block's next barrier.
template <int F, int S>
__device__ __forceinline__ const float* wait_mail(Mailbox<F, S>& mb, int s,
                                                  uint32_t parity) {
  while (!mbar_try_wait(&mb.bar[s], parity)) {
  }
  return mb.mail[s];
}

// Writes the first n fields of v into slot s's mailbox of cluster block
// `next` and arrives on that block's barrier for the slot (release at
// cluster scope).
template <int F, int S>
__device__ __forceinline__ void send_mail(Mailbox<F, S>& mb, int s,
                                          uint32_t next,
                                          const float (&v)[F], int n = F) {
  const uint32_t m = cluster_addr(&mb.mail[s][0], next);
#pragma unroll
  for (int i = 0; i < F; ++i)
    if (i < n) st_cluster(m + static_cast<uint32_t>(i * sizeof(float)), v[i]);
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          cluster_addr(&mb.bar[s], next))
      : "memory");
}

// How many clusters of c blocks of `threads` threads of `kernel` the card
// holds at once (cudaOccupancyMaxActiveClusters), cached per device,
// kernel, threads and c; 0 where the card refuses the shape.
inline int active_clusters(const void* kernel, int c, int threads) {
  struct Fit {
    const void* kernel;
    int dev, threads, c, n;
  };
  constexpr int kFits = 256;
  static Fit fits[kFits];
  static int used = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  for (int i = 0; i < used; ++i)
    if (fits[i].kernel == kernel && fits[i].dev == dev &&
        fits[i].threads == threads && fits[i].c == c)
      return fits[i].n;
  if (c > 8)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(threads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int got = 0;
  if (cudaOccupancyMaxActiveClusters(&got, kernel, &cfg) != cudaSuccess)
    got = 0;
  cudaGetLastError();  // a size the card refuses only counts 0 clusters
  if (used < kFits) fits[used++] = Fit{kernel, dev, threads, c, got};
  return got;
}

// The blocks a row of a wavefront over (tile, slot). At most `slots` tiles
// of a row are active at once (one a slot), so C = min(max_cluster, slots,
// tiles); then C shrinks until the launch's `clusters` rows fit on the card
// at once for each of `kernels`: a cluster that waits for a free GPC
// doubles the launch (8 blocks a row at the df bench's 16 rows leave one
// cluster for a second wave on an H100), while one block fewer a row costs
// at most a slots/C share of each tile's handoff slack.
inline int wave_cluster(int tiles, int slots, int threads, int max_cluster,
                        int clusters,
                        std::initializer_list<const void*> kernels) {
  int c = slots < max_cluster ? slots : max_cluster;
  if (tiles < c) c = tiles;
  auto fits = [&](int n) {
    for (const void* k : kernels)
      if (active_clusters(k, n, threads) < clusters) return false;
    return true;
  };
  while (c > 1 && !fits(c)) --c;
  return c < 1 ? 1 : c;
}

// Launches `clusters` clusters of C blocks of `threads` threads each on
// `stream` (C above 8 allowed first, a non-portable size); returns the
// launch's error, a refused cluster shape included.
template <typename... Exp, typename... Act>
cudaError_t launch_clusters(void (*kernel)(Exp...), int clusters, int C,
                            int threads, cudaStream_t stream,
                            Act&&... args) {
  if (C > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

// launch_halves (tiles.cuh) for launches that return their error:
// `launch(grid, half0)` gives its cudaError_t; a refused first half skips
// the second and its error is returned.
template <typename Launch>
int launch_halves_ex(int Bh, int reflective, Launch launch) {
  cudaError_t err = cudaSuccess;
  const int rc = launch_halves(Bh, reflective, [&](int grid, int half0) {
    if (err == cudaSuccess) err = launch(grid, half0);
  });
  return err != cudaSuccess ? static_cast<int>(err) : rc;
}

}  // namespace
