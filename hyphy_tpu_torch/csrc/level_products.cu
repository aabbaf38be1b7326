// Sibling product of one Felsenstein pruning level, for Hopper (sm_90a).
//
//   out[w, p, i] = prod_k sum_j cp[w, k, i, j] * cc[w, k, p, j]
//
// cc [W, K, P, S] gathered child CLVs, cp [W, K, S, S] child transition
// matrices, out [W, P, S]; all contiguous, one dtype (float or double),
// S <= 64, K >= 1 (polytomies included). Replaces the Pallas kernel
// hyphy_tpu/ops/pallas_pruning.py:38 (_level_kernel).
//
// What bounds it on an H100: at the codon fit's widest levels the fp32 work
// is bytes = operations (2*S FLOP per CLV element read: 15.3 GFLOP and
// 764 MB at (W,K,P,S) = (500,2,2048,61), 0.228 ms each against 67 TFLOP/s
// and 3.35 TB/s); in fp64 the bytes bind (0.456 ms) with the CUDA-core
// operation time (0.450 ms) just under. So the kernel has to keep the FMA
// pipes busy while it streams the CLVs once.
//
// Why CUDA cores: tensor cores would only lower the operation roof, which
// does not bind in fp64 and equals the byte roof in fp32; TF32 (10-bit
// mantissa) would break the fp32 path's 1e-5 relative accuracy. Why no TMA:
// a tensor map needs 16-byte global strides and a bulk copy a 16-byte
// aligned start and length, but a CLV row is S*4 = 244 bytes at S = 61 and a
// tile starts at (w*K*P + p0)*S elements, unaligned in general.
//
// Design (one kernel template over T, SG state groups, RP patterns):
//   * 256 threads = SG state groups x 256/SG pattern groups. A thread owns
//     RP = 8 patterns (pg + q*256/SG) x RS states (sg + SG*r), RS = 8 in
//     fp32 and 4 in fp64, and keeps RP*RS dot products and RP*RS running
//     products over the children in registers. Per j it reads RS + RP
//     words from shared memory for RP*RS FMAs: 0.25 words per FMA in fp32,
//     what the SM's 128 bytes per clock of shared-memory delivery feed at
//     its 128 FMAs per clock. SG = ceil(S/RS) rounded up to a power of two
//     is chosen by the wrapper's launch plan; a tile is TP = RP*256/SG
//     patterns. A warp holds 8 pattern groups x 4 state groups (fewer state
//     groups when SG < 4); at one j it reads 8 CLV rows and 4 P rows, all
//     of stride S, in distinct banks when S is odd (61) or 4.
//   * Shared layout per ring stage: P[w,k] and the CLV tile, each as the
//     contiguous range it is in global memory, copied by 16-byte
//     cp.async.cg chunks. A range's start is unaligned in general, so its
//     copy lands shifted by the same amount mod 16 bytes; only the head and
//     the tail (< 16 bytes each) go by element-sized copies. (4-byte copies
//     into a padded layout ran the copies alone at 1.6x the DRAM bound.)
//   * No pad: the j loop runs exactly to S. P rows i >= S and CLV rows
//     past a ragged tile's end hold stale shared memory; they feed only
//     outputs that are never stored.
//   * A 2-stage cp.async ring: a stage is (P[w,k], CLV tile [k, p0:p0+TP]);
//     the block computes child k while child k+1 is in flight. P is re-read
//     per stage (from L2).
//   * Grid (n_tiles, W), one resident block per SM: block (t, w) computes
//     pattern tile t of node w over all K children, then stores it.
//   * The plan's RP, TP and shared-memory size are an echo: launch()
//     derives them from SG and refuses a plan that disagrees, so the
//     wrapper's tests of the plan test this layout.
//
// K1_PART selects a part of the kernel for k1_breakdown.py's timings:
// 0 the whole kernel (the only build the port uses), 1 the copies,
// barriers and stores with an empty j loop, 2 the j loop on stale shared
// memory without the copies.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#ifndef K1_PART
#define K1_PART 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStates = 64;
constexpr int kMaxSmem = 232448;   // per block, after opt-in
constexpr int kMaxDevices = 64;
constexpr int kPatternsPerThread = 8;

template <typename T> struct StatesPerThread { static constexpr int value = 8; };
template <> struct StatesPerThread<double> { static constexpr int value = 4; };

// Shared memory of one instantiation: two ring stages, each P's range and
// the CLV tile's range with room for the alignment shift, 16-byte aligned.
template <typename T, int SG, int RP>
struct Layout {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));   // elements per chunk
  static constexpr int kRowsP = StatesPerThread<T>::value * SG;
  static constexpr int kTile = RP * kThreads / SG;
  __host__ __device__ static int round(int n) { return (n + kV - 1) / kV * kV; }
  __host__ __device__ static int p_elems(int S) { return round(kRowsP * S + kV); }
  __host__ __device__ static int stage_elems(int S) {
    return p_elems(S) + round(kTile * S + kV);
  }
  static int smem_bytes(int S) { return 2 * stage_elems(S) * static_cast<int>(sizeof(T)); }
};

template <typename T>
__device__ __forceinline__ int shift_of(const T* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(T)) % (16 / sizeof(T)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Queue the copy of n contiguous elements into buf + shift_of(src).
template <typename T>
__device__ __forceinline__ void copy_range(T* buf, const T* src, int n) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  T* dst = buf + shift_of(src);
  const int head = min(n, (kV - shift_of(src)) % kV);
  const int chunks = (n - head) / kV;
  const int tail = head + chunks * kV;
  const int tid = threadIdx.x;
  for (int c = tid; c < chunks; c += kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst + head + c * kV)), "l"(src + head + c * kV)
                 : "memory");
  // the head by threads [0, head), the tail by threads [kV, kV + n - tail)
  const int e = tid < head ? tid : (tid >= kV && tid - kV < n - tail ? tail + tid - kV : -1);
  if (e >= 0)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst + e)), "l"(src + e), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T, int SG, int RP>
__global__ void __launch_bounds__(kThreads, 1)
level_products_kernel(const T* __restrict__ cc, const T* __restrict__ cp,
                      T* __restrict__ out, int K, int P, int S) {
  using L = Layout<T, SG, RP>;
  constexpr int RS = StatesPerThread<T>::value;
  constexpr int kPG = kThreads / SG;          // pattern groups
  constexpr int kTile = L::kTile;             // patterns per tile
  constexpr int kSGW = SG < 4 ? SG : 4;       // state groups per warp
  constexpr int kPGW = 32 / kSGW;             // pattern groups per warp
  constexpr int kWarpsS = SG / kSGW;          // warps across the states

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int w = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int np = min(kTile, P - p0);          // patterns in this tile

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sg = lane % kSGW + kSGW * (warp % kWarpsS);
  const int pg = lane / kSGW + kPGW * (warp / kWarpsS);

  const int stage_elems = L::stage_elems(S);
  const int p_elems = L::p_elems(S);
  auto g_p = [&](int k) { return cp + (static_cast<size_t>(w) * K + k) * S * S; };
  auto g_c = [&](int k) {
    return cc + ((static_cast<size_t>(w) * K + k) * P + p0) * S;
  };
  auto queue = [&](int k) {                   // child k into stage k & 1
    if (K1_PART == 2) return;
    T* stage = smem + (k & 1) * stage_elems;
    copy_range(stage, g_p(k), S * S);
    copy_range(stage + p_elems, g_c(k), np * S);
  };
  queue(0);
  commit_group();

  T prod[RP][RS];
  for (int k = 0; k < K; ++k) {
    if (k + 1 < K) queue(k + 1);
    commit_group();                           // possibly empty: keeps the count
    wait_all_but_one();
    __syncthreads();                          // child k visible to every thread

    const T* stage = smem + (k & 1) * stage_elems;
    const T* pa = stage + shift_of(g_p(k)) + sg * S;              // state row sg
    const T* pb = stage + p_elems + shift_of(g_c(k)) + pg * S;    // pattern row pg
    const int a_step = SG * S, b_step = kPG * S;
    T acc[RP][RS];
#pragma unroll
    for (int q = 0; q < RP; ++q)
#pragma unroll
      for (int r = 0; r < RS; ++r) acc[q][r] = T(0);
#pragma unroll 2
    for (int j = 0; j < (K1_PART == 1 ? 0 : S); ++j) {
      T a[RS], b[RP];
#pragma unroll
      for (int r = 0; r < RS; ++r) a[r] = pa[r * a_step + j];
#pragma unroll
      for (int q = 0; q < RP; ++q) b[q] = pb[q * b_step + j];
#pragma unroll
      for (int q = 0; q < RP; ++q)
#pragma unroll
        for (int r = 0; r < RS; ++r) acc[q][r] = fma(a[r], b[q], acc[q][r]);
    }
#pragma unroll
    for (int q = 0; q < RP; ++q)
#pragma unroll
      for (int r = 0; r < RS; ++r) prod[q][r] = k == 0 ? acc[q][r] : prod[q][r] * acc[q][r];
    __syncthreads();                          // stage k & 1 free for child k+2
  }

  T* o = out + (static_cast<size_t>(w) * P + p0) * S;
#pragma unroll
  for (int q = 0; q < RP; ++q) {
    const int p = pg + q * kPG;
    if (p < np) {
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int i = sg + SG * r;
        if (i < S) o[p * S + i] = prod[q][r];
      }
    }
  }
}

template <typename T, int SG>
int launch_one(const T* cc, const T* cp, T* out, int W, int K, int P, int S,
               int smem, cudaStream_t stream) {
  constexpr int RP = kPatternsPerThread;
  using L = Layout<T, SG, RP>;
  if (smem != L::smem_bytes(S) || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0 || P == 0) return 0;
  auto kernel = level_products_kernel<T, SG, RP>;
  // the opt-in above 48 KB is per function and device; set it once each.
  // Host threads launch at once (one per block of a sharded solve), so the
  // flags are atomic; two threads that both see false both set the same
  // attribute, which is harmless.
  static std::atomic<bool> opted_in[kMaxDevices];     // static: zero, false
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted_in[dev].store(true, std::memory_order_release);
  }
  const int n_tiles = (P + L::kTile - 1) / L::kTile;
  kernel<<<dim3(n_tiles, W), kThreads, smem, stream>>>(cc, cp, out, K, P, S);
  return static_cast<int>(cudaGetLastError());
}

// The plan (SG, RP, TP, smem) comes from the wrapper. Anything the
// kernel could not run safely is refused with cudaErrorInvalidValue.
template <typename T>
int launch(const T* cc, const T* cp, T* out, int W, int K, int P, int S,
           int SG, int RP, int TP, int smem, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (S < 1 || S > kMaxStates || K < 1 || W < 0 || P < 0) return bad;
  if (RP != kPatternsPerThread || StatesPerThread<T>::value * SG < S ||
      TP * SG != RP * kThreads) return bad;
  switch (SG) {
    case 1:  return launch_one<T, 1>(cc, cp, out, W, K, P, S, smem, stream);
    case 2:  return launch_one<T, 2>(cc, cp, out, W, K, P, S, smem, stream);
    case 4:  return launch_one<T, 4>(cc, cp, out, W, K, P, S, smem, stream);
    case 8:  return launch_one<T, 8>(cc, cp, out, W, K, P, S, smem, stream);
    case 16: return launch_one<T, 16>(cc, cp, out, W, K, P, S, smem, stream);
    default: return bad;
  }
}

}  // namespace

extern "C" int level_products_f32(const float* cc, const float* cp, float* out,
                                  int W, int K, int P, int S, int SG, int RP, int TP,
                                  int smem_bytes, void* stream) {
  return launch<float>(cc, cp, out, W, K, P, S, SG, RP, TP, smem_bytes,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int level_products_f64(const double* cc, const double* cp, double* out,
                                  int W, int K, int P, int S, int SG, int RP, int TP,
                                  int smem_bytes, void* stream) {
  return launch<double>(cc, cp, out, W, K, P, S, SG, RP, TP, smem_bytes,
                        static_cast<cudaStream_t>(stream));
}
