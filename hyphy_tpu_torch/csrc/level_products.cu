// Sibling product of one Felsenstein pruning level, for Hopper (sm_90a).
//
//   out[w, p, i] = prod_k sum_j cp[w, k, i, j] * cc[w, k, p, j]
//
// cc [W, K, P, S] gathered child CLVs, cp [W, K, S, S] child transition
// matrices, out [W, P, S]; all contiguous, one dtype (float or double).
// Replaces the Pallas kernel hyphy_tpu/ops/pallas_pruning.py::_level_kernel.
//
// Design (a simple CUDA-core kernel; no wgmma or TMA yet):
//   * grid (pattern tile, node w); 256 threads = 4 pattern groups x 64
//     state lanes, so S <= 64;
//   * for each child k the block stages P[w, k] (S*S) and the child's CLV
//     tile (TILE_P*S) in shared memory — at most 45.4 KB in fp64, under the
//     48 KB a block gets without opt-in;
//   * lane i reads row i of P (odd stride S: conflict-free banks), the CLV
//     value of its pattern is a warp-wide broadcast; each thread keeps
//     TILE_P/4 dot products, multiplies them into a running product held in
//     registers across k, and stores once, coalesced along i;
//   * the ragged last tile is masked on load and store (no padding with
//     ones in memory); K is a runtime argument, so polytomies work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 64;                  // state lanes; S <= kLanes
constexpr int kGroups = kThreads / kLanes;  // pattern groups

template <typename T> struct TileP;
template <> struct TileP<float>  { static constexpr int value = 64; };
template <> struct TileP<double> { static constexpr int value = 32; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
level_products_kernel(const T* __restrict__ cc, const T* __restrict__ cp,
                      T* __restrict__ out, int K, int P, int S) {
  constexpr int kTile = TileP<T>::value;
  constexpr int kPer = kTile / kGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_p = reinterpret_cast<T*>(smem_raw);   // [S, S]
  T* s_c = s_p + S * S;                      // [kTile, S]

  const int w = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int np = min(kTile, P - p0);
  const int lane = threadIdx.x % kLanes;     // state i
  const int group = threadIdx.x / kLanes;    // patterns group + q * kGroups

  T prod[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) prod[q] = T(1);

  for (int k = 0; k < K; ++k) {
    const size_t wk = static_cast<size_t>(w) * K + k;
    const T* g_p = cp + wk * S * S;
    const T* g_c = cc + (wk * P + p0) * S;
    __syncthreads();  // the previous child's tiles are no longer read
    for (int e = threadIdx.x; e < S * S; e += kThreads) s_p[e] = g_p[e];
    for (int e = threadIdx.x; e < np * S; e += kThreads) s_c[e] = g_c[e];
    __syncthreads();
    if (lane < S) {
      T acc[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) acc[q] = T(0);
      const T* row = s_p + lane * S;
      for (int j = 0; j < S; ++j) {
        const T a = row[j];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int p = group + q * kGroups;
          // rows p >= np of s_c are stale; their sums are never stored
          acc[q] = fma(a, s_c[p * S + j], acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) prod[q] *= acc[q];
    }
  }
  if (lane < S) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int p = group + q * kGroups;
      if (p < np) out[(static_cast<size_t>(w) * P + p0 + p) * S + lane] = prod[q];
    }
  }
}

template <typename T>
int launch(const T* cc, const T* cp, T* out, int W, int K, int P, int S,
           cudaStream_t stream) {
  if (S < 1 || S > kLanes || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0 || P == 0) return 0;
  constexpr int kTile = TileP<T>::value;
  const dim3 grid((P + kTile - 1) / kTile, W);
  const size_t smem = static_cast<size_t>(S * S + kTile * S) * sizeof(T);
  level_products_kernel<T><<<grid, kThreads, smem, stream>>>(cc, cp, out, K, P, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int level_products_f32(const float* cc, const float* cp, float* out,
                                  int W, int K, int P, int S, void* stream) {
  return launch<float>(cc, cp, out, W, K, P, S, static_cast<cudaStream_t>(stream));
}

extern "C" int level_products_f64(const double* cc, const double* cp, double* out,
                                  int W, int K, int P, int S, void* stream) {
  return launch<double>(cc, cp, out, W, K, P, S, static_cast<cudaStream_t>(stream));
}
