// Smith-Waterman column scan for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA FFI (ops/sw_cuda.py builds and registers it).
//
// One warp aligns one (query, target) pair; a block holds kWarps pairs.
// The query is cut into stripes of 32 * R rows.  Lane l owns rows
// [l * R, l * R + R) of a stripe and keeps their H and E in registers.
// The target columns are the loop: at step s lane l computes column
// s - l, so the warp is a wavefront along the anti-diagonal, and
// __shfl_up_sync hands each lane's bottom row (H, the F entering the next
// row, and the running column maximum with its row) to the lane below.
// The last lane of a stripe keeps that bottom row per column in a global
// carry buffer, which the next stripe's lane 0 reads.  The stripe's query
// profile (sub[q_i][a] + bias_i, as int8) sits in shared memory; no score
// grid is written to device memory.
//
// The results equal ops/sw_tiled.sw_scan_core bit for bit:
//   * affine gaps with the local-alignment clamp at 0, F from the gap-free
//     cell value of the row above, E from the previous column;
//   * (score, gj, gi): the first column whose maximum strictly exceeds the
//     running best, and the smallest row holding that maximum;
//   * (found, fj, fi): the first column whose maximum equals `terminate`;
//   * columns at or past a pair's tlen, and rows at or past its qlen, are
//     never computed.
// The column maximum travels down the wavefront as a key
// (H << 5) + (31 - k), so one max per cell keeps both the value and the
// smallest row.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarps = 4;              // pairs per block
constexpr int kMaxRows = 32 * 16;      // stripe height at R = 16
constexpr int kNeg = -(1 << 30);
constexpr int kKeyShift = 5;           // room for 31 - k, R <= 32
constexpr int kBadKey = -(1 << 30);    // rows past qlen never win a max
constexpr unsigned kFull = 0xffffffffu;

struct Pair {
  int qoff, qlen, toff, tlen, term;
};

template <bool REV>
__device__ __forceinline__ int target_token(const int8_t* __restrict__ tdata,
                                            const Pair& p, int j) {
  if (j < 0 || j >= p.tlen) return 0;
  return tdata[REV ? p.toff + p.tlen - 1 - j : p.toff + j];
}

// Builds this lane's rows of the stripe profile: prof[a * ROWS + lane * R + k]
// = int8(sub[q_i * A + a] + bias_i), 0 for rows past qlen.
template <int R, bool REV>
__device__ __forceinline__ void build_profile(
    const int8_t* __restrict__ qdata, const int8_t* __restrict__ qbias,
    const int* __restrict__ sub_s, int A, int8_t* __restrict__ prof,
    const Pair& p, int r0, int lane) {
  constexpr int ROWS = 32 * R;
  int tok[R], bias[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = r0 + k;
    if (i < p.qlen) {
      const int idx = REV ? p.qoff + p.qlen - 1 - i : p.qoff + i;
      tok[k] = qdata[idx];
      bias[k] = qbias[idx];
    } else {
      tok[k] = -1;
      bias[k] = 0;
    }
  }
  for (int a = 0; a < A; ++a) {
    unsigned* dst = reinterpret_cast<unsigned*>(prof + a * ROWS + lane * R);
#pragma unroll
    for (int w = 0; w < R / 4; ++w) {
      unsigned word = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * w + c;
        const int v = tok[k] >= 0 ? sub_s[tok[k] * A + a] + bias[k] : 0;
        word |= static_cast<unsigned>(v & 0xff) << (8 * c);
      }
      dst[w] = word;
    }
  }
}

template <int R>
__device__ __forceinline__ void load_scores(const int8_t* __restrict__ row,
                                            int (&sc)[R]) {
  unsigned w[R / 4];
  if constexpr (R == 16) {
    const int4 v = *reinterpret_cast<const int4*>(row);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (R == 8) {
    const int2 v = *reinterpret_cast<const int2*>(row);
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
      w[i] = reinterpret_cast<const unsigned*>(row)[i];
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    sc[k] = static_cast<int>(static_cast<int8_t>(w[k >> 2] >> (8 * (k & 3))));
}

template <int R, bool REV>
__device__ void align_pair(const int8_t* __restrict__ qdata,
                           const int8_t* __restrict__ qbias,
                           const int8_t* __restrict__ tdata,
                           const int* __restrict__ sub_s, int A,
                           int8_t* __restrict__ prof, const Pair& p, int go,
                           int ge, int4* __restrict__ carry, int lt, int lane,
                           int* __restrict__ out, int b, int B) {
  constexpr int ROWS = 32 * R;
  int gmax = 0, gj = -1, gi = 0, found = 0, fj = -1, fi = 0;
  const int nstripes = (p.qlen + ROWS - 1) / ROWS;
  int collector = 0;
  for (int s = 0; s < nstripes; ++s) {
    const int base = s * ROWS;
    const int r0 = base + lane * R;
    // lanes below the query's last row do no work; the lowest lane that
    // holds a row collects the column maxima
    const int last = min(31, (p.qlen - 1 - base) / R);
    const bool final_stripe = s == nstripes - 1;
    collector = last;
    build_profile<R, REV>(qdata, qbias, sub_s, A, prof, p, r0, lane);

    int H[R], E[R], ck[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      H[k] = 0;
      E[k] = kNeg;
      ck[k] = r0 + k < p.qlen ? 31 - k : kBadKey;
    }
    int hdiag = 0;  // H[r0 - 1][j - 1]
    int h_out = 0, f_out = kNeg, cm_out = -1, cr_out = 0;
    // carry halves alternate: one is read (previous stripe), one written
    const int4* cin = carry == nullptr ? nullptr : carry + ((s + 1) & 1) * lt;
    int4* cout = carry == nullptr ? nullptr : carry + (s & 1) * lt;
    const bool working = lane <= last;
    const int steps = p.tlen + last;
    int t_next = target_token<REV>(tdata, p, -lane);
    for (int st = 0; st < steps; ++st) {
      int h_up = __shfl_up_sync(kFull, h_out, 1);
      int f_up = __shfl_up_sync(kFull, f_out, 1);
      int cm_up = __shfl_up_sync(kFull, cm_out, 1);
      int cr_up = __shfl_up_sync(kFull, cr_out, 1);
      const int j = st - lane;
      const int t = t_next;
      t_next = target_token<REV>(tdata, p, j + 1);
      if (!working || j < 0 || j >= p.tlen) continue;
      if (lane == 0) {
        if (s == 0) {
          h_up = 0;
          f_up = kNeg;
          cm_up = -1;
          cr_up = 0;
        } else {
          const int4 c = cin[j];
          h_up = c.x;
          f_up = c.y;
          cm_up = c.z;
          cr_up = c.w;
        }
      }
      int sc[R];
      load_scores<R>(prof + t * ROWS + lane * R, sc);
      int diag = hdiag;
      int f = f_up;
      int key[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int e = __viaddmax_s32(E[k], -ge, H[k] - go);   // max(E-ge, H-go)
        const int hb = __vimax_s32_relu(diag + sc[k], e);     // max(d+s, E, 0)
        const int h = max(hb, f);
        f = __viaddmax_s32(f, -ge, hb - go);                  // F of row k+1
        diag = H[k];
        H[k] = h;
        E[k] = e;
        key[k] = (h << kKeyShift) + ck[k];
      }
      int best = key[0];
#pragma unroll
      for (int k = 1; k + 1 < R; k += 2) best = __vimax3_s32(best, key[k], key[k + 1]);
      if (R % 2 == 0) best = max(best, key[R - 1]);
      hdiag = h_up;
      h_out = H[R - 1];
      f_out = f;
      const int lh = best >> kKeyShift;
      if (lh > cm_up) {
        cm_out = lh;
        cr_out = r0 + 31 - (best & 31);
      } else {
        cm_out = cm_up;
        cr_out = cr_up;
      }
      if (lane == last) {
        if (final_stripe) {
          if (cm_out > gmax) {
            gmax = cm_out;
            gj = j;
            gi = cr_out;
          }
          if (!found && cm_out == p.term) {
            found = 1;
            fj = j;
            fi = cr_out;
          }
        } else {
          cout[j] = make_int4(h_out, f_out, cm_out, cr_out);
        }
      }
    }
    __syncwarp();
  }
  if (lane == collector) {
    out[0 * B + b] = gmax;
    out[1 * B + b] = gj;
    out[2 * B + b] = gi;
    out[3 * B + b] = found;
    out[4 * B + b] = fj;
    out[5 * B + b] = fi;
  }
}

template <bool REV>
__global__ void __launch_bounds__(32 * kWarps)
    sw_scan_kernel(const int8_t* __restrict__ qdata,
                   const int8_t* __restrict__ qbias,
                   const int8_t* __restrict__ tdata,
                   const int* __restrict__ sub, int A,
                   const int* __restrict__ params, int B, int go, int ge,
                   int lq, int lt, int4* __restrict__ carry,
                   int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sub_s = reinterpret_cast<int*>(smem);
  int8_t* prof_all =
      reinterpret_cast<int8_t*>(smem + ((A * A * 4 + 15) & ~15));
  for (int i = threadIdx.x; i < A * A; i += blockDim.x) sub_s[i] = sub[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  Pair p{params[b], min(params[B + b], lq), params[2 * B + b],
         min(params[3 * B + b], lt), params[4 * B + b]};
  int8_t* prof = prof_all + warp * A * kMaxRows;
  int4* c = carry == nullptr ? nullptr : carry + static_cast<size_t>(b) * 2 * lt;
  // rows per lane: R = 8 halves the work per step of a short query, R = 16
  // halves the number of stripes of a long one (cost ~ 6 : 11 per step)
  const int n8 = (p.qlen + 255) / 256;
  const int n16 = (p.qlen + 511) / 512;
  if (n16 * 11 <= n8 * 6)
    align_pair<16, REV>(qdata, qbias, tdata, sub_s, A, prof, p, go, ge, c, lt,
                        lane, out, b, B);
  else
    align_pair<8, REV>(qdata, qbias, tdata, sub_s, A, prof, p, go, ge, c, lt,
                       lane, out, b, B);
}

ffi::Error SwScanImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> qdata,
                      ffi::Buffer<ffi::S8> qbias, ffi::Buffer<ffi::S8> tdata,
                      ffi::Buffer<ffi::S32> sub, ffi::Buffer<ffi::S32> params,
                      ffi::ResultBuffer<ffi::S32> out,
                      ffi::ResultBuffer<ffi::S32> carry, int32_t reverse,
                      int32_t gap_open, int32_t gap_extend, int32_t lq,
                      int32_t lt) {
  const int A = static_cast<int>(sub.dimensions()[0]);
  const int B = static_cast<int>(params.dimensions()[1]);
  if (A > 32 || sub.dimensions()[1] != A)
    return ffi::Error::InvalidArgument("substitution matrix must be square, <= 32");
  if (params.dimensions()[0] < 5)
    return ffi::Error::InvalidArgument("params must have 5 rows or more");
  // the carry buffer exists only for rungs whose queries span stripes
  const size_t need = static_cast<size_t>(B) * 2 * lt * 4;
  int4* cptr = (lq > kMaxRows && carry->element_count() >= need)
                   ? reinterpret_cast<int4*>(carry->typed_data())
                   : nullptr;
  if (lq > kMaxRows && cptr == nullptr)
    return ffi::Error::InvalidArgument("carry buffer too small");
  if (B == 0) return ffi::Error::Success();
  const size_t smem = ((A * A * 4 + 15) & ~15) +
                      static_cast<size_t>(kWarps) * A * kMaxRows;
  auto kern = reverse ? sw_scan_kernel<true> : sw_scan_kernel<false>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const dim3 grid((B + kWarps - 1) / kWarps);
  kern<<<grid, 32 * kWarps, smem, stream>>>(
      qdata.typed_data(), qbias.typed_data(), tdata.typed_data(),
      sub.typed_data(), A, params.typed_data(), B, gap_open, gap_extend, lq,
      lt, cptr, out->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SpacedustSwScan, SwScanImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("reverse")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend")
                                  .Attr<int32_t>("lq")
                                  .Attr<int32_t>("lt"));
