// One decorrelation pass on one sample, shared by the decode kernel
// (decorr.cu) and the encode kernels (encode_invert.cu, encode_hybrid.cu),
// so that the state an encoder carries evolves bit for bit as the
// decoder's will; and a lane's whole chain of passes, fixed at compile
// time (ChainState, one instantiation per chain of WVPK_CHAIN_TABLE) or
// read at run time (GenericState), for the kernels that scan a lane.
//
// The apply is the decode direction (UnpackUtils.cs:688-1240): the
// predictor is (w * sam + 512) >> 10 in 64 bits truncated to int32, the
// output adds it to the value with int32 wrap; weights move by +/-delta on
// sign agreement, clamped to +/-1024 for the cross-channel terms -1, -2,
// -3; each pass keeps an 8-deep history ring per channel (positive terms
// index it by sample slot m, 17/18 shift it, cross terms keep the other
// channel's output in slot 0). The peel is the encode direction: it
// subtracts the same prediction from the pass's output, reading the state
// without changing it; its cross terms -1/-2 read the partner's value
// before this pass's peel (the apply's output of that pass).

#pragma once

#include <cstddef>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace wvpk {

constexpr int MAX_NTERMS = 16;
constexpr int MAX_TERM = 8;

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int pred(int w, int sam) {
  return (int)(((long long)w * sam + 512) >> 10);
}

__device__ __forceinline__ int upd(int w, int delta, int sam, int v) {
  if (sam != 0 && v != 0) w += (sam ^ v) < 0 ? -delta : delta;
  return w;
}

__device__ __forceinline__ int upd_clamp(int w, int delta, int sam, int v) {
  if (sam != 0 && v != 0)
    w = (sam ^ v) < 0 ? max(w - delta, -1024) : min(w + delta, 1024);
  return w;
}

__device__ __forceinline__ int sam17(const int* r) {
  return (int)(2u * (unsigned)r[0] - (unsigned)r[1]);
}

__device__ __forceinline__ int sam18(const int* r) {
  return ((int)(3u * (unsigned)r[0] - (unsigned)r[1])) >> 1;
}

// The predictor input a pass of term tv reads from its own ring at sample
// slot m (cross-channel and invalid terms: slot 0).
__device__ __forceinline__ int ring_sam(int tv, const int* R, int m) {
  if (tv >= 1 && tv <= MAX_TERM) return R[m];
  if (tv == 17) return sam17(R);
  if (tv == 18) return sam18(R);
  return R[0];
}

// Mono apply of pass (tv, d) with weight w and ring A: returns the output.
__device__ __forceinline__ int apply_mono(int tv, int d, int& w, int* A,
                                          int m, int va) {
  int sa = ring_sam(tv, A, m);
  int oa = add32(pred(w, sa), va);
  w = upd(w, d, sa, va);
  if (tv >= 1 && tv <= MAX_TERM) {
    A[(m + tv) & 7] = oa;
  } else if (tv == 17 || tv == 18) {
    A[1] = A[0];
    A[0] = oa;
  }
  return oa;
}

// Stereo apply of pass (tv, d): (va, vb) in, the pass's outputs out.
__device__ __forceinline__ void apply_stereo(int tv, int d, int& wa, int& wb,
                                             int* A, int* B, int m, int& va,
                                             int& vb) {
  int oa, ob;
  if (tv >= 1 && tv <= MAX_TERM) {
    int sa = A[m], sb = B[m];
    oa = add32(pred(wa, sa), va);
    ob = add32(pred(wb, sb), vb);
    wa = upd(wa, d, sa, va);
    wb = upd(wb, d, sb, vb);
    A[(m + tv) & 7] = oa;
    B[(m + tv) & 7] = ob;
  } else if (tv == 17 || tv == 18) {
    int sa = tv == 17 ? sam17(A) : sam18(A);
    int sb = tv == 17 ? sam17(B) : sam18(B);
    oa = add32(pred(wa, sa), va);
    ob = add32(pred(wb, sb), vb);
    wa = upd(wa, d, sa, va);
    wb = upd(wb, d, sb, vb);
    A[1] = A[0];
    A[0] = oa;
    B[1] = B[0];
    B[0] = ob;
  } else if (tv == -1) {            // A first, its output feeds B
    int sa = A[0];
    oa = add32(pred(wa, sa), va);
    ob = add32(pred(wb, oa), vb);
    wa = upd_clamp(wa, d, sa, va);
    wb = upd_clamp(wb, d, oa, vb);
    A[0] = ob;
  } else if (tv == -2) {            // B first, its output feeds A
    int sb = B[0];
    ob = add32(pred(wb, sb), vb);
    oa = add32(pred(wa, ob), va);
    wa = upd_clamp(wa, d, ob, va);
    wb = upd_clamp(wb, d, sb, vb);
    B[0] = oa;
  } else if (tv == -3) {
    int sa = A[0], sb = B[0];
    oa = add32(pred(wa, sa), va);
    ob = add32(pred(wb, sb), vb);
    wa = upd_clamp(wa, d, sa, va);
    wb = upd_clamp(wb, d, sb, vb);
    A[0] = ob;
    B[0] = oa;
  } else {  // no valid term class: predicts from slot 0, ring unchanged
    int sa = A[0], sb = B[0];
    oa = add32(pred(wa, sa), va);
    ob = add32(pred(wb, sb), vb);
    wa = upd(wa, d, sa, va);
    wb = upd(wb, d, sb, vb);
  }
  va = oa;
  vb = ob;
}

// Mono peel of pass tv: the pass's input given its output va.
__device__ __forceinline__ int peel_mono(int tv, int w, const int* A, int m,
                                         int va) {
  return sub32(va, pred(w, ring_sam(tv, A, m)));
}

// Stereo peel of pass tv: (va, vb) the pass's outputs in, its inputs out.
__device__ __forceinline__ void peel_stereo(int tv, int wa, int wb,
                                            const int* A, const int* B,
                                            int m, int& va, int& vb) {
  int sa = tv == -2 ? vb : ring_sam(tv, A, m);
  int sb = tv == -1 ? va : ring_sam(tv, B, m);
  int ia = sub32(va, pred(wa, sa));
  vb = sub32(vb, pred(wb, sb));
  va = ia;
}

// The final state of a lane whose chain has n passes, for the kernels
// that return it (encode_invert.cu): any struct with the seeds' arrays and
// (L, 16) / (L, 16, 8) int32 outputs wa_out, wb_out, ha_out and hb_out
// (mono: the b arrays neither read nor written). The chain's `store`
// writes its n passes; the slots past them keep their seeds, here.
template <bool MONO, class A>
__device__ __forceinline__ void store_seeds(const A& a, int lane, int n) {
  for (int k = n; k < MAX_NTERMS; ++k) {
    const int i = lane * MAX_NTERMS + k;
    a.wa_out[i] = a.wa0[i];
    if (!MONO) a.wb_out[i] = a.wb0[i];
    for (int j = 0; j < 8; ++j) {
      a.ha_out[i * 8 + j] = a.hist_a[i * 8 + j];
      if (!MONO) a.hb_out[i * 8 + j] = a.hist_b[i * 8 + j];
    }
  }
}

// The I-th of the terms TV...
template <int I, int T0, int... TV>
struct TermAt {
  static constexpr int value = TermAt<I - 1, TV...>::value;
};
template <int T0, int... TV>
struct TermAt<0, T0, TV...> {
  static constexpr int value = T0;
};

// The state of a chain fixed at compile time, its terms TV... in pass
// order. Every index below is a constant once the caller's step loop has
// made the ring slot m one (decorr.cu unrolls it by 8; encode_hybrid.cu
// and encode_invert.cu switch on t & 7), so the weights and rings are
// registers.
// `load` reads lane `lane`'s seeds from any struct with the (L, 16) /
// (L, 16, 8) int32 arrays deltas, wa0, wb0, hist_a and hist_b.
template <bool MONO, int... TV>
struct ChainState {
  static constexpr int K = sizeof...(TV);
  int d[K], wa[K], wb[K], ra[K][8], rb[K][8];

  template <class A>
  __device__ __forceinline__ void load(const A& a, int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane * MAX_NTERMS + k;
      d[k] = a.deltas[i];
      wa[k] = a.wa0[i];
      wb[k] = MONO ? 0 : a.wb0[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ra[k][j] = a.hist_a[i * 8 + j];
        rb[k][j] = MONO ? 0 : a.hist_b[i * 8 + j];
      }
    }
  }

  template <size_t... I>
  __device__ __forceinline__ void passes(std::index_sequence<I...>, int m,
                                         int& va, int& vb) {
    if constexpr (MONO)
      ((va = apply_mono(TV, d[I], wa[I], ra[I], m, va)), ...);
    else
      (apply_stereo(TV, d[I], wa[I], wb[I], ra[I], rb[I], m, va, vb), ...);
  }

  // the passes in reverse order (K - 1 - I), reading the state
  template <size_t... I>
  __device__ __forceinline__ void peels(std::index_sequence<I...>, int m,
                                        int& va, int& vb) const {
    if constexpr (MONO)
      ((va = peel_mono(TermAt<K - 1 - I, TV...>::value, wa[K - 1 - I],
                       ra[K - 1 - I], m, va)),
       ...);
    else
      (peel_stereo(TermAt<K - 1 - I, TV...>::value, wa[K - 1 - I],
                   wb[K - 1 - I], ra[K - 1 - I], rb[K - 1 - I], m, va, vb),
       ...);
  }

  // The decode direction: a sample's residuals in, its output out.
  __device__ __forceinline__ void apply(int m, int& va, int& vb) {
    passes(std::make_index_sequence<K>{}, m, va, vb);
  }

  // The encode direction: a sample's targets in, the residuals the chain
  // leaves out (apply then advances the state).
  __device__ __forceinline__ void peel(int m, int& va, int& vb) const {
    peels(std::make_index_sequence<K>{}, m, va, vb);
  }

  // The carried weights and rings (ring slots absolute), then the seeds
  // of the slots past the chain (store_seeds).
  template <class A>
  __device__ __forceinline__ void store(const A& a, int lane) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane * MAX_NTERMS + k;
      a.wa_out[i] = wa[k];
      if (!MONO) a.wb_out[i] = wb[k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a.ha_out[i * 8 + j] = ra[k][j];
        if (!MONO) a.hb_out[i * 8 + j] = rb[k][j];
      }
    }
    store_seeds<MONO>(a, lane, K);
  }
};

// Any chain, read from the lane's arrays at run time (local memory); `load`
// also reads terms and num_terms.
template <bool MONO>
struct GenericState {
  int nt;
  int term[MAX_NTERMS], d[MAX_NTERMS], wa[MAX_NTERMS], wb[MAX_NTERMS];
  int ra[MAX_NTERMS][8], rb[MAX_NTERMS][8];

  template <class A>
  __device__ __forceinline__ void load(const A& a, int lane) {
    nt = min(max(a.num_terms[lane], 0), MAX_NTERMS);
    for (int k = 0; k < nt; ++k) {
      const int i = lane * MAX_NTERMS + k;
      term[k] = a.terms[i];
      d[k] = a.deltas[i];
      wa[k] = a.wa0[i];
      wb[k] = MONO ? 0 : a.wb0[i];
      for (int j = 0; j < 8; ++j) {
        ra[k][j] = a.hist_a[i * 8 + j];
        rb[k][j] = MONO ? 0 : a.hist_b[i * 8 + j];
      }
    }
  }

  __device__ __forceinline__ void apply(int m, int& va, int& vb) {
    for (int k = 0; k < nt; ++k) {
      if (MONO)
        va = apply_mono(term[k], d[k], wa[k], ra[k], m, va);
      else
        apply_stereo(term[k], d[k], wa[k], wb[k], ra[k], rb[k], m, va, vb);
    }
  }

  __device__ __forceinline__ void peel(int m, int& va, int& vb) const {
    for (int k = nt - 1; k >= 0; --k) {
      if (MONO)
        va = peel_mono(term[k], wa[k], ra[k], m, va);
      else
        peel_stereo(term[k], wa[k], wb[k], ra[k], rb[k], m, va, vb);
    }
  }

  template <class A>
  __device__ __forceinline__ void store(const A& a, int lane) const {
    for (int k = 0; k < nt; ++k) {
      const int i = lane * MAX_NTERMS + k;
      a.wa_out[i] = wa[k];
      if (!MONO) a.wb_out[i] = wb[k];
      for (int j = 0; j < 8; ++j) {
        a.ha_out[i * 8 + j] = ra[k][j];
        if (!MONO) a.hb_out[i * 8 + j] = rb[k][j];
      }
    }
    store_seeds<MONO>(a, lane, nt);
  }
};

// The chains compiled into their own kernels: WVPK_CHAIN(id, mono,
// terms...) lines, expanded by each kernel source that defines
// WVPK_CHAIN (decorr.cu, encode_hybrid.cu, encode_invert.cu). Their ids,
// channel counts and terms are ops/decorr_cuda.py::CHAINS, in order (a
// test holds them equal): the bench chain and the encoder presets, the
// mono chains those without their cross-channel terms.
#define WVPK_CHAIN_TABLE                                   \
  WVPK_CHAIN(0, false, 18, 17, 2)                          \
  WVPK_CHAIN(1, false, 17, 17)                             \
  WVPK_CHAIN(2, false, 18, 18, 2, 17, 3)                   \
  WVPK_CHAIN(3, false, 18, 18, 18, -2, 2, 3, 5, -1, 17, 4) \
  WVPK_CHAIN(4, true, 18, 17, 2)                           \
  WVPK_CHAIN(5, true, 17, 17)                              \
  WVPK_CHAIN(6, true, 18, 18, 2, 17, 3)                    \
  WVPK_CHAIN(7, true, 18, 18, 18, 2, 3, 5, 17, 4)

// The chains only the decode kernel compiles (decorr.cu), ids after
// WVPK_CHAIN_TABLE's and CHAINS' rows after its rows: the 16 terms of
// WavPack's very high mode (wavpack -hh), the mono chain without the
// cross-channel terms. The encoder writes no such chain, so the encode
// sources do not expand this table.
#define WVPK_DECODE_CHAIN_TABLE                                            \
  WVPK_CHAIN(8, false, 18, 18, 2, 3, -2, 18, 2, 4, 7, 5, 3, 6, 8, -1, 18, 2) \
  WVPK_CHAIN(9, true, 18, 18, 2, 3, 18, 2, 4, 7, 5, 3, 6, 8, 18, 2)

}  // namespace wvpk
