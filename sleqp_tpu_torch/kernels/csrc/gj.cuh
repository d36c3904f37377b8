// The in-register Gauss-Jordan inverse that bgj.cu (B1, and B2's 16 x 16
// leaves) and thomas.cu (B3's stage inverses) share.  Plain C++ apart from
// __device__, float4 and shuffles, so tools/emulate_thomas.py compiles it
// as it is.
//
// M = C^-1 for an SPD kp x kp tile C (identity beyond k) by k unpivoted
// sweeps.  The tile lies in the registers of the threads that invert it:
// thread (c, r0) holds rows r0 + u (u < RPT, r0 a multiple of RPT) of
// column c, so kp (kp / RPT) threads hold the tile.  The caller loads w
// in that layout and stores it back; the layout of the tile in memory is
// its own.  Before sweep j, W holds the inverse's columns < j and the
// reduced matrix's columns >= j; the sweep is W[i][c] -= f_i W[j][c] / piv_j
// with f = W[:, j] - e_j, and column j becomes fma(-f_i, 1/piv_j, delta_ij):
// the tableau [A | I]'s arithmetic on the entries that are not trivially
// 0 or 1, so M equals the tableau's (bgj_flat_plain's) bit for bit with
// half its FMAs.  The pivot row is divided by a true IEEE division.  No
// pivoting: C is SPD, and every leading principal block of an SPD matrix
// is PD.
//
// F (2 kp floats, 16-byte aligned) holds the pivot column of two sweeps,
// and R (the same) their pivot row, so one sync a sweep suffices: sweep
// j + 2 writes slot j & 1 only after every thread has passed sweep j + 1's
// sync, and so has read sweep j's.  `sync` orders the threads that hold
// the tile: a block or named barrier, or __syncwarp where one warp holds
// it.
//
// Where one warp holds the tile (B2's 16 x 16 leaves), the pivot row comes
// by shuffles as soon as each sweep has row j+1, and the division
// overlaps the sync and the loads of the pivot column (gj_sweep_warp).
// Such a tile runs all kp sweeps, so the code is straight: the sweeps past
// k meet the identity padding (pivot 1, f = 0) and change nothing, bit for
// bit.
#pragma once

// Whether one warp holds a tile of width KP at RPT rows a thread.
template <int KP, int RPT>
constexpr bool kWarpHeld = KP * (KP / RPT) == 32;

// Sweep j = j0 + JJ, then the rest of the j0 block's (templates, so the
// register indices below are constants), where several warps hold the
// tile.  The threads that hold row j publish it to slot JJ & 1 of R, the
// thread of each row group that holds column j publishes its entries to F
// and sets them to e_j's; one sync; then each thread divides its column's
// pivot-row entry by the pivot (1/piv at column j) and makes one FMA per
// entry, row j+1's first.  Warps without column j skip its branch whole
// (`mine`: a warp holds columns of one 32-aligned range).
template <int KP, int RPT, int JJ, class Sync>
__device__ __forceinline__ void gj_sweep(float (&w)[RPT], int j0, int k, float* R, float* F, int c,
                                         int r0, const Sync& sync) {
  constexpr int p = JJ & 1, un = (JJ + 1) % RPT;
  const int j = j0 + JJ;
  if (j >= k) return;
  float* Rj = R + p * KP;
  float* Fj = F + p * KP;
  const bool pivot_rows = r0 == j0;  // this thread holds row j
  const bool mine = ((c ^ j) & ~31) == 0;
  if (pivot_rows) Rj[c] = w[JJ];
  if (mine && c == j) {
#pragma unroll
    for (int u = 0; u < RPT; u += 4) {
      *reinterpret_cast<float4*>(Fj + r0 + u) = make_float4(w[u], w[u + 1], w[u + 2], w[u + 3]);
    }
#pragma unroll
    for (int u = 0; u < RPT; ++u) w[u] = 0.0f;
    if (pivot_rows) w[JJ] = 1.0f;
  }
  sync();
  const float rc = (c == j ? 1.0f : Rj[c]) / Rj[j];
  float f[RPT];
#pragma unroll
  for (int u = 0; u < RPT; u += 4) {
    const float4 v = *reinterpret_cast<const float4*>(Fj + r0 + u);
    f[u] = v.x, f[u + 1] = v.y, f[u + 2] = v.z, f[u + 3] = v.w;
  }
  if (pivot_rows) f[JJ] -= 1.0f;
  w[un] = fmaf(-f[un], rc, w[un]);
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    if (u != un) w[u] = fmaf(-f[u], rc, w[u]);
  }
  if constexpr (JJ + 1 < RPT) gj_sweep<KP, RPT, JJ + 1>(w, j0, k, R, F, c, r0, sync);
}

// Column c's pivot-row entry and the pivot of sweep J of a warp-held
// tile, by shuffles: x is this lane's entry of row J if its row group
// holds row J (the lanes KP (J / RPT) + column).
template <int KP, int RPT, int J>
__device__ __forceinline__ void gj_pivot_row(float x, int c, float& rj, float& piv) {
  constexpr int src = KP * (J / RPT);
  rj = __shfl_sync(0xffffffffu, x, src + c);
  piv = __shfl_sync(0xffffffffu, x, src + J);
}

// Sweep J of a warp-held tile, given column c's pivot-row entry rj and the
// pivot, then the later sweeps.  The lane of each row group that holds
// column J publishes its entries to F; the division; a sync; one FMA per
// entry, row J+1's first, the lanes of column J adding to e_J's entries in
// place of theirs; the next sweep's pivot row by shuffles as soon as row
// J+1 is done; the other FMAs.  In this order the division's latency
// overlaps the sync and the loads of F, and the shuffles the FMAs.
template <int KP, int RPT, int J, class Sync>
__device__ __forceinline__ void gj_sweep_warp(float (&w)[RPT], float* F, int c, int r0, float rj,
                                              float piv, const Sync& sync) {
  constexpr int JJ = J % RPT, un = (JJ + 1) % RPT;
  float* Fj = F + (J & 1) * KP;
  const bool pivot_rows = r0 == J - JJ;  // this lane holds row J
  const bool pivot_col = c == J;
  if (pivot_col) {
#pragma unroll
    for (int u = 0; u < RPT; u += 4) {
      *reinterpret_cast<float4*>(Fj + r0 + u) = make_float4(w[u], w[u + 1], w[u + 2], w[u + 3]);
    }
  }
  const float rc = (pivot_col ? 1.0f : rj) / piv;
  sync();
  float f[RPT];
#pragma unroll
  for (int u = 0; u < RPT; u += 4) {
    const float4 v = *reinterpret_cast<const float4*>(Fj + r0 + u);
    f[u] = v.x, f[u + 1] = v.y, f[u + 2] = v.z, f[u + 3] = v.w;
  }
  if (pivot_rows) f[JJ] -= 1.0f;
  const float one = pivot_rows ? 1.0f : 0.0f;  // e_J's entry in row JJ of this lane
  w[un] = fmaf(-f[un], rc, pivot_col ? (un == JJ ? one : 0.0f) : w[un]);
  float rj_next = 0.0f, piv_next = 0.0f;
  if constexpr (J + 1 < KP) gj_pivot_row<KP, RPT, J + 1>(w[un], c, rj_next, piv_next);
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    if (u != un) w[u] = fmaf(-f[u], rc, pivot_col ? (u == JJ ? one : 0.0f) : w[u]);
  }
  if constexpr (J + 1 < KP) gj_sweep_warp<KP, RPT, J + 1>(w, F, c, r0, rj_next, piv_next, sync);
}

// The sweeps on the tile in w (this thread's rows r0 .. r0 + RPT - 1 of
// column c), leaving M in w.  RPT is a multiple of 4 (16-byte pieces of F)
// and divides kp, and every thread that holds the tile calls it (where one
// warp holds it, every lane of the warp).
template <int KP, int RPT, class Sync>
__device__ __forceinline__ void gauss_jordan(float (&w)[RPT], int k, float* R, float* F, int c,
                                             int r0, const Sync& sync) {
  static_assert(RPT % 4 == 0 && KP % RPT == 0, "rows a thread: a multiple of 4 dividing kp");
  if constexpr (kWarpHeld<KP, RPT>) {
    float rj, piv;
    gj_pivot_row<KP, RPT, 0>(w[0], c, rj, piv);
    gj_sweep_warp<KP, RPT, 0>(w, F, c, r0, rj, piv, sync);
  } else {
    for (int j0 = 0; j0 < k; j0 += RPT) gj_sweep<KP, RPT, 0>(w, j0, k, R, F, c, r0, sync);
  }
}

// The sync of a tile that one warp holds.
struct WarpSync {
  __device__ void operator()() const { __syncwarp(); }
};
