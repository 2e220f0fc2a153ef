// Speech-FSM window scan for Hopper (sm_90a).
//
// Replaces the TPU kernel formula_vad_tpu/pipeline/fsm_pallas.py::
// scan_windows_pallas (body _kernel, carry pack_carry/unpack_carry): B
// independent VADMachine instances, one per row, each stepping serially
// over its W 1024-sample windows — three rolling averages kept as
// Kahan-compensated float32 running sums, and the 4-state hysteresis
// machine whose long-term average freezes while the threshold is met.
// The window step is native/fvadfsm.cpp's, statement for statement, and the
// result is bit-identical to that host decoder on every output and on the
// carry (rings, registers and Kahan state).
//
// What bounds it on the H100: the dependency chain, not bytes. Window w + 1
// needs window w's decision, so each row is one serial chain; at the
// scoring shape (21 rows x 937 windows) the time is that chain's latency.
// Only part of the window step is on it: the short-term and ratio rings
// are pushed on every valid window, so their averages depend on the inputs
// alone. The loop-carried decision chain is long_last -> base * tf -> met
// -> the long ring's Kahan add -> lsum / long_cnt -> the next long_last.
//
// Two bodies, chosen by the host plan (pipeline/fsm_cuda.py::launch_plan)
// on ring size alone:
//
// * fsm_scan_smem, for rings that fit shared memory (up to 57,104 floats a
//   row at the smallest tile, a long-term window of ~20 min). One CTA of
//   five warps per row:
//   - the row's three rings live in dynamic shared memory for the whole
//     call: loaded once (cp.async) or, for a fresh carry, filled in place,
//     and written back once at the end, coalesced;
//   - window inputs (9 B a window) and per-window records move through
//     shared memory in tiles of `tile` windows, loaded and stored coalesced
//     by warps 3-4 (plain loads: rows of W windows are not 16-byte aligned,
//     so bulk copies would not take them);
//   - the window step is split into three serial chains, one lane each, a
//     tile apart: warp 0 computes the short-term and ratio averages (lanes
//     0 and 1, one ring each; the divisions then spread over the warp);
//     warp 1 runs only the long ring's chain and writes each window's
//     `met`; warp 2 runs the state machine and the per-segment stats from
//     `met` and records the registers each window finds. The copy warps
//     derive the seven outputs from those records (events, payloads, the
//     duration test's and seg_ratio's divisions), in parallel.
//   The roles run skewed and meet at one __syncthreads a tile: at step s the
//   copy warps load tile s and store tile s - 4, warp 0 takes tile s - 1,
//   warp 1 tile s - 2, warp 2 tile s - 3. No global memory access is left
//   on a serial chain, and no ring load waits on one: the slot a window
//   reads is prefetched during the window before. The lanes have no branch
//   but the long ring division's rare slow path: a push is computed whether
//   or not it happens and kept by selects, and the state machine's
//   else-ifs, which are exclusive, are selects too.
// * fsm_scan_global, larger rings: the first port's design, one thread per row with
//   the rings in global memory, the same window step.
//
// A fresh carry never leaves the card: the kernel fills the rings and the
// registers itself, and takes the Kahan seeds (the exact left fold of each
// fresh ring, a function of the configuration alone) from a [B, NK] array
// that the host computes once per content. Build with -fmad=false (never
// --use_fast_math): FMA contraction would change the Kahan rounding, as
// -ffp-contract=off guards in native/Makefile; nvcc's default
// -prec-div=true keeps '/' IEEE-rounded.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Register layout, identical to native/fvadfsm.cpp and fsm_pallas.py.
enum {
  I_LONG_IDX, I_LONG_CNT, I_SHORT_IDX, I_SHORT_CNT, I_RATIO_IDX,
  I_RATIO_CNT, I_STATE, I_START, I_END, I_SEG_CNT, NI
};
enum { F_LONG_LAST, F_SEG_SUM, F_MET_SEC, NF };
enum { NK = 6 };  // (sum, comp) x (long, short, ratio)
enum { CLOSED = 0, OPENING = 1, OPEN = 2, CLOSING = 3 };
enum { EV_NONE = 0, EV_STARTED = 1, EV_COMPLETED = 2, EV_ABORTED = 3 };

constexpr int GLOBAL_THREADS = 64;  // fsm_scan_global: one thread per row
constexpr int SMEM_THREADS = 160;   // fsm_scan_smem: averages, met, state machine, 2 copy warps
// The launch bounds ask ptxas for registers enough for at least four
// fsm_scan_smem CTAs an SM (at most 102 a thread). It is a floor, not a cap:
// how many CTAs an SM holds is set by the registers the build uses and by
// each CTA's shared memory. A floor of five (80 registers) cost the met lane
// ~7% a window on the H100 and did not make 660 rows faster.
constexpr int SMEM_MIN_BLOCKS = 4;
constexpr int COPY_THREADS = 64;
constexpr int IN_SLOTS = 4, AVG_SLOTS = 2, MET_SLOTS = 2, OUT_SLOTS = 2;

// The state machine's registers as a window finds them, with the window's
// valid and met flags, in the field order of its two 16-byte stores: the
// copy warps derive the window's seven outputs from them and its index.
struct __align__(16) Rec {
  int32_t state, seg_start, seg_end, seg_cnt;
  float seg_sum, met_sec;
  int32_t flags, pad;  // valid | met << 1
};

// Shared bytes a tile window (pipeline/fsm_cuda.py::TILE_BYTES): records
// 32 B x 2 slots, inputs 9 B x 4, averages 8 B x 2 and their counts 8 B,
// met 1 B x 2.
constexpr int TILE_BYTES = sizeof(Rec) * OUT_SLOTS + 9 * IN_SLOTS + 8 * AVG_SLOTS + 8 + MET_SLOTS;

struct Args {
  int n_rows, n_windows, tile, long_window, short_window, ratio_window;
  int has_initial_avg, fft_size, sample_rate, fresh;
  float window_sec;
  const float *threshold_factor, *ratio_threshold;
  const int32_t *min_consecutive_samples, *max_gap_samples;
  const float *min_duration_sec, *initial_avg;
  const float *min_volumes, *volume_ratios;
  const uint8_t *valids;
  const int32_t *win_base;  // null: 0 for every row
  // carry in (null when fresh) and out
  const float *in_long, *in_short, *in_ratio;
  const int32_t *in_ireg;
  const float *in_freg, *in_kahan;
  const float *fresh_kahan;  // [B, NK]: the fresh rings' exact left folds
  float *out_long, *out_short, *out_ratio;
  int32_t *out_ireg;
  float *out_freg, *out_kahan;
  int32_t *event, *event_win;
  uint8_t *seg_valid;
  int32_t *seg_start, *seg_end;
  float *seg_ratio, *seg_met;
};

__device__ __forceinline__ void kahan_add(float v, float &s, float &c) {
  float y = v - c;
  float t = s + y;
  c = (t - s) - y;
  s = t;
}

// int32 wraparound (signed overflow is undefined in C++).
__device__ __forceinline__ int32_t mul_i32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t sub_i32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t add_i32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
// (i + 1) % n for 0 <= i < n, without the integer division.
__device__ __forceinline__ int32_t next_slot(int32_t i, int32_t n) {
  return i + 1 == n ? 0 : i + 1;
}

// The short-term and ratio rolling averages (RollingAverage push/avg).
struct AvgState {
  int32_t short_idx, short_cnt, ratio_idx, ratio_cnt;
  float ssum, scomp, rsum, rcomp;
};

// The loop-carried decision state.
struct DecState {
  int32_t long_idx, long_cnt, state, start_win, end_win, seg_cnt;
  float long_last, seg_sum, met_sec, lsum, lcomp;
};

struct RowParams {
  float tf, rth, min_dur;
  int32_t min_consec, max_gap;
};

struct WinOut {
  int32_t ev, ev_win, seg_start, seg_end;
  float seg_ratio, seg_met;
  uint8_t seg_valid;
};

// One valid window's averages, in fvadfsm.cpp's order of operations.
__device__ __forceinline__ void avg_step(AvgState &a, float *sring, int S, float *rring, int R,
                                         float mv, float vr, float &short_avg, float &ratio_avg) {
  kahan_add(mv - sring[a.short_idx], a.ssum, a.scomp);
  sring[a.short_idx] = mv;
  a.short_idx = next_slot(a.short_idx, S);
  a.short_cnt = min(a.short_cnt + 1, S);
  short_avg = a.ssum / (float)a.short_cnt;

  kahan_add(vr - rring[a.ratio_idx], a.rsum, a.rcomp);
  rring[a.ratio_idx] = vr;
  a.ratio_idx = next_slot(a.ratio_idx, R);
  a.ratio_cnt = min(a.ratio_cnt + 1, R);
  ratio_avg = a.rsum / (float)a.ratio_cnt;
}

// An invalid window: inert outputs from the frozen carry.
__device__ __forceinline__ WinOut inert(const DecState &d) {
  WinOut o;
  o.ev = EV_NONE;
  o.ev_win = 0;
  o.seg_valid = 0;
  o.seg_start = d.start_win;
  o.seg_end = d.end_win;
  o.seg_ratio = d.seg_sum / (float)max(d.seg_cnt, 1);
  o.seg_met = d.met_sec;
  return o;
}

// One valid window's decision: met, the long ring, the state machine and
// the per-segment stats, given the window's two averages.
__device__ __forceinline__ WinOut decide_step(DecState &d, float *lring, const Args &a,
                                              const RowParams &p, float mv, float vr,
                                              float short_avg, float ratio_avg, int32_t win_idx) {
  const float old_long = lring[d.long_idx];  // off the chain: the index is known
  const float base =
      a.has_initial_avg ? d.long_last : (d.long_cnt > 0 ? d.long_last : short_avg);
  const bool met = (short_avg > base * p.tf) && (ratio_avg > p.rth);

  // The long-term average only advances while the threshold is NOT met.
  if (!met) {
    kahan_add(mv - old_long, d.lsum, d.lcomp);
    lring[d.long_idx] = mv;
    d.long_idx = next_slot(d.long_idx, a.long_window);
    d.long_cnt = min(d.long_cnt + 1, a.long_window);
    d.long_last = d.lsum / (float)d.long_cnt;
  }

  // --- state machine (entry-state transitions) ---
  const bool is_closed = d.state == CLOSED;
  const bool is_opening = d.state == OPENING;
  const bool is_open = d.state == OPEN;
  const bool is_closing = d.state == CLOSING;

  const bool opening_dur = mul_i32(sub_i32(win_idx, d.start_win), a.fft_size) >= p.min_consec;
  const bool closing_dur = mul_i32(sub_i32(win_idx, d.end_win), a.fft_size) >= p.max_gap;

  const bool t_closed_opening = is_closed && met;
  const bool t_opening_open = is_opening && met && opening_dur;
  const bool t_open_closing = is_open && !met;
  const bool t_closing_closed = is_closing && !met && closing_dur;

  const float length_sec =
      ((float)sub_i32(d.end_win, d.start_win) * (float)a.fft_size) / (float)a.sample_rate;
  const bool duration_met = length_sec >= p.min_dur;
  const bool seg_emitted = t_closing_closed && duration_met;

  WinOut o;
  o.ev = EV_NONE;
  if (t_opening_open) o.ev = EV_STARTED;
  if (seg_emitted) o.ev = EV_COMPLETED;
  if (t_closing_closed && !duration_met) o.ev = EV_ABORTED;
  o.ev_win = o.ev == EV_STARTED ? d.start_win : (o.ev == EV_COMPLETED ? d.end_win : 0);
  o.seg_valid = seg_emitted ? 1 : 0;
  o.seg_start = d.start_win;
  o.seg_end = d.end_win;
  o.seg_ratio = d.seg_sum / (float)max(d.seg_cnt, 1);
  o.seg_met = d.met_sec;

  // --- per-segment stats (trackSpeechStats, from the entry state) ---
  if (t_closed_opening) {
    d.seg_sum = vr;
    d.seg_cnt = 1;
    d.met_sec = a.window_sec;
  }
  if (is_open) {
    d.seg_sum = d.seg_sum + vr;
    d.seg_cnt = d.seg_cnt + 1;
    if (met) d.met_sec = d.met_sec + a.window_sec;
  }

  // --- transitions ---
  if (t_closed_opening) {
    d.state = OPENING;
    d.start_win = win_idx;
  } else if (is_opening) {
    d.state = met ? (opening_dur ? OPEN : OPENING) : CLOSED;
  } else if (t_open_closing) {
    d.state = CLOSING;
    d.end_win = win_idx;
  } else if (is_closing) {
    d.state = met ? OPEN : (closing_dur ? CLOSED : CLOSING);
  }
  return o;
}

__device__ __forceinline__ RowParams row_params(const Args &a, int64_t b) {
  RowParams p;
  p.tf = a.threshold_factor[b];
  p.rth = a.ratio_threshold[b];
  p.min_consec = a.min_consecutive_samples[b];
  p.max_gap = a.max_gap_samples[b];
  p.min_dur = a.min_duration_sec[b];
  return p;
}

// Row b's registers: from the given carry, or those of a fresh machine
// (fsm.fresh_carry) with the cached Kahan seeds.
__device__ __forceinline__ void load_avg(const Args &a, int64_t b, AvgState &s) {
  const float *k = (a.fresh ? a.fresh_kahan : a.in_kahan) + b * NK;
  if (a.fresh) {
    s.short_idx = s.short_cnt = s.ratio_idx = s.ratio_cnt = 0;
  } else {
    const int32_t *ir = a.in_ireg + b * NI;
    s.short_idx = ir[I_SHORT_IDX];
    s.short_cnt = ir[I_SHORT_CNT];
    s.ratio_idx = ir[I_RATIO_IDX];
    s.ratio_cnt = ir[I_RATIO_CNT];
  }
  s.ssum = k[2];
  s.scomp = k[3];
  s.rsum = k[4];
  s.rcomp = k[5];
}

__device__ __forceinline__ void load_dec(const Args &a, int64_t b, DecState &s) {
  const float *k = (a.fresh ? a.fresh_kahan : a.in_kahan) + b * NK;
  if (a.fresh) {
    s.long_idx = 0;
    s.long_cnt = a.has_initial_avg ? a.long_window : 0;
    s.state = CLOSED;
    s.start_win = s.end_win = s.seg_cnt = 0;
    s.long_last = a.has_initial_avg ? a.initial_avg[b] : 0.0f;
    s.seg_sum = s.met_sec = 0.0f;
  } else {
    const int32_t *ir = a.in_ireg + b * NI;
    const float *fr = a.in_freg + b * NF;
    s.long_idx = ir[I_LONG_IDX];
    s.long_cnt = ir[I_LONG_CNT];
    s.state = ir[I_STATE];
    s.start_win = ir[I_START];
    s.end_win = ir[I_END];
    s.seg_cnt = ir[I_SEG_CNT];
    s.long_last = fr[F_LONG_LAST];
    s.seg_sum = fr[F_SEG_SUM];
    s.met_sec = fr[F_MET_SEC];
  }
  s.lsum = k[0];
  s.lcomp = k[1];
}

__device__ __forceinline__ void store_avg(const Args &a, int64_t b, const AvgState &s) {
  int32_t *ir = a.out_ireg + b * NI;
  float *k = a.out_kahan + b * NK;
  ir[I_SHORT_IDX] = s.short_idx;
  ir[I_SHORT_CNT] = s.short_cnt;
  ir[I_RATIO_IDX] = s.ratio_idx;
  ir[I_RATIO_CNT] = s.ratio_cnt;
  k[2] = s.ssum;
  k[3] = s.scomp;
  k[4] = s.rsum;
  k[5] = s.rcomp;
}

__device__ __forceinline__ void store_dec(const Args &a, int64_t b, const DecState &s) {
  int32_t *ir = a.out_ireg + b * NI;
  float *fr = a.out_freg + b * NF;
  float *k = a.out_kahan + b * NK;
  ir[I_LONG_IDX] = s.long_idx;
  ir[I_LONG_CNT] = s.long_cnt;
  ir[I_STATE] = s.state;
  ir[I_START] = s.start_win;
  ir[I_END] = s.end_win;
  ir[I_SEG_CNT] = s.seg_cnt;
  fr[F_LONG_LAST] = s.long_last;
  fr[F_SEG_SUM] = s.seg_sum;
  fr[F_MET_SEC] = s.met_sec;
  k[0] = s.lsum;
  k[1] = s.lcomp;
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// ---------------------------------------------------------------------------
// Rings in shared memory: one CTA per row (see the file header).

// Warp roles of fsm_scan_smem.
enum { W_AVG = 0, W_MET = 1, W_FSM = 2, W_COPY = 3 };

// The short-term and ratio averages of one tile, for lanes 0 (short ring,
// min_volumes) and 1 (ratio ring, volume_ratios) at once: the serial Kahan
// sums and counts first, then the divisions spread over the warp. The ring
// value a window reads was prefetched during the window before, so no
// shared-memory load waits on the chain.
struct AvgLane {
  float *ring;
  int32_t n, idx, cnt;
  float sum, comp, old;
};

__global__ void __launch_bounds__(SMEM_THREADS, SMEM_MIN_BLOCKS)
fsm_scan_smem(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.tile, W = a.n_windows;
  const int L = a.long_window, S = a.short_window, R = a.ratio_window;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Tiles (see TILE_BYTES), then the rings. The state machine's records
  // first, 16-byte aligned: two 16-byte stores a window.
  Rec *rec = reinterpret_cast<Rec *>(smem);               // [OUT_SLOTS][T]
  float *in_mv = reinterpret_cast<float *>(rec + OUT_SLOTS * T);  // [IN_SLOTS][T]
  float *in_vr = in_mv + IN_SLOTS * T;               // [IN_SLOTS][T]
  float *avg_s = in_vr + IN_SLOTS * T;               // [AVG_SLOTS][T]: sums, then averages
  float *avg_r = avg_s + AVG_SLOTS * T;              // [AVG_SLOTS][T]
  int32_t *cnt_s = reinterpret_cast<int32_t *>(avg_r + AVG_SLOTS * T);  // [T], [T]: counts
  int32_t *cnt_r = cnt_s + T;
  uint8_t *in_va = reinterpret_cast<uint8_t *>(cnt_r + T);  // [IN_SLOTS][T]
  uint8_t *met_t = in_va + IN_SLOTS * T;                     // [MET_SLOTS][T]
  float *lring = reinterpret_cast<float *>(met_t + MET_SLOTS * T);  // T % 32 == 0: aligned
  float *sring = lring + L;
  float *rring = sring + S;

  // The rings, once: copied in without waiting for each load, or filled.
  if (a.fresh) {
    const float fill = a.has_initial_avg ? a.initial_avg[b] : 0.0f;
    for (int i = tid; i < L; i += SMEM_THREADS) lring[i] = fill;
    for (int i = tid; i < S + R; i += SMEM_THREADS) sring[i] = 0.0f;
  } else {
    const float *gl = a.in_long + b * L, *gs = a.in_short + b * S, *gr = a.in_ratio + b * R;
    for (int i = tid; i < L; i += SMEM_THREADS) cp_async4(lring + i, gl + i);
    for (int i = tid; i < S; i += SMEM_THREADS) cp_async4(sring + i, gs + i);
    for (int i = tid; i < R; i += SMEM_THREADS) cp_async4(rring + i, gr + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (W + T - 1) / T;
  const int64_t row = b * (int64_t)W;
  const bool lead = lane == 0;
  // Each role's registers, loaded by the lanes that own them.
  AvgState av;
  AvgLane al;
  DecState dc;
  RowParams prm;
  int32_t win = 0;  // the state-machine lane's window index
  float old_long = 0.0f;  // the met lane's prefetched ring value
  if (warp == W_AVG && lane < 2) {
    load_avg(a, b, av);
    const bool sh = lane == 0;
    al.ring = sh ? sring : rring;
    al.n = sh ? S : R;
    al.idx = sh ? av.short_idx : av.ratio_idx;
    al.cnt = sh ? av.short_cnt : av.ratio_cnt;
    al.sum = sh ? av.ssum : av.rsum;
    al.comp = sh ? av.scomp : av.rcomp;
    al.old = al.ring[al.idx];
  }
  if ((warp == W_MET || warp == W_FSM) && lead) {
    load_dec(a, b, dc);
    prm = row_params(a, b);
    win = a.win_base ? a.win_base[b] : 0;
    if (warp == W_MET) old_long = lring[dc.long_idx];
  }
  int32_t wb = 0;  // the copy warps' window base
  if (warp >= W_COPY) {
    prm = row_params(a, b);
    wb = a.win_base ? a.win_base[b] : 0;
  }

  // Step s: the copy warps load tile s and store tile s - 4; the averages
  // warp takes tile s - 1, the met lane tile s - 2, the state-machine lane
  // tile s - 3. Each reads only what an earlier step wrote.
  for (int s = 0; s < n_tiles + 4; ++s) {
    if (warp >= W_COPY) {
      const int c = tid - W_COPY * 32;
      if (s < n_tiles) {  // load tile s
        const int t0 = s * T, n = min(T, W - t0), slot = (s % IN_SLOTS) * T;
        for (int i = c; i < n; i += COPY_THREADS) {
          in_mv[slot + i] = a.min_volumes[row + t0 + i];
          in_vr[slot + i] = a.volume_ratios[row + t0 + i];
          in_va[slot + i] = a.valids[row + t0 + i];
        }
      }
      if (s >= 4) {  // outputs of tile s - 4, from the state machine's records
        const int k = s - 4, t0 = k * T, n = min(T, W - t0);
        const Rec *r = rec + (k % OUT_SLOTS) * T;
        for (int i = c; i < n; i += COPY_THREADS) {
          const int64_t o = row + t0 + i;
          const Rec e = r[i];
          const bool ok = e.flags & 1, met = e.flags >> 1;
          const int32_t win_idx = add_i32(wb, (int32_t)(t0 + i));
          // An invalid window enters no state: inert outputs.
          const bool is_opening = ok & (e.state == OPENING), is_closing = ok & (e.state == CLOSING);
          const bool t_opening_open =
              is_opening & met & (mul_i32(sub_i32(win_idx, e.seg_start), a.fft_size) >= prm.min_consec);
          const bool t_closing_closed =
              is_closing & !met & (mul_i32(sub_i32(win_idx, e.seg_end), a.fft_size) >= prm.max_gap);
          const bool dur_met =
              ((float)sub_i32(e.seg_end, e.seg_start) * (float)a.fft_size) / (float)a.sample_rate >=
              prm.min_dur;
          const bool emitted = t_closing_closed & dur_met;
          int32_t ev = t_opening_open ? EV_STARTED : EV_NONE;
          ev = emitted ? EV_COMPLETED : ev;
          ev = t_closing_closed & !dur_met ? EV_ABORTED : ev;
          a.event[o] = ev;
          a.event_win[o] = ev == EV_STARTED ? e.seg_start : (ev == EV_COMPLETED ? e.seg_end : 0);
          a.seg_valid[o] = emitted;
          a.seg_start[o] = e.seg_start;
          a.seg_end[o] = e.seg_end;
          a.seg_ratio[o] = e.seg_sum / (float)max(e.seg_cnt, 1);
          a.seg_met[o] = e.met_sec;
        }
      }
    } else if (warp == W_AVG) {
      if (s >= 1 && s - 1 < n_tiles) {  // averages of tile s - 1
        const int k = s - 1, n = min(T, W - k * T);
        const uint8_t *va = in_va + (k % IN_SLOTS) * T;
        float *sum = (lane == 0 ? avg_s : avg_r) + (k % AVG_SLOTS) * T;
        int32_t *cnt = lane == 0 ? cnt_s : cnt_r;
        if (lane < 2) {
          // Branch-free: an invalid window leaves the ring and sums as they
          // are. Each window's input is read a window ahead.
          const float *x = (lane == 0 ? in_mv : in_vr) + (k % IN_SLOTS) * T;
          float x_next = x[0];
          bool ok_next = va[0];
          for (int i = 0; i < n; ++i) {
            const float xi = x_next;
            const bool ok = ok_next;
            const int j = min(i + 1, n - 1);
            x_next = x[j];
            ok_next = va[j];
            const int32_t nxt = next_slot(al.idx, al.n);
            const float pre = al.ring[nxt];  // the next window's old value
            float sum_i = al.sum, comp_i = al.comp;
            kahan_add(xi - al.old, sum_i, comp_i);
            if (ok) al.ring[al.idx] = xi;
            al.sum = ok ? sum_i : al.sum;
            al.comp = ok ? comp_i : al.comp;
            al.cnt = ok ? min(al.cnt + 1, al.n) : al.cnt;
            al.old = ok ? (al.n == 1 ? xi : pre) : al.old;
            al.idx = ok ? nxt : al.idx;
            sum[i] = al.sum;  // unread for an invalid window
            cnt[i] = al.cnt;
          }
        }
        __syncwarp();
        float *as = avg_s + (k % AVG_SLOTS) * T, *ar = avg_r + (k % AVG_SLOTS) * T;
        for (int i = lane; i < n; i += 32) {
          if (!va[i]) continue;
          as[i] = as[i] / (float)cnt_s[i];
          ar[i] = ar[i] / (float)cnt_r[i];
        }
      }
    } else if (warp == W_MET) {
      if (lead && s >= 2 && s - 2 < n_tiles) {  // met of tile s - 2: the long ring's chain
        const int k = s - 2, n = min(T, W - k * T);
        const int in = (k % IN_SLOTS) * T, avg = (k % AVG_SLOTS) * T;
        const uint8_t *va = in_va + in;
        const float *mvp = in_mv + in, *sa = avg_s + avg, *ra = avg_r + avg;
        uint8_t *met_out = met_t + (k % MET_SLOTS) * T;
        // Each window's inputs are read a window ahead; an invalid window
        // changes nothing (its met is unread), by selects, not a branch.
        float mv_next = mvp[0], sa_next = sa[0], ra_next = ra[0];
        bool ok_next = va[0];
#pragma unroll 2
        for (int i = 0; i < n; ++i) {
          const float mv = mv_next, short_avg = sa_next, ratio_avg = ra_next;
          const bool ok = ok_next;
          const int j = min(i + 1, n - 1);
          mv_next = mvp[j];
          sa_next = sa[j];
          ra_next = ra[j];
          ok_next = va[j];
          const int32_t nxt = next_slot(dc.long_idx, L);
          const float pre = lring[nxt];  // the next window's old value if this one pushes
          const float base = a.has_initial_avg ? dc.long_last
                                               : (dc.long_cnt > 0 ? dc.long_last : short_avg);
          const bool met = (short_avg > base * prm.tf) & (ratio_avg > prm.rth);
          // The push, computed whether or not it happens, then kept only
          // while the threshold is NOT met.
          const bool push = ok & !met;
          float lsum = dc.lsum, lcomp = dc.lcomp;
          kahan_add(mv - old_long, lsum, lcomp);
          const int32_t cnt = min(dc.long_cnt + 1, L);
          const float last = lsum / (float)cnt;
          if (push) lring[dc.long_idx] = mv;
          dc.lsum = push ? lsum : dc.lsum;
          dc.lcomp = push ? lcomp : dc.lcomp;
          dc.long_last = push ? last : dc.long_last;
          dc.long_cnt = push ? cnt : dc.long_cnt;
          old_long = push ? (L == 1 ? mv : pre) : old_long;
          dc.long_idx = push ? nxt : dc.long_idx;
          met_out[i] = met;
        }
      }
    } else if (lead && s >= 3 && s - 3 < n_tiles) {  // the state machine of tile s - 3
      const int k = s - 3, n = min(T, W - k * T);
      const uint8_t *va = in_va + (k % IN_SLOTS) * T, *metp = met_t + (k % MET_SLOTS) * T;
      const float *vrp = in_vr + (k % IN_SLOTS) * T;
      int4 *out = reinterpret_cast<int4 *>(rec + (k % OUT_SLOTS) * T);
      // The registers as each window finds them go to its record; an
      // invalid window enters no state (every is_* below is false). Each
      // window's inputs are read a window ahead.
      bool ok_next = va[0], met_next = metp[0];
      float vr_next = vrp[0];
#pragma unroll 4
      for (int i = 0; i < n; ++i, win = add_i32(win, 1)) {
        const bool ok = ok_next, met = met_next;
        const float vr = vr_next;
        const int j = min(i + 1, n - 1);
        ok_next = va[j];
        met_next = metp[j];
        vr_next = vrp[j];
        const int32_t start = dc.start_win, end = dc.end_win, seg_cnt = dc.seg_cnt;
        const float seg_sum = dc.seg_sum, met_sec = dc.met_sec;
        out[2 * i] = make_int4(dc.state, start, end, seg_cnt);
        out[2 * i + 1] = make_int4(__float_as_int(seg_sum), __float_as_int(met_sec), ok | (met << 1), 0);
        const bool is_closed = ok & (dc.state == CLOSED), is_opening = ok & (dc.state == OPENING);
        const bool is_open = ok & (dc.state == OPEN), is_closing = ok & (dc.state == CLOSING);
        const bool opening_dur = mul_i32(sub_i32(win, start), a.fft_size) >= prm.min_consec;
        const bool closing_dur = mul_i32(sub_i32(win, end), a.fft_size) >= prm.max_gap;
        const bool t_closed_opening = is_closed & met;
        const bool t_open_closing = is_open & !met;
        // Per-segment stats and transitions, from the entry state (the
        // transitions are exclusive, so selects replace the else-ifs).
        dc.seg_sum = is_open ? seg_sum + vr : (t_closed_opening ? vr : seg_sum);
        dc.seg_cnt = is_open ? seg_cnt + 1 : (t_closed_opening ? 1 : seg_cnt);
        dc.met_sec = is_open & met ? met_sec + a.window_sec
                                   : (t_closed_opening ? a.window_sec : met_sec);
        int32_t st = t_closed_opening ? OPENING : dc.state;
        st = is_opening ? (met ? (opening_dur ? OPEN : OPENING) : CLOSED) : st;
        st = t_open_closing ? CLOSING : st;
        st = is_closing ? (met ? OPEN : (closing_dur ? CLOSED : CLOSING)) : st;
        dc.state = st;
        dc.start_win = t_closed_opening ? win : start;
        dc.end_win = t_open_closing ? win : end;
      }
    }
    __syncthreads();
  }

  if (warp == W_AVG && lane < 2) {
    int32_t *ir = a.out_ireg + b * NI;
    float *k = a.out_kahan + b * NK + (lane == 0 ? 2 : 4);
    ir[lane == 0 ? I_SHORT_IDX : I_RATIO_IDX] = al.idx;
    ir[lane == 0 ? I_SHORT_CNT : I_RATIO_CNT] = al.cnt;
    k[0] = al.sum;
    k[1] = al.comp;
  }
  if (warp == W_MET && lead) {
    int32_t *ir = a.out_ireg + b * NI;
    ir[I_LONG_IDX] = dc.long_idx;
    ir[I_LONG_CNT] = dc.long_cnt;
    a.out_freg[b * NF + F_LONG_LAST] = dc.long_last;
    a.out_kahan[b * NK + 0] = dc.lsum;
    a.out_kahan[b * NK + 1] = dc.lcomp;
  }
  if (warp == W_FSM && lead) {
    int32_t *ir = a.out_ireg + b * NI;
    float *fr = a.out_freg + b * NF;
    ir[I_STATE] = dc.state;
    ir[I_START] = dc.start_win;
    ir[I_END] = dc.end_win;
    ir[I_SEG_CNT] = dc.seg_cnt;
    fr[F_SEG_SUM] = dc.seg_sum;
    fr[F_MET_SEC] = dc.met_sec;
  }
  float *gl = a.out_long + b * L, *gs = a.out_short + b * S, *gr = a.out_ratio + b * R;
  for (int i = tid; i < L; i += SMEM_THREADS) gl[i] = lring[i];
  for (int i = tid; i < S; i += SMEM_THREADS) gs[i] = sring[i];
  for (int i = tid; i < R; i += SMEM_THREADS) gr[i] = rring[i];
}

// ---------------------------------------------------------------------------
// Rings in global memory (the first port's design): one thread per row, for rings
// above the shared-memory budget.

__global__ void __launch_bounds__(GLOBAL_THREADS)
fsm_scan_global(const Args a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.n_rows) return;
  const int L = a.long_window, S = a.short_window, R = a.ratio_window;
  float *lbuf = a.out_long + b * L;
  float *sbuf = a.out_short + b * S;
  float *rbuf = a.out_ratio + b * R;
  if (a.fresh) {
    const float fill = a.has_initial_avg ? a.initial_avg[b] : 0.0f;
    for (int i = 0; i < L; ++i) lbuf[i] = fill;
    for (int i = 0; i < S; ++i) sbuf[i] = 0.0f;
    for (int i = 0; i < R; ++i) rbuf[i] = 0.0f;
  } else {
    for (int i = 0; i < L; ++i) lbuf[i] = a.in_long[b * L + i];
    for (int i = 0; i < S; ++i) sbuf[i] = a.in_short[b * S + i];
    for (int i = 0; i < R; ++i) rbuf[i] = a.in_ratio[b * R + i];
  }
  AvgState av;
  DecState dc;
  load_avg(a, b, av);
  load_dec(a, b, dc);
  const RowParams prm = row_params(a, b);
  const int32_t wb = a.win_base ? a.win_base[b] : 0;
  const int64_t row = b * (int64_t)a.n_windows;

  for (int64_t w = 0; w < a.n_windows; ++w) {
    const int64_t o = row + w;
    WinOut out;
    if (!a.valids[o]) {
      out = inert(dc);
    } else {
      const float mv = a.min_volumes[o], vr = a.volume_ratios[o];
      float sa, ra;
      avg_step(av, sbuf, S, rbuf, R, mv, vr, sa, ra);
      out = decide_step(dc, lbuf, a, prm, mv, vr, sa, ra, add_i32(wb, (int32_t)w));
    }
    a.event[o] = out.ev;
    a.event_win[o] = out.ev_win;
    a.seg_valid[o] = out.seg_valid;
    a.seg_start[o] = out.seg_start;
    a.seg_end[o] = out.seg_end;
    a.seg_ratio[o] = out.seg_ratio;
    a.seg_met[o] = out.seg_met;
  }
  store_avg(a, b, av);
  store_dec(a, b, dc);
}

}  // namespace

extern "C" {

const char* fvad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Dynamic shared memory of one fsm_scan_smem CTA (pipeline/fsm_cuda.py::smem_bytes).
long long fvad_fsm_smem_bytes(int tile, int long_window, int short_window, int ratio_window) {
  return (long long)TILE_BYTES * tile + 4LL * ((long long)long_window + short_window + ratio_window);
}

// body 0: fsm_scan_smem (one CTA per row, `tile` windows a tile, a multiple
// of 32); body 1: fsm_scan_global. Inputs [B, W] (valids as 0/1 bytes),
// per-row params [B] (initial_avg too), win_base [B] or null; the given
// carry (rings [B, L|S|R], ireg [B, NI], freg [B, NF], kahan [B, NK]) is
// read, never written; with fresh != 0 it is null and fresh_kahan [B, NK]
// gives the Kahan seeds. The new carry and the outputs [B, W] (seg_valid as
// 0/1 bytes) are written whole. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan it does not take.
int fvad_fsm_scan(int body, int n_rows, int n_windows, int tile, int long_window,
                  int short_window, int ratio_window, int has_initial_avg, int fft_size,
                  int sample_rate, float window_sec, const float *threshold_factor,
                  const float *ratio_threshold, const int32_t *min_consecutive_samples,
                  const int32_t *max_gap_samples, const float *min_duration_sec,
                  const float *initial_avg, const float *min_volumes,
                  const float *volume_ratios, const uint8_t *valids, const int32_t *win_base,
                  int fresh, const float *in_long, const float *in_short, const float *in_ratio,
                  const int32_t *in_ireg, const float *in_freg, const float *in_kahan,
                  const float *fresh_kahan, float *out_long, float *out_short, float *out_ratio,
                  int32_t *out_ireg, float *out_freg, float *out_kahan, int32_t *event,
                  int32_t *event_win, uint8_t *seg_valid, int32_t *seg_start, int32_t *seg_end,
                  float *seg_ratio, float *seg_met, void *stream) {
  const Args a{n_rows, n_windows, tile, long_window, short_window, ratio_window,
               has_initial_avg, fft_size, sample_rate, fresh, window_sec,
               threshold_factor, ratio_threshold, min_consecutive_samples, max_gap_samples,
               min_duration_sec, initial_avg, min_volumes, volume_ratios, valids, win_base,
               in_long, in_short, in_ratio, in_ireg, in_freg, in_kahan, fresh_kahan,
               out_long, out_short, out_ratio, out_ireg, out_freg, out_kahan,
               event, event_win, seg_valid, seg_start, seg_end, seg_ratio, seg_met};
  if (n_rows <= 0 || n_windows < 0 || (fresh ? !fresh_kahan : !in_ireg))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (body == 0) {
    if (tile < 32 || tile % 32 != 0) return (int)cudaErrorInvalidValue;
    const long long smem = fvad_fsm_smem_bytes(tile, long_window, short_window, ratio_window);
    if (smem > INT32_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(fsm_scan_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    fsm_scan_smem<<<n_rows, SMEM_THREADS, (size_t)smem, st>>>(a);
  } else if (body == 1) {
    const int blocks = (n_rows + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
    fsm_scan_global<<<blocks, GLOBAL_THREADS, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
