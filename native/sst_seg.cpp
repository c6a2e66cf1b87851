// Segment extraction for the device fast path: decoded state paths ->
// word/phone runs, mirroring aligner._extract exactly (the
// state_align_search_finish boundary rule: interior boundaries shift
// +1, state_align_search.c:236-255; merge same-node runs into phones;
// group phones into words with silence resetting the group).
//
// The Python extraction cost 30-50 ms per 256-512-utterance batch of
// host time on the 2-core host (the pipeline's bound); this does the
// run detection + grouping in one pass so Python only materializes the
// final WordSeg objects.  Score-carrying and state-level extraction
// stay in Python (aligner._extract) — they are not the throughput
// path.

#include <cstdint>

extern "C" {

// paths: [B, Tpad] int16 decoded state ids (frames >= Ts[b] hold -1).
// Ts: [B] frame counts.  E: emitting states per phone.
// word_of/variant_of/cipid: per-graph node tables, concatenated over
// rows; goff[b] is row b's offset (rows sharing a graph share offsets).
//
// Outputs (caller-allocated):
//   nw[b]        words in row b, or -1 when the row failed to reach a
//                final state (path[T-1] < 0)
//   w_kind       1 = silence, 0 = word         (flat, in row order)
//   w_var        dict wid of the pronunciation (silence: -1)
//   w_start, w_dur
//   w_np         phone count of this word
//   p_ci, p_start, p_dur                        (flat phone segments)
//
// Returns 0, or -1 if the outputs would exceed cap_w / cap_p.
int sst_extract_batch(const int16_t* paths, int B, int Tpad,
                      const int64_t* Ts, int E,
                      const int32_t* word_of, const int32_t* variant_of,
                      const int32_t* cipid, const int64_t* goff,
                      int32_t* nw, int32_t* w_kind, int32_t* w_var,
                      int32_t* w_start, int32_t* w_dur, int32_t* w_np,
                      int32_t* p_ci, int32_t* p_start, int32_t* p_dur,
                      int64_t cap_w, int64_t cap_p) {
  int64_t wi = 0, pi = 0;
  for (int b = 0; b < B; b++) {
    const int16_t* p = paths + (int64_t)b * Tpad;
    const int T = (int)Ts[b];
    const int32_t* wo = word_of + goff[b];
    const int32_t* vo = variant_of + goff[b];
    const int32_t* ci = cipid + goff[b];
    if (T <= 0 || p[T - 1] < 0) {
      nw[b] = -1;
      continue;
    }
    nw[b] = 0;
    // state runs with the +1 interior shift; only the last can be
    // empty.  Merge same-node runs into phones and group into words
    // in the same pass.
    int cur_word = -2;       // -2 = none (grouping reset)
    int run_start = 0;
    int prev_state = p[0];
    int prev_node = prev_state / E;
    // pending phone accumulator (merging consecutive same-node runs)
    int ph_node = -1, ph_start = 0, ph_dur = 0;
    auto flush_phone = [&]() -> int {
      if (ph_node < 0) return 0;
      int w = wo[ph_node];
      if (w < 0) {                     // silence: its own word
        if (wi >= cap_w || pi >= cap_p) return -1;
        w_kind[wi] = 1; w_var[wi] = -1;
        w_start[wi] = ph_start; w_dur[wi] = ph_dur; w_np[wi] = 1;
        p_ci[pi] = ci[ph_node]; p_start[pi] = ph_start;
        p_dur[pi] = ph_dur; pi++;
        wi++; nw[b]++;
        cur_word = -2;
      } else {
        if (w != cur_word) {
          if (wi >= cap_w) return -1;
          w_kind[wi] = 0; w_var[wi] = vo[ph_node];
          w_start[wi] = ph_start; w_dur[wi] = 0; w_np[wi] = 0;
          wi++; nw[b]++;
          cur_word = w;
        }
        if (pi >= cap_p) return -1;
        w_dur[wi - 1] += ph_dur;
        w_np[wi - 1]++;
        p_ci[pi] = ci[ph_node]; p_start[pi] = ph_start;
        p_dur[pi] = ph_dur; pi++;
      }
      ph_node = -1;
      return 0;
    };
    auto add_run = [&](int node, int start, int dur) -> int {
      if (dur <= 0) return 0;
      if (node == ph_node) {
        ph_dur += dur;
        return 0;
      }
      if (flush_phone() < 0) return -1;
      ph_node = node; ph_start = start; ph_dur = dur;
      return 0;
    };
    for (int t = 1; t < T; t++) {
      if (p[t] != prev_state) {
        // change between t-1 and t: run boundary at t+1 (the +1 shift)
        int bound = t + 1;
        if (bound > T) bound = T;
        if (add_run(prev_node, run_start, bound - run_start) < 0)
          return -1;
        run_start = bound;
        prev_state = p[t];
        prev_node = prev_state / E;
      }
    }
    if (add_run(prev_node, run_start, T - run_start) < 0) return -1;
    if (flush_phone() < 0) return -1;
  }
  return 0;
}

}  // extern "C"
