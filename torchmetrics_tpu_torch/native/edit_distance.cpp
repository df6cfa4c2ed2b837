// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// Batched Levenshtein edit distance over interned token-id sequences — the
// host-side hot loop of WER/CER/MER/WIL/WIP on large corpora (the reference
// runs this as a per-sentence Python DP, src/torchmetrics/functional/text/
// helper.py:34-51). Two-row DP, one pair per OpenMP task.

#include <algorithm>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// pred_tok / tgt_tok: flattened uint64 token ids for all pairs.
// pred_off / tgt_off: n_pairs+1 offsets into the flattened arrays.
// out: n_pairs edit distances.
void batch_edit_distance(const uint64_t* pred_tok, const int64_t* pred_off,
                         const uint64_t* tgt_tok, const int64_t* tgt_off,
                         int64_t n_pairs, int64_t substitution_cost,
                         int64_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16) if (n_pairs > 64)
#endif
  for (int64_t k = 0; k < n_pairs; ++k) {
    const uint64_t* p = pred_tok + pred_off[k];
    const uint64_t* t = tgt_tok + tgt_off[k];
    const int64_t m = pred_off[k + 1] - pred_off[k];
    const int64_t n = tgt_off[k + 1] - tgt_off[k];
    if (m == 0) { out[k] = n; continue; }
    if (n == 0) { out[k] = m; continue; }
    std::vector<int64_t> row(static_cast<size_t>(n) + 1);
    for (int64_t j = 0; j <= n; ++j) row[j] = j;
    for (int64_t i = 1; i <= m; ++i) {
      int64_t diag = row[0];
      row[0] = i;
      const uint64_t pi = p[i - 1];
      for (int64_t j = 1; j <= n; ++j) {
        const int64_t sub = diag + (pi == t[j - 1] ? 0 : substitution_cost);
        diag = row[j];
        row[j] = std::min({sub, diag + 1, row[j - 1] + 1});
      }
    }
    out[k] = row[n];
  }
}

}  // extern "C"
