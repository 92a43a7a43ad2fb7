"""The comparison that decides ``correct`` for a k-NN search cell.

Every answer the window produced is judged against the plain reference
(``bench/reference/exact_knn.py``) on the data and queries the benchmark
made.  The guarantees a configuration states, and the numbers that hold
them:

* ``bad_rows`` (limit 0): answer rows with an id out of range, an id
  twice, a distance that is not finite, or the wrong shape.
* ``unsorted_rows`` (limit 0): rows whose distances fall somewhere.
* ``dist_rel_err`` (limit from the configuration's ``limits``): the
  largest |returned - exact| / exact over every returned distance, against
  the float64 distance of the returned id to the query asked.
* ``recall_loss`` (limit from the configuration's ``limits``): 1 - the
  share of the reference's exact top-k found, over every answer of the
  window.  It holds which neighbours come back: an answer of real rows
  with their true distances, but the wrong ones (a stale cache slot, a
  partition skipped, a beam cut short), passes the checks above and
  fails this one.  The same share is the end-to-end ``recall_at_10``.

A row that fails a row check counts once in ``failed``; ``recall_loss``
is of the whole window and counts in no row.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import exact_knn as REF

ROW_BLOCK = 8192


def judge(answers, data: np.ndarray, queries: np.ndarray, gt_ids,
          *, k: int, limits: dict, device) -> dict:
    """``answers``: (query indices (B,), distances (B, k), ids (B, k)) per
    batch, as the program returned them.  ``gt_ids``: the reference's
    exact top-k of every pool query, (Q, k) on ``device``.  Returns the
    counts, the compared numbers and recall."""
    x = REF.to_device(data, device)
    qs = REF.to_device(queries, device)
    n = data.shape[0]
    lim = float(limits["dist_rel_err"])
    lim_recall = float(limits["recall_loss"])
    shaped = [(qi, d, g) for qi, d, g in answers
              if np.shape(d) == (len(qi), k) and np.shape(g) == (len(qi), k)]
    misshaped = sum(len(qi) for qi, _, _ in answers) - sum(
        len(qi) for qi, _, _ in shaped)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    bad, unsorted, failed, found, worst = zero, zero, zero, zero, zero
    rows = misshaped
    if shaped:
        qi_all = np.concatenate([a[0] for a in shaped])
        d_all = np.concatenate([a[1] for a in shaped])
        g_all = np.concatenate([a[2] for a in shaped])
        rows += len(qi_all)
        for s in range(0, len(qi_all), ROW_BLOCK):
            blk = slice(s, s + ROW_BLOCK)
            qi = torch.as_tensor(qi_all[blk], device=device).long()
            d = torch.as_tensor(d_all[blk], device=device).double()
            g = torch.as_tensor(g_all[blk], device=device).long()
            srt = torch.sort(g, dim=1).values
            dup = (srt[:, 1:] == srt[:, :-1]).any(1)
            out = ((g < 0) | (g >= n)).any(1)
            row_bad = dup | out | ~torch.isfinite(d).all(1)
            row_unsorted = (d[:, 1:] < d[:, :-1]).any(1)
            ref = REF.exact_dists(x, qs, qi, g)
            err = (d - ref).abs() / ref.clamp(min=1e-30)
            err = torch.where(torch.isfinite(err), err, torch.inf)
            row_err = err.max(1).values
            worst = torch.maximum(worst, torch.where(
                row_bad, 0.0, row_err).max())
            row_fail = row_bad | row_unsorted | ~(row_err <= lim)
            hit = ((g[:, :, None] == gt_ids[qi][:, None, :k]).any(2)
                   & (g >= 0))
            found = found + hit.sum()
            bad = bad + row_bad.sum()
            unsorted = unsorted + row_unsorted.sum()
            failed = failed + row_fail.sum()
    bad = int(bad) + misshaped
    recall = float(found) / max(rows * k, 1)
    numbers = {"bad_rows": (bad, 0), "unsorted_rows": (int(unsorted), 0),
               "dist_rel_err": (float(worst), lim),
               "recall_loss": (1.0 - recall, lim_recall)}
    return {"rows": rows, "failed": int(failed) + misshaped,
            "numbers": numbers,
            "correct": all(v <= limit for v, limit in numbers.values()),
            "recall_at_10": recall}
