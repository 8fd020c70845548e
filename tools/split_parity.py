#!/usr/bin/env python3
"""Where a tree model trained on the GPU parts from the same model trained
on the CPU.

    python3 tools/split_parity.py

Trains one AutoML XGBoost step (``automl._model_step("xgboost", ...)``: 10
trees at depth 5 on 20,000 HIGGS-shaped rows with 3 folds, the step whose
holdout column once parted in ``chip_smoke.py``'s ``automl_card_vs_cpu``)
on the card and on the CPU, recording every split search
(``engine._find_splits``) with its input histogram. Prints one JSON line: the largest difference of the kept CV
holdout predictions and the rows apart by more than 1e-4; the first split
search whose histogram differs between the devices (its cells apart and
their largest difference); the first whose chosen splits differ, with
each differing node's (feature, bin, NA direction, gain) on both devices
and the gains' distance in float32 ulps; and whether the CPU's search on
the card's histogram picks the card's splits (if not, the search itself
rounds differently on the two devices). Needs a CUDA GPU.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ulps(a: float, b: float) -> int:
    import numpy as np

    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from h2o_tpu_torch import H2OAutoML
    from h2o_tpu_torch.models import automl
    from h2o_tpu_torch.models.tree import engine

    if not torch.cuda.is_available():
        print("split_parity: no CUDA GPU", file=sys.stderr)
        return 1
    search = engine._find_splits
    calls: list = []

    def recorded(hist, colmask, edge_ok, cfg, *rest):
        out = search(hist, colmask, edge_ok, cfg, *rest)
        calls.append(dict(hist=hist.cpu().clone(),
                          args=(colmask.cpu().clone(), edge_ok.cpu().clone(),
                                cfg),
                          rest=[x.cpu().clone() if torch.is_tensor(x) else x
                                for x in rest],
                          out=[o.cpu().clone() for o in out[:4]]))
        return out

    engine._find_splits = recorded
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            calls.clear()
            fr = cs._higgs_frame(20_000, dev)
            step = automl.Step("XGBoost", "def_1", automl._model_step(
                "xgboost", dict(ntrees=10, max_depth=5)))
            aml = H2OAutoML(max_models=1, nfolds=3, seed=42,
                            modeling_plan=[step])
            aml.train(y="response", training_frame=fr)
            hp = aml.leaderboard.models[0].output.cv_holdout_predictions
            runs[dev] = (list(calls),
                         hp.vec(hp.ncol - 1).data[:fr.nrow].cpu().double())
    finally:
        engine._find_splits = search
    (card, pc), (cpu, ph) = runs["cuda"], runs["cpu"]
    diff = (pc - ph).abs()
    first_hist = next((i for i, (a, b) in enumerate(zip(card, cpu))
                       if not torch.equal(a["hist"], b["hist"])), None)
    first_split = next((i for i, (a, b) in enumerate(zip(card, cpu))
                        if not all(torch.equal(x, y) for x, y in
                                   zip(a["out"][1:], b["out"][1:]))), None)
    out = dict(searches=[len(card), len(cpu)],
               holdout_max_diff=float(diff.max()),
               holdout_rows_apart=int((diff > 1e-4).sum()),
               first_search_hist_differs=first_hist,
               first_search_split_differs=first_split)
    if first_hist is not None:
        d = (card[first_hist]["hist"] - cpu[first_hist]["hist"]).abs()
        out["hist_cells_apart"] = int((d > 0).sum())
        out["hist_max_diff"] = float(d.max())
    if first_split is not None:
        a, b = card[first_split], cpu[first_split]
        again = search(a["hist"], *b["args"], *b["rest"])
        out["cpu_search_on_card_hist_picks_card_splits"] = all(
            torch.equal(x.cpu(), y) for x, y in zip(again[1:4],
                                                    a["out"][1:]))
        gain, feat, cut, na = range(4)
        apart = torch.nonzero((a["out"][feat] != b["out"][feat])
                              | (a["out"][cut] != b["out"][cut])
                              | (a["out"][na] != b["out"][na])).flatten()
        out["nodes"] = [dict(
            node=int(n),
            card=[int(a["out"][feat][n]), int(a["out"][cut][n]),
                  bool(a["out"][na][n]), float(a["out"][gain][n])],
            cpu=[int(b["out"][feat][n]), int(b["out"][cut][n]),
                 bool(b["out"][na][n]), float(b["out"][gain][n])],
            gain_ulps=_ulps(float(a["out"][gain][n]),
                            float(b["out"][gain][n])))
            for n in apart.tolist()[:8]]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
