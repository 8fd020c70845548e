"""Word2Vec's SGNS step on the card: the eager step's host wall, the
device's busy time under ``torch.profiler`` and the idle share, against
one replay of the CUDA graph ``word2vec._Stepper`` captures; the two
bit-equal from the same state.

    python3 tools/w2v_step_times.py [--steps 300]

At text8's shapes (``chip_smoke.word2vec_text8``: a 22,088-word
vocabulary, 100-wide vectors, 1,024 pairs and 5 negatives a step), on
random indices. Needs a CUDA card.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("w2v_step_times: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    from h2o_tpu_torch.models import word2vec as w

    dev = torch.device("cuda")
    V, D, B, K, n = 22_088, 100, 1024, 5, args.steps
    g = torch.Generator().manual_seed(0)
    W0 = ((torch.rand((V, D), generator=g) - 0.5) / D).to(dev)
    C0 = (torch.rand((V, D), generator=g) * 0.01).to(dev)
    pairs = torch.randint(0, V, (n * B, 2), generator=g).to(dev)
    negs = torch.randint(0, V, (n, B, K), generator=g).to(dev)
    lrs = [float(np.float32(0.025 * (1 - s / (2 * n)))) for s in range(n)]
    sel = torch.arange(n * B, device=dev).view(n, B)

    def run(stepper, steps):
        for s in range(steps):
            stepper(sel[s], negs[s], lrs[s])

    out = {"card": torch.cuda.get_device_name(0)}
    states = {}
    for graph in (False, True):
        W, C = W0.clone(), C0.clone()
        step = w._Stepper(W, C, pairs, B, K)
        if not graph:
            step.graph = None            # the eager step, as on the CPU
        run(step, 10)
        W.copy_(W0)
        C.copy_(C0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(step, n)
        torch.cuda.synchronize()
        key = "graph" if graph else "eager"
        out[f"{key}_ms_per_step"] = (time.perf_counter() - t0) / n * 1e3
        states[key] = (W.clone(), C.clone())
        if not graph:
            W.copy_(W0)
            C.copy_(C0)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(step, 100)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type.name == "CUDA") / 1e3
            out["eager_profiled_ms_per_step"] = wall * 1e3 / 100
            out["eager_device_busy_ms_per_step"] = busy / 100
            out["eager_idle_share"] = 1 - busy / (wall * 1e3)
    (We, Ce), (Wg, Cg) = states["eager"], states["graph"]
    out["graph_bit_equal"] = bool(torch.equal(We, Wg) and torch.equal(Ce, Cg))
    print(out, flush=True)
    return 0 if out["graph_bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
