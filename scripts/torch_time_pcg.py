"""Time the port's matrix-free Sim3 PCG (hslam_tpu_torch.models.pose_graph.
optimize_pose_graph_pcg) on the card, on the 10,000-node circle of
chip_smoke.py phase 9 (5 GN iterations, at most 1000 CG iterations each),
for the hslam_tpu_torch of any checkout:

    python scripts/torch_time_pcg.py [--root DIR]

`--root` is a checkout whose hslam_tpu_torch is timed (default: this one),
so two versions can be compared in one call on one card: parent, change,
change, parent. Prints the card's name and power limit, then one JSON line:
the ms of each of three runs, CG iterations, the chi2 ratio, the largest difference
between the runs' (s, R, t), and whether they are the same bits.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path[:0] = [root, HERE]
    import torch
    from chip_smoke import _chi2, _circle_graph
    from hslam_tpu_torch.models import pose_graph as PG
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_pcg: needs a CUDA device")
    assert PG.__file__.startswith(root), PG.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    pg = PG.make_graph(*_circle_graph(10_000, scale_drift=1.00005, noise=0.002), device="cuda")
    PG.optimize_pose_graph_pcg(pg, n_iters=1, cg_iters=2)                # warm-up
    runs, ms, st = [], [], {}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(PG.optimize_pose_graph_pcg(pg, n_iters=5, cg_iters=1000, stats=st))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    c0 = _chi2(pg, (pg.s, pg.R, pg.t))
    print(json.dumps(dict(root=os.path.relpath(root, HERE), card=card, ms=ms,
                          cg_iterations=st.get("cg_iterations"),
                          chi2_ratio=_chi2(pg, runs[0]) / c0,
                          max_abs_diff_between_runs=max(
                              float((x - y).abs().max()) for r in runs[1:]
                              for x, y in zip(runs[0], r)),
                          same_bits=all(torch.equal(x, y) for r in runs[1:]
                                        for x, y in zip(runs[0], r)))),
          flush=True)


if __name__ == "__main__":
    main()
