"""The largest binned entry count a cell's traffic produces, and the
entry_cap the trainer's rule gives it (the next power of two), for the
configuration file:

    python3 benchmark/sweep_entry_cap.py --workload <cell> --seeds 1 2

Renders every (training view, level) of a training mix from the perturbed
start, or every frame of a render mix, with a capacity large enough that
nothing overflows, on the card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[1])
    p.add_argument("--cap", type=int, default=1 << 26)
    args = p.parse_args(argv)
    import torch
    from benchmark import harness as H
    from benchmark import program as P
    from benchmark.scene import make_scene, perturbed

    dev = torch.device("cuda", 0)
    cell = H.Cell.load(args.workload)
    cfg, mix = cell.config, cell.mix
    worst = 0
    for seed in args.seeds:
        sc = make_scene(cfg, seed, dev)
        gcfg = P.config(cfg, sc["n_levels"])
        counts = []
        if mix["kind"] == "train":
            st = P.gaussian_state(perturbed(sc["fields"], cfg, seed, dev))
            s = H.settings_for(cell, args.cap, train=True)
            for v in sc["train"]:
                for lvl in sorted({int(l) for l in mix["levels"]}):
                    out = P.eval_render(st, P.camera(v.scaled(2 ** lvl), dev),
                                        cfg=gcfg, settings=s, reso_lvl=lvl)
                    counts.append(int(out.num_entries))
        else:
            st = P.gaussian_state(sc["fields"])
            s = H.settings_for(cell, args.cap, train=False)
            for v, _ in H.kind("render").frames(mix, sc["train"]):
                out = P.eval_render(st, P.camera(v, dev), cfg=gcfg,
                                    settings=s, fade_size=mix["fade_size"])
                counts.append(int(out.num_entries))
        worst = max(worst, max(counts))
        print(f"seed {seed}: live {sc['n_live']} (aggregates "
              f"{sc['aggregates']}), entries min {min(counts)} median "
              f"{sorted(counts)[len(counts) // 2]} max {max(counts)}")
        del st, sc
        torch.cuda.empty_cache()
    print(f"max {worst} -> entry_cap {1 << max(worst - 1, 1).bit_length()}")


if __name__ == "__main__":
    main()
