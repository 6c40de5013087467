"""Result aggregation: port of msgs/apps/collect_results.py (it imports
no JAX; the port keeps its own copy).

Scrapes train_log.jsonl, results.json and eval_scales_*.json across runs
into a CSV and a LaTeX per-scale PSNR table, with the JAX app's columns
and bytes.

  python -m msgs_torch.apps.collect_results -m <out_root> [--csv out.csv]
      [--latex out.tex]
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from collections import defaultdict


def scrape_run(model_path: str) -> dict:
    """Latest eval record per scale from train_log.jsonl, plus offline
    results.json if present."""
    out = {}
    log = os.path.join(model_path, "train_log.jsonl")
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "eval" in rec:
                    for key, m in rec["eval"].items():
                        out[key] = {**m, "iteration": rec["it"]}
    rpath = os.path.join(model_path, "results.json")
    if os.path.exists(rpath):
        with open(rpath) as f:
            out["offline"] = json.load(f)
    # Offline multi-scale evals (msgs.apps.eval_scales) fill in scales the
    # in-train eval didn't cover; in-train records win on conflicts.
    evs = sorted(f for f in os.listdir(model_path)
                 if f.startswith("eval_scales_") and f.endswith(".json"))
    for f in evs:
        it = int(f[len("eval_scales_"):-len(".json")])
        with open(os.path.join(model_path, f)) as fh:
            for key, m in json.load(fh).items():
                out.setdefault(key, {**m, "iteration": it})
    return out


def collect(root: str):
    """Walk <root>/<scene>/<method>/ (train_all layout) or <root> itself."""
    rows = []
    candidates = []
    if os.path.exists(os.path.join(root, "train_log.jsonl")):
        candidates.append(("", "", root))
    else:
        for scene in sorted(os.listdir(root)):
            sdir = os.path.join(root, scene)
            if not os.path.isdir(sdir):
                continue
            if os.path.exists(os.path.join(sdir, "train_log.jsonl")):
                candidates.append((scene, "", sdir))
                continue
            for method in sorted(os.listdir(sdir)):
                mdir = os.path.join(sdir, method)
                if os.path.isdir(mdir):
                    candidates.append((scene, method, mdir))
    for scene, method, path in candidates:
        data = scrape_run(path)
        for key, metrics in data.items():
            if key == "offline":
                continue
            rows.append({"scene": scene, "method": method, "split_scale": key,
                         **metrics})
    return rows


def write_csv(rows, path):
    if not rows:
        print("no results found")
        return
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {path} ({len(rows)} rows)")


def write_latex(rows, path):
    """Per-scale PSNR table: methods × scales, averaged over scenes."""
    agg = defaultdict(list)
    for r in rows:
        if not r["split_scale"].startswith("test_s"):
            continue
        scale = r["split_scale"].split("_s")[1]
        agg[(r["method"], scale)].append(r.get("psnr"))
    methods = sorted({m for m, _ in agg})
    scales = sorted({int(s) for _, s in agg})
    with open(path, "w") as f:
        f.write("\\begin{tabular}{l" + "c" * len(scales) + "}\n\\toprule\n")
        f.write("Method & " + " & ".join(f"$\\times{s}$" for s in scales)
                + " \\\\\n\\midrule\n")
        for m in methods:
            cells = []
            for s in scales:
                vals = [v for v in agg.get((m, str(s)), []) if v is not None]
                cells.append(f"{sum(vals)/len(vals):.2f}" if vals else "-")
            f.write((m or "run") + " & " + " & ".join(cells) + " \\\\\n")
        f.write("\\bottomrule\n\\end{tabular}\n")
    print(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch collect_results")
    p.add_argument("-m", "--output_root", required=True)
    p.add_argument("--csv", default="results.csv")
    p.add_argument("--latex", default=None)
    a = p.parse_args(argv)
    rows = collect(a.output_root)
    write_csv(rows, a.csv)
    if a.latex:
        write_latex(rows, a.latex)


if __name__ == "__main__":
    main()
