"""The trainer's Gaussian count against the JAX package's reference run.

Trains the port with the flags of the JAX MS-GS quality run
(data/quality/ms/cfg_args.json) on msgs_torch.data.synthetic's scene (24
train and 8 test views at 512², the generator and seed of the JAX run's
scene), once per seed, each seed in its own process on the same card, and
holds every run against the JAX run's log (data/quality/ms/train_log.jsonl):

  - the `lvl` column every 100 iterations (the level schedule and the view
    order come from Python RNGs seeded alike in both trainers, so at the
    JAX run's seed they must agree),
  - `live` every 100 iterations, with the band the port's seeds span,
  - the evaluation at the last iteration (and the port's own evaluations
    at --evals).

Every densify pass is also broken down, one event at a time, into its
clone, split and prune counts (`densify_and_prune`'s parts, wrapped in the
child process; the library is unchanged).

  python -m msgs_torch.tools.live_count [--seeds 0 1 2] \
      [--iterations 7000] [--out DIR] [--scene DIR] [--device cpu]

Writes DIR/seed<N>/ (the trainer's model directory: its train_log.jsonl,
with densify.jsonl and the trainer's output beside it) and
DIR/summary.json, and prints the comparison.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_DIR = os.path.join(ROOT, "data", "quality", "ms")
# cfg_args.json keys that are not training flags, or that this tool sets.
SKIP = {"source_path", "model_path", "source_path_short", "model_path_short",
        "resolution_short", "data_device", "iterations", "test_iterations",
        "save_iterations", "checkpoint_iterations", "start_checkpoint",
        "ip", "port", "profile_steps", "multihost", "seed", "backend",
        "quiet", "disable_gui", "no_tensorboard", "detect_anomaly"}
CHILD_FLAG = "--child"
COMPOSITE_FLAG = "--composite_contribution"


def reference_flags(cfg_path: str = os.path.join(REF_DIR, "cfg_args.json")
                    ) -> list:
    """The JAX run's training flags as the port's trainer takes them."""
    from msgs_torch.apps.train import build_parser
    cfg = json.load(open(cfg_path))
    defaults = vars(build_parser().parse_args([]))
    argv = []
    for k, v in cfg.items():
        if k in SKIP or k not in defaults or v == defaults[k] or v is None:
            continue
        if isinstance(v, bool):
            argv += [f"--{k}"] if v else []
        elif isinstance(v, list):
            argv += [f"--{k}"] + [str(x) for x in v]
        else:
            argv += [f"--{k}", str(v)]
    return argv


def read_log(path: str) -> list:
    return [json.loads(line) for line in open(path)]


def composite_contributed(pre, width: int, height: int, binned,
                          chunk_elems: int = 1 << 26):
    """Per-Gaussian contribution flags as the JAX package computed them
    until it moved to the preprocess-level test (the port's, and JAX's
    since): a Gaussian contributed when one of its entries has a nonzero
    blend weight w = α·T·alive at some pixel. Each tile's entries in the
    compositor's order, at every pixel of the tile at once: T is the
    running product of (1 − α), and an entry is alive while T after it
    stays ≥ T_EPS (the product only falls, so the first entry that would
    take it below ends the pixel, as the compositor's done mask does).
    Tiles go in chunks of about `chunk_elems` (entry, pixel) pairs."""
    import torch

    from msgs_torch.kernels import composite as comp
    from msgs_torch.kernels.preprocess import (ALPHA_MAX, ALPHA_MIN, T_EPS,
                                               TILE, PreprocessOut)
    from msgs_torch.kernels.rasterize import feature_table
    tiles_x = (width + TILE - 1) // TILE
    tiles = tiles_x * ((height + TILE - 1) // TILE)
    n = pre.depths.shape[0]
    dev = pre.depths.device
    out = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    with torch.no_grad():
        table = feature_table(PreprocessOut(*(f.detach() for f in pre)))
        first, n_sub = comp.tile_sub_ranges(
            binned.sub_tile, binned.sub_valid, binned.tile_last_sub, tiles)
        pxl, pyl = comp._local_pix(dev)
        ox, oy = comp._tile_origin(tiles, tiles_x, dev)
        # Tiles longest first, each chunk padded to its first tile's length.
        order = torch.argsort(n_sub.long(), descending=True, stable=True)
        lengths = n_sub.long()[order].tolist()
        i = 0
        while i < tiles and lengths[i] > 0:
            k = lengths[i] * comp.SUB
            c = max(1, chunk_elems // (k * comp.NPIX))
            t = order[i:i + c]
            i += c
            e = (first[t].long() * comp.SUB)[:, None] + torch.arange(
                k, device=dev)                             # (c, k)
            valid = e < ((first[t] + n_sub[t]).long() * comp.SUB)[:, None]
            gid = torch.where(valid, binned.gauss_id[
                torch.clamp(e, max=binned.gauss_id.shape[0] - 1)].long(), n)
            f = table[gid]                                 # (c, k, NFEAT)
            dx = (pxl + ox[t, None])[:, None, :] - f[..., comp.F_MX, None]
            dy = (pyl + oy[t, None])[:, None, :] - f[..., comp.F_MY, None]
            power = (-0.5 * (f[..., comp.F_CXX, None] * dx * dx
                             + f[..., comp.F_CYY, None] * dy * dy)
                     - f[..., comp.F_CXY, None] * dx * dy)
            a_raw = f[..., comp.F_OP, None] * torch.exp(power)
            alpha = torch.where((a_raw >= ALPHA_MIN) & (power <= 0.0),
                                torch.clamp(a_raw, max=ALPHA_MAX), 0.0)
            inside = (((pxl + ox[t, None]) < width)
                      & ((pyl + oy[t, None]) < height))     # (c, NPIX)
            alive = (torch.cumprod(1.0 - alpha, dim=1) >= T_EPS) \
                & inside[:, None, :]
            out[gid[((alpha > 0) & alive).any(dim=-1)]] = True
    return out[:n]


def use_composite_contribution():
    """Make every render report pixel sizes only for the Gaussians that
    contributed by `composite_contributed` (this process only)."""
    from msgs_torch.kernels import rasterize as R
    from msgs_torch.kernels.preprocess import PreprocessOut
    pipeline = R.composite_pipeline

    def patched(pre, width, height, settings):
        res = pipeline(pre, width, height, settings)
        binned = R.bin_gaussians(PreprocessOut(*(f.detach() for f in pre)),
                                 width, height, settings.entry_cap,
                                 row_tight=settings.row_tight)
        return res._replace(contributed=composite_contributed(
            pre, width, height, binned))
    R.composite_pipeline = patched


def child(out_dir: str, argv: list) -> int:
    """One trainer run, its densify passes counted part by part."""
    import torch

    from msgs_torch.apps import train as train_app
    from msgs_torch.model import gaussians as G

    torch.set_num_threads(2)
    if argv[:1] == [COMPOSITE_FLAG]:
        use_composite_contribution()
        argv = argv[1:]
    rec = {}
    clone, split, prune = G.densify_clone, G.densify_split, G.prune

    def count_clone(st, grads, thr, *a, **k):
        rec["cand"] = int((st.live & (grads >= thr)
                           & (st.target_reso_lvl == 0)).sum())
        new, touched = clone(st, grads, thr, *a, **k)
        rec["cloned"] = int(touched.sum())
        return new, touched

    def count_split(st, *a, **k):
        new, touched = split(st, *a, **k)
        rec["split_parents"] = int((st.live & ~new.live).sum())
        rec["split_children"] = int(touched.sum())
        return new, touched

    def count_prune(st, mask):
        rec["pruned"] = int((mask & st.live).sum())
        return prune(st, mask)

    G.densify_clone, G.densify_split, G.prune = \
        count_clone, count_split, count_prune
    dens = open(os.path.join(out_dir, "densify.jsonl"), "w")
    it_now = [0]

    def on_iteration(it, host_ops):
        if rec:
            dens.write(json.dumps({"it": it, **rec}) + "\n")
            dens.flush()
            rec.clear()
        it_now[0] = it

    t0 = time.time()
    train_app.main(argv, on_iteration=on_iteration)
    dens.close()
    print(f"[live_count] {out_dir}: {it_now[0]} iterations in "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0


def band(runs: dict, it: int):
    vals = [r[it] for r in runs.values() if it in r]
    return (min(vals), max(vals)) if vals else None


def compare(out: str, seeds: list, iterations: int, evals: list) -> dict:
    ref = read_log(os.path.join(REF_DIR, "train_log.jsonl"))
    ref_it = {r["it"]: r for r in ref if "live" in r and r["it"] <= iterations}
    ref_eval = next((r["eval"] for r in ref
                     if "eval" in r and r["it"] == iterations), None)
    live, lvl, ev, dens, events = {}, {}, {}, {}, {}
    for s in seeds:
        log = read_log(os.path.join(out, f"seed{s}", "train_log.jsonl"))
        live[s] = {r["it"]: r["live"] for r in log if "live" in r}
        lvl[s] = {r["it"]: r["lvl"] for r in log if "live" in r}
        ev[s] = {r["it"]: r["eval"] for r in log if "eval" in r}
        events[s] = [r for r in log if "event" in r]
        dens[s] = read_log(os.path.join(out, f"seed{s}", "densify.jsonl"))
    its = sorted(ref_it)
    summary = {"seeds": seeds, "iterations": iterations, "rows": [],
               "lvl_mismatch": {}, "evals": {}, "ref_eval": ref_eval,
               "first_outside": None}
    for s in seeds:
        bad = [it for it in its if it in lvl[s]
               and lvl[s][it] != ref_it[it]["lvl"]]
        summary["lvl_mismatch"][s] = bad
        print(f"[live_count] seed {s}: lvl differs from the JAX run's at "
              f"{len(bad)} of {len(its)} hundreds"
              + (f" (first {bad[:5]})" if bad else ""), flush=True)
    print("[live_count] it, JAX live, port live per seed, band", flush=True)
    for it in its:
        b = band(live, it)
        row = {"it": it, "jax_live": ref_it[it]["live"],
               "jax_lvl": ref_it[it]["lvl"],
               "port_live": {s: live[s].get(it) for s in seeds},
               "port_lvl": {s: lvl[s].get(it) for s in seeds}, "band": b}
        inside = b is not None and b[0] <= ref_it[it]["live"] <= b[1]
        row["jax_inside"] = inside
        if not inside and summary["first_outside"] is None:
            summary["first_outside"] = it
        summary["rows"].append(row)
        print(f"  {it:5d} {ref_it[it]['live']:7d}  "
              + " ".join(f"{live[s].get(it, -1):7d}" for s in seeds)
              + f"  {'in' if inside else 'OUT'}", flush=True)
    for s in seeds:
        summary["evals"][s] = {
            it: {k: v["psnr"] for k, v in e.items() if k.startswith("test")}
            for it, e in ev[s].items()}
        for it in evals:
            if it in ev[s]:
                print(f"[live_count] seed {s} it {it}: live "
                      f"{live[s].get(it)} test x1 PSNR "
                      f"{ev[s][it]['test_s1']['psnr']:.3f}", flush=True)
    if ref_eval is not None:
        for k in sorted((k for k in ref_eval if k.startswith("test")),
                        key=lambda k: float(k[6:])):
            vals = [ev[s][iterations][k]["psnr"] for s in seeds
                    if iterations in ev[s]]
            print(f"[live_count] {k} PSNR at {iterations}: JAX "
                  f"{ref_eval[k]['psnr']:.3f}; port "
                  + ", ".join(f"{v:.3f}" for v in vals)
                  + (f" (band {min(vals):.3f}..{max(vals):.3f})"
                     if vals else ""), flush=True)
    summary["densify"] = dens
    summary["events"] = events
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == [CHILD_FLAG]:
        return child(argv[1], argv[2:])
    ap = argparse.ArgumentParser("msgs_torch live_count")
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--iterations", type=int, default=7000)
    ap.add_argument("--evals", nargs="+", type=int,
                    default=[1000, 1100, 2000, 3000, 7000])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "live_count"))
    ap.add_argument("--scene", default=None,
                    help="scene directory (made there when absent)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--contribution", choices=("entries", "composite"),
                    default="entries",
                    help="which Gaussians report pixel sizes: those with "
                         "an entry (the port and the JAX package today) or "
                         "those with a nonzero blend weight somewhere (the "
                         "JAX package when its reference log was made)")
    args = ap.parse_args(argv)
    import tempfile

    from msgs_torch import resolve_device
    dev = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="live_count_")
    scene = args.scene or os.path.join(tmp, "scene")
    if not os.path.exists(os.path.join(scene, "transforms_train.json")):
        from msgs_torch.data.synthetic import make_scene
        t0 = time.time()
        make_scene(scene, device=dev, quiet=True)
        print(f"[live_count] scene in {time.time() - t0:.1f} s", flush=True)
    if dev.type == "cuda":   # build the kernels once, before the children
        from msgs_torch.kernels import _build
        _build.load()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"[live_count] {smi.stdout.strip()}", flush=True)
    flags = reference_flags()
    print(f"[live_count] flags: {' '.join(flags)}", flush=True)
    procs = []
    for s in args.seeds:
        out = os.path.join(args.out, f"seed{s}")
        os.makedirs(out, exist_ok=True)
        for name in ("train_log.jsonl", "densify.jsonl", "cfg_args",
                     "cfg_args.json"):
            if os.path.exists(os.path.join(out, name)):
                os.remove(os.path.join(out, name))
        tr = flags + [
            "-s", scene, "-m", out, "--seed", str(s),
            "--iterations", str(args.iterations),
            "--test_iterations", *map(str, args.evals),
            "--save_iterations", "-1", "--test_interval", "0",
            "--disable_gui", "--no_tensorboard", "--quiet"]
        if args.device:
            tr += ["--device", args.device]
        logf = open(os.path.join(out, "stdout.txt"), "w")
        procs.append((s, logf, subprocess.Popen(
            [sys.executable, "-m", "msgs_torch.tools.live_count",
             CHILD_FLAG, out]
            + ([COMPOSITE_FLAG] if args.contribution == "composite" else [])
            + tr, cwd=ROOT, stdout=logf,
            stderr=subprocess.STDOUT)))
    t0 = time.time()
    rc = 0
    for s, logf, p in procs:
        rc |= p.wait()
        logf.close()
        print(f"[live_count] seed {s} rc {p.returncode} at "
              f"{time.time() - t0:.1f} s", flush=True)
    if rc:
        return rc
    compare(args.out, args.seeds, args.iterations, args.evals)
    return 0


if __name__ == "__main__":
    sys.exit(main())
