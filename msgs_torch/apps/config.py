"""CLI flag groups (port of msgs/apps/config.py; the cfg_args.json it writes
has the JAX package's keys) mirroring the reference config system
(arguments/__init__.py:19-111): ModelParams / PipelineParams /
OptimizationParams built by reflection over dataclass fields, plus the
persisted-config merge for inference tools (`get_combined_args` — the
reference stores a cfg_args Namespace repr; we store JSON for sanity but
also parse the reference's repr format for interop)."""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, fields
from typing import Optional

from msgs_torch.train.optimizer import OptimParams


@dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"     # informational; the trainer's --device
                                  # decides where tensors live
    eval: bool = False


@dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


def add_group(parser: argparse.ArgumentParser, dc_type, name: str):
    g = parser.add_argument_group(name)
    for f in fields(dc_type):
        flag = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            g.add_argument(flag, action="store_true", default=f.default)
        else:
            g.add_argument(flag, type=type(f.default), default=f.default)
    return g


def extract(dc_type, args: argparse.Namespace):
    return dc_type(**{f.name: getattr(args, f.name) for f in fields(dc_type)
                      if hasattr(args, f.name)})


def add_optim_group(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("Optimization Parameters")
    for name, default in OptimParams()._asdict().items():
        g.add_argument("--" + name, type=type(default), default=default)
    return g


def extract_optim(args: argparse.Namespace) -> OptimParams:
    return OptimParams(**{k: getattr(args, k)
                          for k in OptimParams._fields if hasattr(args, k)})


def save_cfg(model_path: str, args: argparse.Namespace):
    os.makedirs(model_path, exist_ok=True)
    ns = argparse.Namespace(**vars(args))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write("Namespace(" + ", ".join(
            f"{k}={v!r}" for k, v in sorted(vars(ns).items())) + ")")
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(vars(ns), f, indent=2, default=str)


def load_cfg(model_path: str) -> dict:
    jpath = os.path.join(model_path, "cfg_args.json")
    if os.path.exists(jpath):
        with open(jpath) as f:
            return json.load(f)
    cpath = os.path.join(model_path, "cfg_args")
    if os.path.exists(cpath):
        import ast
        text = open(cpath).read().strip()
        inner = text[len("Namespace("):-1]
        out = {}
        # parse k=v pairs with literal_eval on values
        depth = 0
        parts, cur = [], ""
        for ch in inner:
            if ch in "([{":
                depth += 1
            elif ch in ")]}":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        if cur.strip():
            parts.append(cur)
        for p in parts:
            k, _, v = p.strip().partition("=")
            try:
                out[k] = ast.literal_eval(v)
            except Exception:
                out[k] = v
        return out
    return {}


def _explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    """Dests of the options actually present on the command line — the only
    reliable way to tell an explicitly-passed default value from an untouched
    one (value comparison can't; the reference shares that bug,
    arguments/__init__.py:91-111)."""
    opt_to_dest = {}
    for action in parser._actions:
        for opt in action.option_strings:
            opt_to_dest[opt] = action.dest
    dests = set()
    for tok in argv:
        if not tok.startswith("-"):
            continue
        opt = tok.split("=", 1)[0]
        if opt in opt_to_dest:
            dests.add(opt_to_dest[opt])
        elif opt.startswith("--"):
            # argparse accepts unambiguous long-option abbreviations
            hits = {d for o, d in opt_to_dest.items() if o.startswith(opt)}
            if len(hits) == 1:
                dests.add(hits.pop())
    return dests


def get_combined_args(parser: argparse.ArgumentParser,
                      argv=None) -> argparse.Namespace:
    """CLI over persisted training config (arguments/__init__.py:91-111):
    options explicitly present on the command line win (even when passed
    with their default value); everything else falls back to the model
    dir's saved config, then to the parser defaults."""
    import sys
    args = parser.parse_args(argv)
    eff_argv = sys.argv[1:] if argv is None else list(argv)
    explicit = _explicit_dests(parser, eff_argv)
    saved = load_cfg(getattr(args, "model_path", "") or "")
    merged = vars(args).copy()
    for k, v in saved.items():
        if k in merged and k not in explicit:
            merged[k] = v
    return argparse.Namespace(**merged)
