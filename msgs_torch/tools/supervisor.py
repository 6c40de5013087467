"""Training supervisor: stall detection and automatic resume, port of
tools/supervisor.py.

Runs `msgs_torch.apps.train` as a subprocess and watches its log for
progress; on a stall (no log growth for --stall_sec) it asks the trainer
for a stack dump (SIGUSR1), kills its process group and restarts it from
the newest chkpntN.npz in the model dir; a trainer that exits non-zero is
restarted the same way, up to --max_restarts times.

  python -m msgs_torch.tools.supervisor --stall_sec 300 -- \
      -s data/synth1 -m data/run_ms --iterations 7000 \
      --checkpoint_iterations 1000 2000 ...

Everything after `--` goes to the trainer verbatim; --checkpoint_iterations
should include regular points for the resume to have one.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import signal
import subprocess
import sys
import time

POLL_S = 20       # how often the log is checked for growth


def latest_checkpoint(model_path: str):
    """The chkpntN.npz with the largest N in model_path, or None."""
    cands = glob.glob(os.path.join(model_path, "chkpnt*.npz"))
    if not cands:
        return None
    return max(cands, key=lambda p: int(re.search(r"chkpnt(\d+)",
                                                   p).group(1)))


def model_path_of(train_args) -> str:
    for i, a in enumerate(train_args):
        if a in ("-m", "--model_path") and i + 1 < len(train_args):
            return train_args[i + 1]
    raise SystemExit("supervisor: the trainer's arguments must include "
                     "-m <model_path>")


def train_command(train_args, model_path: str) -> list:
    """The trainer's command line, resuming from the newest checkpoint."""
    cmd = [sys.executable, "-m", "msgs_torch.apps.train"] + list(train_args)
    ckpt = latest_checkpoint(model_path)
    if ckpt:
        cmd += ["--start_checkpoint", ckpt]
        print(f"[supervisor] resuming from {ckpt}")
    return cmd


def main(argv=None):
    ap = argparse.ArgumentParser("msgs_torch supervisor")
    ap.add_argument("--stall_sec", type=int, default=300)
    ap.add_argument("--max_restarts", type=int, default=10)
    ap.add_argument("--log", default=None)
    ap.add_argument("train_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    train_args = [a for a in args.train_args if a != "--"]
    model_path = model_path_of(train_args)
    log_path = args.log or os.path.join(model_path, "supervisor_train.log")
    os.makedirs(model_path, exist_ok=True)

    restarts = 0
    while restarts <= args.max_restarts:
        cmd = train_command(train_args, model_path)
        print(f"[supervisor] launch: {' '.join(cmd)}", flush=True)
        # Unbuffered, so the log grows as the trainer prints: a
        # block-buffered child writes its progress lines in 8 KiB bursts,
        # minutes apart, which would read as a stall.
        with open(log_path, "ab") as lf:
            proc = subprocess.Popen(cmd, stdout=lf, stderr=lf,
                                    start_new_session=True,
                                    env=dict(os.environ,
                                             PYTHONUNBUFFERED="1"))
        last_size = -1
        last_progress = time.time()
        while True:
            try:
                ret = proc.wait(timeout=POLL_S)
            except subprocess.TimeoutExpired:
                ret = None
            if ret is not None:
                if ret == 0:
                    print("[supervisor] training finished")
                    return 0
                print(f"[supervisor] trainer exited {ret}; restarting")
                break
            size = os.path.getsize(log_path) if os.path.exists(log_path) \
                else 0
            if size != last_size:
                last_size = size
                last_progress = time.time()
            elif time.time() - last_progress > args.stall_sec:
                print(f"[supervisor] stall > {args.stall_sec}s — killing "
                      f"pgid {proc.pid}", flush=True)
                try:
                    os.killpg(proc.pid, signal.SIGUSR1)  # stack dump to log
                    time.sleep(3)
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()
                break
        restarts += 1
        time.sleep(5)
    print(f"[supervisor] giving up after {restarts} restarts")
    return 1


if __name__ == "__main__":
    sys.exit(main())
