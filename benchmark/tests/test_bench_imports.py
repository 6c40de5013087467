"""Nothing the benchmark runs loads JAX or the JAX package: the check
compares whole top-level module names (msgs_torch begins with msgs). The
reference loads nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_tiny_run_loads_no_jax():
    mods = _modules(
        "import sys; sys.path.insert(0, 'benchmark/tests')\n"
        "import tiny; tiny.run('3dgs-db.render')")
    assert "msgs_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "msgs"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import benchmark.reference, benchmark.work, "
                    "benchmark.trace, benchmark.traj")
    assert not mods & {"msgs_torch", "msgs", "jax"}


def test_forbidden_is_by_whole_top_level_name():
    from benchmark import harness as H
    assert "msgs" in H.FORBIDDEN and "msgs_torch" not in H.FORBIDDEN
    sys.modules.setdefault("msgs_torch_lookalike", sys)
    assert "msgs_torch_lookalike" not in H.forbidden_modules()
