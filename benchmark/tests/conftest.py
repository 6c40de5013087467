"""The benchmark's own tests: CPU only, at tiny sizes. They import the
benchmark as the package `benchmark` from the repository root."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
