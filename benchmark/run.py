"""The benchmark of the PyTorch port on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the check's numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output.
Exits non-zero without a result where there is no card, or where the run
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = HERE / ".cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE.parent))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
