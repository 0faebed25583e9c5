"""Run one cell of the benchmark:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The set-up time counts from here."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    # caches a build or a library may write go to fixed directories in the
    # checkout (the port's own kernel library builds in its _build/)
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(cache / sub))
    from benchmark import harness
    return harness.main(sys.argv[1:], T0)


if __name__ == "__main__":
    sys.exit(main())
