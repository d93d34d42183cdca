"""Run one benchmark cell once on this machine's card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (see ``perfbench/harness.py``); exits non-zero with no
result where there is no card, or where the run loaded JAX or the JAX
package.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# kernel caches at fixed paths in the checkout, so that only a cell's first
# run there compiles (the program builds its own CUDA kernels into
# pointmvsnet_tpu_torch/_build/, also in the checkout)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(ROOT / ".perfbench_cache" / sub)

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
