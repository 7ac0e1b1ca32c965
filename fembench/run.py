"""One run of one cell of the benchmark of fem_tpu_torch (see
fembench/harness/cli.py):

    python3 fembench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The program's kernel library is built into
build/kernels/ of the checkout on its first run there; the caches that
torch, Triton and the CUDA driver may write are kept under
build/fembench_cache/ of the checkout.
"""

import os
import sys
import time

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(REPO, "build", "fembench_cache", sub)
sys.path.insert(0, REPO)

from fembench.harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
