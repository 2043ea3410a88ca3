"""The parallel phase of ``chip_smoke.py`` alone, with its HTTP server over
ranks (the served arm):

    python3 tools/torch_parallel_probe.py

On the card: builds the kernels, then runs ``phase_parallel`` (every arm and
check of the phase; not the eval phase's ``eval_model --stages 2``, which
needs the quantize phase's artifact, nor the e2e phase). Prints the phase's
log and its seconds; exits 1 where a check fails.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()
    name, smi = cs.phase_device(torch)
    cs.phase_build()
    results = cs.kernel_results()
    t0 = time.perf_counter()
    try:
        cs.phase_parallel(torch, results, smi)
    except cs.SmokeFailure as e:
        print(f"probe: FAILED: {e}", flush=True)
        sys.exit(1)
    print(f"probe: parallel phase {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
