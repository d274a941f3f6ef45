"""One run of one benchmark cell of the PyTorch and CUDA port on the card.

    python3 perf_bench/run.py --workload ours-seeds8 --seed 7 --seconds 10 \
        --trace 0

Set-up (the port's import, the kernels' build or load, the campaign, the
teach, the seed batch, the warm ticks) is ``setup_s``; the window is one
call of ``run_campaign_repeat``.  Then the reference in ``refsim`` runs
its own teach and the checked rows' repeat, and the program's teach,
states and window are compared with it; the stages recorded in the
window's first ticks are compared with ``plainref``.  The last line of standard output is
the result (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and the ``check`` numbers
beside their limits); the check's numbers are also the last lines of
standard error.  Exits non-zero and prints no result without a CUDA card,
or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the checkout's fixed build directories: only a cell's first run builds
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from pbench import runner
    from pbench.spec import find_cell

    t_start = min(runner.process_start_s(), T_IMPORT)
    try:
        cell = find_cell(args.workload)
    except (KeyError, OSError, ValueError) as e:
        runner.log(f"cannot read the cell: {e}")
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        runner.log(f"needs {cell.chips} CUDA card(s); found "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        out = runner.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start)
    except ImportError as e:
        runner.log(f"the port is not importable here: {e}")
        return 4
    found = runner.forbidden_modules()
    if found:
        runner.log(f"modules of JAX or the JAX package loaded: {found}")
        return 5
    runner.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
