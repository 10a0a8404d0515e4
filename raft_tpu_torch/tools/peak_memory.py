"""Run a Python script and print the peak device memory its process
allocated through PyTorch's caching allocator, once the script has ended.

    python raft_tpu_torch/tools/peak_memory.py SCRIPT [ARGS ...]

SCRIPT runs as ``__main__`` with ``sys.argv`` = [SCRIPT, ARGS ...] and its
own directory first on ``sys.path``, as ``python SCRIPT`` would run it, so
this file can measure another tree's script (an older commit's
``chip_smoke.py`` from ``git archive``): it imports nothing of the
package. The last line is ``peak device memory of the whole run X GiB``
(``torch.cuda.max_memory_allocated()``, card 0; a script that resets the
peak statistics itself gives only the peak since its last reset). The
exit code is the script's.
"""
from __future__ import annotations

import os
import runpy
import sys

import torch


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    script = os.path.abspath(sys.argv[1])
    sys.argv = sys.argv[1:]
    sys.path[0] = os.path.dirname(script)
    code = 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (e.code is not None)
    finally:
        if torch.cuda.is_available():
            print("peak device memory of the whole run "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
