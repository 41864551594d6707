"""Seconds to build the CUDA kernels as one nvcc over a single unit that
includes every source of csrc/, with the flags of kernels.NVCC_FLAGS,
into a fresh directory under build/. kernels.build, which the first launch
calls, starts one nvcc per source instead, all together; chip_smoke.py's
phase 1 prints that build's seconds.

    python -m zkrollup_torch.tools.build_time

Prints one JSON object {"one_unit_s": seconds}.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

from .. import kernels


def one_unit_seconds() -> float:
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as d:
        src = os.path.join(d, "all.cu")
        with open(src, "w") as f:
            f.writelines(f'#include "{os.path.join(kernels._CSRC, u)}"\n'
                         for u in kernels.UNITS.values())
        t0 = time.time()
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                        os.path.join(d, "all.so"), src],
                       check=True, capture_output=True)
        return time.time() - t0


def main() -> int:
    print(json.dumps({"one_unit_s": one_unit_seconds()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
