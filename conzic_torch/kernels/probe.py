"""Build and run ``csrc/probe_rates.cu``: the card's own rates for what the
tensor-core kernels wait on, each measured alone: an ``mma.sync`` and a
``cp.async`` ring fed from L2 (the attention cores), a ``wgmma`` m64n192k16
and m64n256k16 and a TMA ring fed from L2, with and without a 2-block
multicast (the fused kernels' projections).

    python3 -m conzic_torch.kernels.probe

Prints the card's name and power limit, then the program's lines. The
numbers are the yardstick beside the kernels' own times in PERF.md; the port
calls nothing of this.
"""

from __future__ import annotations

import subprocess
import sys

from conzic_torch.kernels import build


def main() -> int:
    exe = build.BUILD_DIR / "probe_rates"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-o", str(exe),
                    str(build.CSRC / "probe_rates.cu")], check=True)
    print(build.card_line(), flush=True)
    return subprocess.run([str(exe)], timeout=300).returncode


if __name__ == "__main__":
    sys.exit(main())
