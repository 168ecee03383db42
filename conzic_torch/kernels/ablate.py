"""Where the time of ``csrc/masked_attention.cu`` goes: its tensor-core
kernel with parts left out, and with other layout constants.

    python3 -m conzic_torch.kernels.ablate [--reps 2]

Each variant is a copy of the kernel's sources in which lines are replaced
(``VARIANTS``), built like the kernel itself into
``build/conzic_torch/ablate/`` and timed at the main path's text suffix
chunk (N = 800, Sq = 16, P = 8, Ss = 16, H = 8, D = 64, bf16, causal, key
lengths) beside the unchanged source, as chip_smoke.py times a kernel (50
calls in one CUDA graph). The unchanged source's ``-Xptxas -v`` report
(registers of each kernel) is printed first. A variant that leaves a part out computes
garbage: only its time means anything. A replaced line that is no longer in
the source stops the script; the list follows the source. Prints the card's
name and power limit first. The port calls nothing of this.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from conzic_torch.kernels import build
from conzic_torch.kernels.timing import time_ms

SOURCE = "masked_attention.cu"
HEADER = "attention_mma.cuh"
_NO_COPIES = (
    "    copy_in(st, q + n * Sq * HD + col, Sq);\n"
    "    copy_in(st + Sq * ld, k + n * Ss * HD + col, Ss);\n"
    "    copy_in(st + (Sq + Ss) * ld, v + n * Ss * HD + col, Ss);", "")
_NO_STORES = ("    for (int r = r_first, c = c_first; r < Sq;) {",
              "    for (int r = r_first, c = c_first; r < 0;) {")
_NO_ATTENTION = ("    for (int it = warp; it < items; it += warps) {",
                 "    for (int it = warp; it < 0; it += warps) {")
_NO_EXP = ("expf(s[nt][i] - row_max[i >> 1])", "(s[nt][i] - row_max[i >> 1])")
_NO_QK = ("      mma_bf16(s[2 * kt], a, b[0], b[1]);\n"
          "      mma_bf16(s[2 * kt + 1], a, b[2], b[3]);",
          "      s[2 * kt][0] += __uint_as_float(b[0] ^ a[0]);\n"
          "      s[2 * kt + 1][0] += __uint_as_float(b[2]);")
_NO_WV = ("      mma_bf16(o[0], w[kt], b[0], b[1]);\n"
          "      mma_bf16(o[1], w[kt], b[2], b[3]);",
          "      o[0][0] += __uint_as_float(b[0] ^ w[kt][0]);\n"
          "      o[1][0] += __uint_as_float(b[2]);")

Replace = Tuple[str, str]
VARIANTS: Dict[str, List[Replace]] = {
    "as committed": [],
    "no q/k/v copies": [_NO_COPIES],
    "no output stores": [_NO_STORES],
    "no attention": [_NO_ATTENTION],
    "copies only": [_NO_ATTENTION, _NO_STORES],
    "attention only": [_NO_COPIES, _NO_STORES],
    "attention only, no exp": [_NO_COPIES, _NO_STORES, _NO_EXP],
    "attention only, no q.k products": [_NO_COPIES, _NO_STORES, _NO_QK],
    "attention only, no w.v products": [_NO_COPIES, _NO_STORES, _NO_WV],
    "loop only": [_NO_COPIES, _NO_STORES, _NO_ATTENTION],
    "kUnitsPerSm 1": [("kUnitsPerSm = 8;", "kUnitsPerSm = 1;")],
    "kUnitsPerSm 16": [("kUnitsPerSm = 8;", "kUnitsPerSm = 16;")],
    "kStages 3": [("kStages = 2;", "kStages = 3;")],
}


def build_variants() -> Dict[str, str]:
    """Every variant's library, all compiled at once; raises on a failure
    or on a line that is not in the source."""
    texts = {name: (build.CSRC / name).read_text()
             for name in (SOURCE, HEADER)}
    root = build.BUILD_DIR / "ablate"
    procs = {}
    for i, (label, replaces) in enumerate(VARIANTS.items()):
        out = root / str(i)
        out.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, out)
        files = dict(texts)
        for old, new in replaces:
            hits = [f for f, text in files.items() if old in text]
            if not hits:
                raise RuntimeError(f"{label}: {old.strip()[:60]!r} is not in "
                                   f"the source")
            files[hits[0]] = files[hits[0]].replace(old, new)
        for f, text in files.items():
            (out / f).write_text(text)
        lib = str(out / "lib.so")
        report = ["-Xptxas", "-v"] if not replaces else []
        procs[label] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *report, "-o", lib,
             str(out / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for label, (lib, proc) in procs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{out[-3000:]}")
        for line in out.splitlines():  # the committed source's report
            if "Compiling entry" in line or "registers" in line:
                print(f"ptxas: {line.split(': ', 1)[-1]}", flush=True)
        libs[label] = lib
    return libs


def text_chunk_call():
    """The main path's text suffix chunk in the prefix form, from seed 0."""
    from conzic_torch.kernels.masked_attention import masked_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    N, Sq, P, Ss, H, D, B = 800, 16, 8, 16, 8, 64, 32

    def draw(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    q, k, v = draw(N, Sq, H, D), draw(N, Ss, H, D), draw(N, Ss, H, D)
    prefix = (draw(B, P, H, D), draw(B, P, H, D))
    lens = torch.randint(P + 1, P + Ss + 1, (N,), device="cuda",
                         generator=gen, dtype=torch.int32)
    return lambda: masked_attention(q, k, v, lens, True, prefix)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="rounds over all variants (the second in reverse)")
    args = ap.parse_args(argv)
    print(build.card_line(), flush=True)
    libs = build_variants()
    call = text_chunk_call()
    labels = list(libs)
    for rep in range(args.reps):
        for label in labels if rep % 2 == 0 else labels[::-1]:
            lib = ctypes.CDLL(libs[label])
            lib.conzic_error_string.argtypes = [ctypes.c_int]
            lib.conzic_error_string.restype = ctypes.c_char_p
            build._loaded["masked_attention"] = lib  # the wrapper's library
            print(f"masked_attention text suffix chunk [{label}]: "
                  f"{time_ms(call, 50):.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
