"""Where the time of the port's attention kernels goes: a kernel's sources
with parts left out, and with other layout constants.

    python3 -m conzic_torch.kernels.ablate [--kernel masked_attention]
                                           [--reps 2]

``--kernel`` is ``masked_attention`` (the default: its tensor-core kernel,
``csrc/masked_attention.cu`` and ``csrc/attention_mma.cuh``),
``attention_with_out`` or ``attention_block`` (their wgmma kernels,
``csrc/<kernel>.cu`` and ``csrc/hopper_gemm.cuh``). Each variant is a copy
of the kernel's sources in which lines are replaced (``VARIANTS``), built
like the kernel itself into ``build/conzic_torch/ablate/<kernel>/`` and
timed at the main path's shapes beside the unchanged source, as
chip_smoke.py times a kernel (50 calls in one CUDA graph): masked
attention and attention_with_out at the text suffix chunk (N = 800, Sq =
16, P = 8, Ss = 16, H = 8, D = 64, E = 512, bf16, causal, key lengths, the
prefix form), attention_block at BERT rows (N = 32, S = 15, E = 768),
vision rows (S = 50) and the text full-row chunk (N = 800, S = 24, E =
512, causal). The unchanged source's ``-Xptxas -v`` report (registers of
each kernel) is printed first. A variant that leaves a part out computes
garbage: only its time means anything. A replaced line that is no longer
in the source stops the script; the lists follow the sources. Prints the
card's name and power limit first. The port calls nothing of this.
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

# the files of each kernel that variants may change: its source, its header
FILES = {
    "masked_attention": ("masked_attention.cu", "attention_mma.cuh"),
    "attention_with_out": ("attention_with_out.cu", "hopper_gemm.cuh"),
    "attention_block": ("attention_block.cu", "hopper_gemm.cuh"),
}
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
MASKED_ATTENTION: Dict[str, List[Replace]] = {
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


# attention_with_out: the attention of a unit, its wgmma, its loads
_WO_NO_ATTENTION = ("    for (int it = warp & 3; it < items; it += 4) {",
                    "    for (int it = warp & 3; it < 0; it += 4) {")
_WO_NO_WGMMA = ("    hp::wgmma_tile<kOutCols>(\n        acc,",
                "    if (false) hp::wgmma_tile<kOutCols>(\n        acc,")
_WO_NO_QKV_LOADS = [
    ("        hp::bar_expect(&full_q[sq], R * Sq * hp::kRowBytes);\n"
     "        hp::tma_load(q_ring",
     "        hp::bar_expect(&full_q[sq], 0);\n"
     "        if (false) hp::tma_load(q_ring"),
    ("        hp::bar_expect(&full_kv[skv],\n"
     "                       (2 * R * Ss + 2 * (b1 - b0 + 1) * P) * "
     "hp::kRowBytes);",
     "        hp::bar_expect(&full_kv[skv], 0);\n        if (false) {"),
    ("          hp::tma_load(pre + p_bytes, &maps.pv, &full_kv[skv], col, "
     "b * P);\n        }\n",
     "          hp::tma_load(pre + p_bytes, &maps.pv, &full_kv[skv], col, "
     "b * P);\n        }\n        }\n")]
WITH_OUT: Dict[str, List[Replace]] = {
    "as committed": [],
    "no attention": [_WO_NO_ATTENTION],
    "no wgmma": [_WO_NO_WGMMA],
    "loads only": [_WO_NO_ATTENTION, _WO_NO_WGMMA],
    "Wo loads only": [_WO_NO_ATTENTION, _WO_NO_WGMMA, *_WO_NO_QKV_LOADS],
    "look-ahead 1": [("constexpr int kLookAhead = 2;",
                      "constexpr int kLookAhead = 1;")],
}
# attention_block: the attention of the first kernel, each kernel alone
_BLOCK_NO_ATTENTION = (
    "  for (int u = warp; u < ng * m_tiles; u += kWG * 4) {",
    "  for (int u = warp; u < 0; u += kWG * 4) {")
BLOCK: Dict[str, List[Replace]] = {
    "as committed": [],
    "no attention": [_BLOCK_NO_ATTENTION],
    "first kernel only": [("  if (code != 0) return code;\n"
                           "  if (plan.out_wg == 2)",
                           "  if (true) return code;\n"
                           "  if (plan.out_wg == 2)")],
    "second kernel only": [("  int code = plan.wg == 2",
                            "  int code = 0;\n  if (false) code = plan.wg == 2")],
}
VARIANTS: Dict[str, Dict[str, List[Replace]]] = {
    "masked_attention": MASKED_ATTENTION,
    "attention_with_out": WITH_OUT,
    "attention_block": BLOCK,
}


def build_variants(kernel: str) -> Dict[str, str]:
    """Every variant's library, all compiled at once; raises on a failure
    or on a line that is not in the sources."""
    source = FILES[kernel][0]
    texts = {name: (build.CSRC / name).read_text() for name in FILES[kernel]}
    root = build.BUILD_DIR / "ablate" / kernel
    procs = {}
    for i, (label, replaces) in enumerate(VARIANTS[kernel].items()):
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
             str(out / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for label, (lib, proc) in procs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{out[-3000:]}")
        for line in out.splitlines():  # the committed source's report
            if ("Compiling entry" in line or "registers" in line
                    or "C75" in line):
                print(f"ptxas: {line.split(': ', 1)[-1]}", flush=True)
        libs[label] = lib
    return libs


def _draw(gen, *shape, std=1.0):
    return (torch.randn(*shape, device="cuda", generator=gen)
            * std).bfloat16()


def text_chunk_call():
    """The main path's text suffix chunk in the prefix form, from seed 0."""
    from conzic_torch.kernels.masked_attention import masked_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    N, Sq, P, Ss, H, D, B = 800, 16, 8, 16, 8, 64, 32

    def draw(*shape):
        return _draw(gen, *shape)

    q, k, v = draw(N, Sq, H, D), draw(N, Ss, H, D), draw(N, Ss, H, D)
    prefix = (draw(B, P, H, D), draw(B, P, H, D))
    lens = torch.randint(P + 1, P + Ss + 1, (N,), device="cuda",
                         generator=gen, dtype=torch.int32)
    return lambda: masked_attention(q, k, v, lens, True, prefix)


def with_out_call():
    """attention_with_out at the text suffix chunk, prefix form, seed 0."""
    from conzic_torch.kernels.attention_with_out import attention_with_out

    gen = torch.Generator(device="cuda").manual_seed(0)
    N, Sq, P, Ss, H, D, B, E = 800, 16, 8, 16, 8, 64, 32, 512
    q, k, v = (_draw(gen, N, S, H, D) for S in (Sq, Ss, Ss))
    prefix = (_draw(gen, B, P, H, D), _draw(gen, B, P, H, D))
    wo, bo = _draw(gen, E, H * D, std=0.03), _draw(gen, E, std=0.1)
    lens = torch.randint(P + 1, P + Ss + 1, (N,), device="cuda",
                         generator=gen, dtype=torch.int32)
    return lambda: attention_with_out(q, k, v, wo, bo, lens, True, prefix)


def block_call(N, S, E, H, causal):
    """attention_block at one main-path shape, seed 0."""
    from conzic_torch.kernels.attention_block import attention_block

    gen = torch.Generator(device="cuda").manual_seed(0)
    x, res = _draw(gen, N, S, E), _draw(gen, N, S, E)
    params = [t for _ in range(4)
              for t in (_draw(gen, E, E, std=0.03), _draw(gen, E, std=0.1))]
    lens = torch.randint(1, S + 1, (N,), device="cuda", generator=gen,
                         dtype=torch.int32) if causal else None
    return lambda: attention_block(x, res, *params, lens, heads=H,
                                   causal=causal)


def calls(kernel: str):
    """(label, call) of each main-path shape the kernel is timed at."""
    if kernel == "masked_attention":
        return [("text suffix chunk", text_chunk_call())]
    if kernel == "attention_with_out":
        return [("text suffix chunk, prefix form", with_out_call())]
    return [("bert rows", block_call(32, 15, 768, 12, False)),
            ("vision rows", block_call(32, 50, 768, 12, False)),
            ("text full-row chunk", block_call(800, 24, 512, 8, True))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=tuple(VARIANTS),
                    default="masked_attention")
    ap.add_argument("--reps", type=int, default=2,
                    help="rounds over all variants (the second in reverse)")
    args = ap.parse_args(argv)
    print(build.card_line(), flush=True)
    libs = build_variants(args.kernel)
    shapes = calls(args.kernel)
    labels = list(libs)
    for rep in range(args.reps):
        for label in labels if rep % 2 == 0 else labels[::-1]:
            lib = ctypes.CDLL(libs[label])
            lib.conzic_error_string.argtypes = [ctypes.c_int]
            lib.conzic_error_string.restype = ctypes.c_char_p
            build._loaded[args.kernel] = lib  # the wrapper's library
            for shape, call in shapes:
                print(f"{args.kernel} {shape} [{label}]: "
                      f"{time_ms(call, 50):.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
