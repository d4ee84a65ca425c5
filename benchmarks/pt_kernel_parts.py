#!/usr/bin/env python3
"""Where the time of the port's B6 and B7 kernels goes, on an NVIDIA GPU.

    python3 benchmarks/pt_kernel_parts.py

Rebuilds ``csrc/swa.cu`` (sliding-window attention) and ``csrc/wkv6.cu``
(chunked RWKV-6) with one part of their work taken out and times each
variant at the full widths of chip_smoke.py (gemma3-4b's local layers,
rwkv6-7b's time mix) with its ``cuda_ms``; the difference to the
unchanged build is what that part costs.  The variants compute wrong
results: they are for timing only and never leave this script.

- ``one_pass``: one TF32 product (hi·hi) where the kernels take three;
- ``no_split``: the operands passed to the MMAs unsplit (no integer work);
- ``no_exp`` (swa): the softmax's ``expf`` replaced by an add;
- ``no_prod`` (wkv6 state pass): the kd^T v product skipped;
- ``no_mma`` (wkv6 output kernel): each split product replaced by an add.

The wkv6 variants time its two kernels, the state pass and the outputs,
each alone.  Variant sources and libraries go to the gitignored
``build/kernel_parts/``.  Prints one JSON line per variant and the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
OUT = REPO / "build" / "kernel_parts"

SPLIT = """  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));"""
MMA3 = """  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);"""
STATE_PRODUCT = """      float acc[8][4] = {};
      for (int t = 0; t < c; ++t) {"""
INCLUDE = '#include "tf32_mma.cuh"'

# (old, new) replacements of the header, and defines put after the
# source's includes, for each variant
HEADER_PATCHES = {
    "one_pass": [(MMA3, "  mma_tf32(c, ahi, bhi);")],
    "no_split": [(SPLIT, "  hi = __float_as_uint(a);\n  lo = hi;")],
    "no_mma": [(MMA3, "  c[0] += __uint_as_float(ahi[0] ^ blo[1]);")],
}
DEFINES = {"no_exp": "#define expf(x) ((x) + 1.f)\n"}
SOURCE_PATCHES = {
    "no_prod": [(STATE_PRODUCT, STATE_PRODUCT.replace(
        "      for", "      if (c < 0)\n      for"))],
}


def patched(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"kernel_parts: the source no longer has "
                               f"exactly one {old[:40]!r}; update the patch")
        text = text.replace(old, new)
    return text


def build_variant(name: str, variant: str) -> ctypes.CDLL:
    """lib<name>_<variant>.so from a patched copy of csrc/<name>.cu."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    header = patched((CSRC / "tf32_mma.cuh").read_text(),
                     HEADER_PATCHES.get(variant, ()))
    (OUT / f"tf32_{variant}.cuh").write_text(header)
    src = patched((CSRC / f"{name}.cu").read_text(),
                  SOURCE_PATCHES.get(variant, ()))
    src = patched(src, [(INCLUDE, f'#include "tf32_{variant}.cuh"\n'
                         + DEFINES.get(variant, ""))])
    cu = OUT / f"{name}_{variant}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{name}_{variant}.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    bh, t, d, window = cs.SWA_FULL
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 62)
    q, k, v = (torch.randn((bh, t, d), generator=g, device=dev)
               for _ in range(3))
    o = torch.empty_like(q)
    for variant in ("base", "one_pass", "no_split", "no_exp"):
        fn = build_variant("swa", variant).swa_forward
        fn.restype, fn.argtypes = I, [P] * 4 + [I] * 4 + [F, P]
        ms = cs.cuda_ms(torch, lambda: fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, t, d,
            window, d ** -0.5, stream))
        cs.emit({"kernel": "swa_attention", "variant": variant, "ms": ms,
                 "shape": {"BH": bh, "T": t, "d": d, "window": window}})
    del q, k, v, o

    bh, t, dk, dv, c = cs.WKV_FULL
    r, k, v, w, u = cs.wkv6_inputs(torch, dev, bh, t, dk, dv, cs.W_TPU_MIN,
                                   cs.SEED + 61)
    states = torch.zeros((bh, t // c, dk, -(-dv // 64) * 64), device=dev)
    out = torch.empty((bh, t, dv), device=dev)
    sfin = torch.empty((bh, dk, dv), device=dev)
    for variant in ("base", "no_prod", "one_pass", "no_split", "no_mma"):
        lib = build_variant("wkv6", variant)
        lib.wkv6_state.restype = lib.wkv6_out.restype = I
        lib.wkv6_state.argtypes = [P] * 5 + [I] * 5 + [P]
        lib.wkv6_out.argtypes = [P] * 7 + [I] * 5 + [P]
        sizes = (bh, t, dk, dv, c, stream)
        ms_state = cs.cuda_ms(torch, lambda: lib.wkv6_state(
            k.data_ptr(), v.data_ptr(), w.data_ptr(), states.data_ptr(),
            sfin.data_ptr(), *sizes))
        ms_out = cs.cuda_ms(torch, lambda: lib.wkv6_out(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), states.data_ptr(), out.data_ptr(), *sizes))
        cs.emit({"kernel": "wkv6_chunked", "variant": variant,
                 "state_ms": ms_state, "out_ms": ms_out,
                 "shape": {"BH": bh, "T": t, "dk": dk, "dv": dv,
                           "chunk": c}})
    cs.print_card()
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())
