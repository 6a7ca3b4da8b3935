#!/usr/bin/env python3
"""B3's f32 body on one CUDA card: against variants of its own design,
and against an earlier checkout's B3.

    python3 scripts/flash_attention_ab.py                # the variants
    python3 scripts/flash_attention_ab.py --parent DIR   # and DIR's B3

The variants are ``csrc/flash_attention.cu`` of this tree patched by text
(each patch asserts that its text is there), built with ``nvcc`` into
``build/variants/`` and called through the same C entry point:

- ``source``: the body as it is (Q, K and V split as their fragments
  are read; the small terms of S and of the output in accumulators of
  their own);
- ``q_once``: Q split once per block into hi and lo halves in shared
  memory (a second Q tile of shared memory);
- ``lo_rz``: lo = x - hi handed to the tensor cores unrounded (they read
  its top 19 bits: TF32 by truncation);
- ``s_merged``: S's small terms in S's own accumulator;
- ``so_merged``: the output's small terms merged as well.

Each is held against ``flash_attention_plain`` (largest share of the f32
allowance on six cases) and timed in a CUDA graph at stablelm_1_6b's
causal (4, 32, 512, 64) and gpt3_2_7b's and gpt3_0_7b's widths, twice
in turns. ``--parent DIR`` then runs DIR's and this tree's
``chip_smoke.check_attention`` in turns (parent, change, change,
parent), each in its own process, building its own checkout's kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

Q_LOAD = """      uint32_t qa[4], ah[4], al[4];
      ldsm_x4(qa, Qs + (w0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                      ks * 8 + (lane >> 4) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(qa[e]), ah[e], al[e]);
"""
S_MERGED = [("mma3(s[2 * np], sl[2 * np]", "mma3(s[2 * np], s[2 * np]"),
            ("mma3(s[2 * np + 1], sl[2 * np + 1]",
             "mma3(s[2 * np + 1], s[2 * np + 1]"),
            ("for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];",
             "for (int e = 0; e < 4; ++e) {}")]
VARIANTS = {
    "source": [],
    "q_once": [
        ("(kBQ + 4 * kBK);", "((sizeof(T) == 4 ? 2 : 1) * kBQ + 4 * kBK);"),
        ("  float* Ks = Qs + kBQ * RS;       // [2][kBK][RS]\n"
         "  float* Vs = Ks + 2 * kBK * RS;   // [2][kBK][RS]",
         "  float* Ql = Qs + kBQ * RS;\n"
         "  float* Ks = Ql + kBQ * RS;\n"
         "  float* Vs = Ks + 2 * kBK * RS;"),
        ("    const float* Vt = Vs + off;\n",
         "    const float* Vt = Vs + off;\n"
         "    if (kt == 0) {\n"
         "      for (int i = lane; i < 16 * HD; i += 32) {\n"
         "        const int at = (w0 + i / HD) * RS + i % HD;\n"
         "        uint32_t hi, lo;\n"
         "        split(Qs[at], hi, lo);\n"
         "        Qs[at] = __uint_as_float(hi);\n"
         "        Ql[at] = __uint_as_float(lo);\n"
         "      }\n"
         "      __syncwarp();\n"
         "    }\n"),
        (Q_LOAD,
         "      const int qo = (w0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS"
         " + ks * 8 + (lane >> 4) * 4;\n"
         "      uint32_t ah[4], al[4];\n"
         "      ldsm_x4(ah, Qs + qo);\n"
         "      ldsm_x4(al, Ql + qo);\n")],
    "lo_rz": [("lo = tf32(x - __uint_as_float(hi));",
               "lo = __float_as_uint(x - __uint_as_float(hi));")],
    "s_merged": S_MERGED,
    "so_merged": S_MERGED + [("mma3(acc[n], acl[n]", "mma3(acc[n], acc[n]")],
}
#: (B, H, L, hd): stablelm_1_6b, gpt3_2_7b, gpt3_0_7b at batch 4 x 512
TIMED = ((4, 32, 512, 64), (4, 32, 512, 80), (4, 16, 512, 96))
CHECKED = (((4, 32, 32, 512, 512, 64), {}, 2e-5),
           ((4, 32, 32, 512, 512, 80), {}, 2e-5),
           ((4, 16, 16, 512, 512, 96), {}, 2e-5),
           ((1, 8, 8, 512, 512, 128), {}, 2e-5),
           ((1, 4, 2, 200, 200, 64), {"window": 48, "cap": 30.0}, 3e-5),
           ((2, 2, 2, 77, 300, 128), {"causal": False}, 3e-5))


def build_variants() -> dict:
    """{name: loaded library}, one nvcc per variant, all at once; prints
    each f32 body's registers and spills."""
    import re

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    src = build.source("flash_attention").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{name}: patch text not in the source: "
                                 f"{old!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].splitlines()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n" + "\n".join(log))
        for i, line in enumerate(log):
            hd = re.search(r"flash_tf32_kernelILi(\d+)E", line)
            if hd and "Compiling entry" in line:
                info = [x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                        if "spill" in x or "registers" in x]
                print(f"  {name} hd {hd[1]}: {'; '.join(info)}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        fa._bind(libs[name])
    return libs


def call(lib, q, k, v, causal=True, window=None, cap=None):
    """The f32 body of ``lib`` on q, k, v, as the wrapper launches it."""
    import torch
    B, H, Lq, hd = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, H, k.shape[1], Lq, k.shape[2], hd, hd, 0, int(causal),
        -1 if window is None else window, 0.0 if cap is None else cap,
        1.0 / math.sqrt(hd), None, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def variants():
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.ref import flash_attention_plain
    print(f"card: {cs.card_line()}", flush=True)
    libs = build_variants()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)

    def qkv(B, H, KV, Lq, Lk, hd):
        # (B, L, H, hd) swapped to (B, H, L, hd), as the model calls it
        q = torch.randn((B, Lq, H, hd), generator=gen, device="cuda")
        k, v = (torch.randn((B, Lk, KV, hd), generator=gen, device="cuda")
                for _ in range(2))
        return [t.transpose(1, 2) for t in (q, k, v)]

    checked = [(qkv(*shape), kw, tol) for shape, kw, tol in CHECKED]
    wants = [flash_attention_plain(*x, **kw) for x, kw, _ in checked]
    timed = [qkv(B, H, H, L, L, hd) for B, H, L, hd in TIMED]
    for _ in range(2):
        for name, lib in libs.items():
            shares = []
            for (x, kw, tol), want in zip(checked, wants):
                err = (call(lib, *x, **kw) - want).abs()
                shares.append(float((err / (tol + tol * want.abs())).max()))
            ms = [cs._graph_ms(lambda: call(lib, *x)) for x in timed]
            print(f"  {name:10s} largest share {max(shares):.3f} "
                  f"({' '.join(f'{s:.3f}' for s in shares)}); in a CUDA "
                  f"graph: " + ", ".join(
                      f"{shape} {t:.4f} ms" for shape, t in zip(TIMED, ms)),
                  flush=True)


def against(parent: Path):
    code = ("import sys, torch; sys.path[:0] = ['src', '.']; "
            "import chip_smoke as cs; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "e = cs.check_attention(torch.device('cuda')); "
            "print('entry', {k: v for k, v in e.items() if 'ms' in k})")
    for name, where in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", code], cwd=where,
                             capture_output=True, text=True)
        print(f"==== {name} ({where}): rc {out.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in out.stdout.splitlines():
            if line.startswith(("  time ", "entry", "  largest")):
                print(line, flush=True)
        if out.returncode:
            raise SystemExit(out.stderr[-3000:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="an earlier checkout whose B3 to time in turns "
                         "with this tree's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    variants()
    if args.parent:
        against(args.parent.resolve())


if __name__ == "__main__":
    main()
