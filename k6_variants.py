"""Where kernel K6's time goes on one NVIDIA GPU.

    python3 k6_variants.py

Builds variants of ``nerfacc_tpu_torch/csrc/table_grad_pos.cu``, each with
one part changed by a text substitution, into ``build/k6_variants/`` and
times each on ``chip_smoke.py``'s phase-5 inputs (2^19 samples x 8 fetches
over 2 x 2^16 rows), three rounds in turn, with ``chip_smoke.time_ms``.
Every time includes what the wrapper launches: the ``torch.zeros`` of the
output, the positions' pre-pass and the tile kernel.

- ``kernel``: the source as it is.
- ``staging only``: the walk removed; a block stages its tile and stops.
- ``seven blocks an SM``: the shared memory split for seven resident
  blocks, as many as their tiles fit, which leaves L1 about 28 KB.
- ``three position arrays``: a pair gathers x, y and z from the three
  input arrays, not one packed 16 B record.
- ``in-order cotangents``: a pair reads the cotangent at its own place in
  the sorted order instead of the permutation's, which shows what the
  random gather costs (the result is wrong).

The variants that keep the function are held against the plain version.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

WALK = "  // ---- 2. the walk: warp w sums pairs [sb, se) of the tile ----------------\n"
STAGE_ONLY = WALK + (
    "  if ((tid & 31) == 0 && (tid >> 5) * kWarpPairs < count) {\n"
    "    out[blockIdx.x * 8 + (tid >> 5)] = __uint_as_float(st.w[(tid >> 5) * 16][0].x) +\n"
    "        static_cast<float>(st.dst[(tid >> 5) * kWarpPairs]) + __uint_as_float(st.d[(tid >> 5) * 16][0].x);\n"
    "  }\n"
    "  return;\n"
)
# (name, keeps the function, substitutions)
VARIANTS = (
    ("kernel", True, ()),
    ("staging only", False, ((WALK, STAGE_ONLY),)),
    ("seven blocks an SM", True, (("constexpr int kBlocksPerSm = 4;", "constexpr int kBlocksPerSm = 7;"),)),
    ("three position arrays", True, (
        ("const float4* __restrict__ pos,\n",
         "const float4* __restrict__ pos, const float* __restrict__ xs,\n"
         "const float* __restrict__ ys, const float* __restrict__ zs,\n"),
        ("q[m] = __ldg(pos + s);", "q[m] = make_float4(__ldg(xs + s), __ldg(ys + s), __ldg(zs + s), 0.f);"),
        ("const float4* pos,\n           const void* dout,",
         "const float4* pos, const float* xs, const float* ys, const float* zs,\n           const void* dout,"),
        ("sorted_key, perm, pos, static_cast", "sorted_key, perm, pos, xs, ys, zs, static_cast"),
        ("(sorted_key, perm, p4, dout,", "(sorted_key, perm, p4, xs, ys, zs, dout,"),
    )),
    ("in-order cotangents", False, (("dv[m] = __ldg(dout + p[m]);", "dv[m] = __ldg(dout + begin + i);"),)),
)


def build(out_dir: Path) -> dict:
    """Each variant's source, compiled by nvcc in parallel into a library."""
    from nerfacc_tpu_torch.ops import _build

    src = (_build.CSRC / "table_grad_pos.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, _, subs) in enumerate(VARIANTS):
        text = src
        for old, new in subs:
            if old not in text:
                cs.fail(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"variant {name!r} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    from nerfacc_tpu_torch.ops import table_grad as tg

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    args, _, _ = cs.k6_inputs(cs.shell_points(np.random.default_rng(1), cs.TRAIN_CAPACITY, dev),
                              np.random.default_rng(2), dev)
    sorted_key, perm, xs, ys, zs, dout, n_rows, fetches, F, consts = args
    argtypes = tg._table_grad_pos_lib().table_grad_pos_launch.argtypes
    libs = build(Path("build/k6_variants"))
    n, nf, jg = xs.shape[0], len(fetches), len(fetches[0].res)
    res = (ctypes.c_float * (nf * jg))(*[float(r) for f in fetches for r in f.res])
    j_lo = (ctypes.c_int * nf)(*[f.j_lo for f in fetches])
    key = (ctypes.c_int * nf)(*[f.key for f in fetches])

    def run(lib):
        pos = torch.empty((n, 4), dtype=torch.float32, device=dev)
        return tg._launch(lib, "table_grad_pos_launch", (sorted_key, perm, xs, ys, zs, pos, dout), n_rows,
                          n, nf, jg, F, tg.ROW_WIDTH // (8 * F), res, j_lo, key, span=tg.K6_TILE)

    want = tg.table_grad_pos_plain(*args)
    for (name, keeps, _), lib in zip(VARIANTS, libs.values()):
        lib.table_grad_pos_launch.argtypes = argtypes
        lib.table_grad_pos_launch.restype = ctypes.c_int
        if keeps:
            err = float((run(lib) - want).abs().max())
            if not err <= 1e-5 * float(want.abs().max()):
                cs.fail(f"variant {name!r} disagrees with the plain version: {err}")
    times = {name: [] for name in libs}
    for _ in range(3):
        for name, lib in libs.items():
            times[name].append(cs.time_ms(lambda: run(lib)))
    zeros_ms = cs.time_ms(lambda: torch.zeros((n_rows, 128), device=dev))
    for name, ms in times.items():
        print(f"variant {name}: {float(np.median(ms)):.4f} ms (rounds {', '.join(f'{t:.4f}' for t in ms)})",
              flush=True)
    print(f"torch.zeros of the output alone: {zeros_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
