"""Where the time of kernels K2 and K6 goes on one NVIDIA GPU.

    python3 kernel_variants.py            # both kernels
    python3 kernel_variants.py k2         # one of them

Builds variants of a kernel's source, each with one part changed by a text
substitution, into ``build/kernel_variants/`` and times each on
``chip_smoke.py``'s phase-5 inputs, three rounds in turn, with
``chip_smoke.time_ms``.  Every time includes what the wrapper launches: the
``torch.zeros`` of the output and the kernel (for K6 also the positions'
pre-pass).  The variants that keep the function are held against the plain
version.

K2 (``csrc/table_grad_u10.cu``; 2^21 sample-levels over 4 x 2^15 rows):

- ``kernel``: the source as it is.
- ``staging only``: the walk removed; a block stages its tile and stops.
- ``tiles of 512``: 512-sample tiles of 128 threads, four blocks an SM
  (the same shared memory).
- ``four blocks an SM``, ``twelve blocks an SM``: the shared memory split
  for that many resident blocks.
- ``no run fast path``: every sample of a quad tested for a new row, also
  where the quad's last row is the current run's.
- ``cotangents past L1``: the cotangent gathers with
  ``ld.global.nc.L1::no_allocate`` instead of ``__ldg``.
- ``in-order cotangents``: a sample reads the cotangent at its own place in
  the sorted order instead of the permutation's, which shows what the
  random gather costs (the result is wrong).

K6 (``csrc/table_grad_pos.cu``; 2^19 samples x 8 fetches over 2 x 2^16
rows):

- ``kernel``, ``staging only``, ``seven blocks an SM``, ``in-order
  cotangents``: as for K2.
- ``three position arrays``: a pair gathers x, y and z from the three
  input arrays, not one packed 16 B record.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

K2_WALK = "  // ---- 2. the walk: warp w sums samples [sb, se) of the tile --------------\n"
K2_STAGE_ONLY = K2_WALK + (
    "  if ((tid & 31) == 0 && (tid >> 5) * kWarpSamples < count) {\n"
    "    const int q0 = (tid >> 5) * kWarpSamples / 4;\n"
    "    out[blockIdx.x * 4 + (tid >> 5)] = __uint_as_float(st.w[q0][0].x) +\n"
    "        static_cast<float>(st.key[q0].x) + __uint_as_float(st.d[q0][0].x);\n"
    "  }\n"
    "  return;\n"
)
K6_WALK = "  // ---- 2. the walk: warp w sums pairs [sb, se) of the tile ----------------\n"
K6_STAGE_ONLY = K6_WALK + (
    "  if ((tid & 31) == 0 && (tid >> 5) * kWarpPairs < count) {\n"
    "    out[blockIdx.x * 8 + (tid >> 5)] = __uint_as_float(st.w[(tid >> 5) * 16][0].x) +\n"
    "        static_cast<float>(st.dst[(tid >> 5) * kWarpPairs]) + __uint_as_float(st.d[(tid >> 5) * 16][0].x);\n"
    "  }\n"
    "  return;\n"
)
K2_BLOCKS = "constexpr int kBlocksPerSm = 8;"
K2_GATHER = "      da[r] = __ldg(dout + 2 * p[r]);\n      db[r] = __ldg(dout + 2 * p[r] + 1);\n"
K2_HELPERS = "// The 8 bf16 corner weights of the u10 word q.\n"
K2_LOAD_PAST_L1 = (
    "__device__ __forceinline__ uint4 ld_past_l1(const uint4* p) {\n"
    "  uint4 v;\n"
    "  asm(\"ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\"\n"
    "      : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w) : \"l\"(p));\n"
    "  return v;\n"
    "}\n\n" + K2_HELPERS
)
# kernel -> (source name, ((variant name, keeps the function, substitutions), ...))
VARIANTS = {
    "k2": ("table_grad_u10", (
        ("kernel", True, ()),
        ("staging only", False, ((K2_WALK, K2_STAGE_ONLY),)),
        ("tiles of 512", True, (
            ("constexpr int kTile = 256;", "constexpr int kTile = 512;"),
            ("if (tile != kTile ||", "if (tile != 256 ||"),
            (K2_BLOCKS, "constexpr int kBlocksPerSm = 4;"),
        )),
        ("four blocks an SM", True, ((K2_BLOCKS, "constexpr int kBlocksPerSm = 4;"),)),
        ("twelve blocks an SM", True, ((K2_BLOCKS, "constexpr int kBlocksPerSm = 12;"),)),
        ("no run fast path", True, (("    if (k4.w == cur && 4 * qd + 4 <= se) {", "    if (false) {"),)),
        ("cotangents past L1", True, (
            (K2_HELPERS, K2_LOAD_PAST_L1), (K2_GATHER, K2_GATHER.replace("__ldg", "ld_past_l1")),
        )),
        ("in-order cotangents", False, ((K2_GATHER, (
            "      da[r] = __ldg(dout + 2 * (begin + i0 + r));\n"
            "      db[r] = __ldg(dout + 2 * (begin + i0 + r) + 1);\n")),)),
    )),
    "k6": ("table_grad_pos", (
        ("kernel", True, ()),
        ("staging only", False, ((K6_WALK, K6_STAGE_ONLY),)),
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
    )),
}


def build(kernel: str, out_dir: Path) -> dict:
    """Each variant's source, compiled by nvcc in parallel into a library."""
    from nerfacc_tpu_torch.ops import _build

    source, variants = VARIANTS[kernel]
    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, _, subs) in enumerate(variants):
        text = src
        for old, new in subs:
            if old not in text:
                cs.fail(f"{kernel} variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu, so = out_dir / f"{kernel}_v{i}.cu", out_dir / f"{kernel}_v{i}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"{kernel} variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.nerfacc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nerfacc_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def k2_run(dev):
    """K2 on phase 5's inputs: a function that launches a library's kernel,
    the launch function's name and argument types, the plain version's
    result and the row count."""
    from nerfacc_tpu_torch.ops import table_grad as tg

    u = cs.shell_points(np.random.default_rng(1), cs.TRAIN_CAPACITY, dev)
    _, sorted_idx, perm, w, dout, n_rows = cs.fused_inputs(u, np.random.default_rng(2), dev)
    wq, dout = tg.quantize_u10(*w), dout.to(torch.bfloat16)

    def run(lib):
        return tg._launch(lib, "table_grad_u10_launch", (sorted_idx, perm, wq, dout), n_rows,
                          tg._INV_1023, span=tg.K2_TILE)

    argtypes = tg._table_grad_u10_lib().table_grad_u10_launch.argtypes
    want = tg.table_grad_u10_plain(sorted_idx, perm, wq, dout, n_rows)
    return run, "table_grad_u10_launch", argtypes, want, n_rows


def k6_run(dev):
    """The same for K6."""
    from nerfacc_tpu_torch.ops import table_grad as tg

    args, _, _ = cs.k6_inputs(cs.shell_points(np.random.default_rng(1), cs.TRAIN_CAPACITY, dev),
                              np.random.default_rng(2), dev)
    sorted_key, perm, xs, ys, zs, dout, n_rows, fetches, F, consts = args
    n, nf, jg = xs.shape[0], len(fetches), len(fetches[0].res)
    res = (ctypes.c_float * (nf * jg))(*[float(r) for f in fetches for r in f.res])
    j_lo = (ctypes.c_int * nf)(*[f.j_lo for f in fetches])
    key = (ctypes.c_int * nf)(*[f.key for f in fetches])

    def run(lib):
        pos = torch.empty((n, 4), dtype=torch.float32, device=dev)
        return tg._launch(lib, "table_grad_pos_launch", (sorted_key, perm, xs, ys, zs, pos, dout), n_rows,
                          n, nf, jg, F, tg.ROW_WIDTH // (8 * F), res, j_lo, key, span=tg.K6_TILE)

    argtypes = tg._table_grad_pos_lib().table_grad_pos_launch.argtypes
    return run, "table_grad_pos_launch", argtypes, tg.table_grad_pos_plain(*args), n_rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*", choices=sorted(VARIANTS), help="default: all")
    kernels = ap.parse_args(argv).kernels or sorted(VARIANTS)
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    for kernel in kernels:
        run, fn_name, argtypes, want, n_rows = {"k2": k2_run, "k6": k6_run}[kernel](dev)
        libs = build(kernel, Path("build/kernel_variants"))
        for (name, keeps, _), lib in zip(VARIANTS[kernel][1], libs.values()):
            getattr(lib, fn_name).argtypes = argtypes
            getattr(lib, fn_name).restype = ctypes.c_int
            if keeps:
                err = float((run(lib) - want).abs().max())
                if not err <= 1e-5 * float(want.abs().max()):
                    cs.fail(f"{kernel} variant {name!r} disagrees with the plain version: {err}")
        del want
        times = {name: [] for name in libs}
        for _ in range(3):
            for name, lib in libs.items():
                times[name].append(cs.time_ms(lambda: run(lib)))
        for name, ms in times.items():
            print(f"{kernel} variant {name}: {float(np.median(ms)):.4f} ms "
                  f"(rounds {', '.join(f'{t:.4f}' for t in ms)})", flush=True)
        print(f"{kernel}: torch.zeros of the output alone: "
              f"{cs.time_ms(lambda: torch.zeros((n_rows, 128), device=dev)):.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
