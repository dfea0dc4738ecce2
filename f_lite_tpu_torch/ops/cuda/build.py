"""Build the package's CUDA sources into plain-C shared libraries.

`csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` (Hopper) into
`csrc/build/lib<name>-<hash>.so`, where the hash covers the source, the
shared headers (`csrc/*.cuh`) and the flags, and is loaded with `ctypes`.
Nothing includes PyTorch's headers, so a build takes seconds. Builds happen
at first use, never at import; `build()` starts one nvcc per source, all at
once. nvcc's `-Xptxas -v` report is kept beside each library as
`lib<name>-<hash>.log`, ending in a line `nvcc seconds: <s>` (the wall
time of that source's nvcc process). `defines` ("NAME=VALUE" strings, passed as `-D`)
and `csrc` (another checkout's source directory) build a variant of a
source into its own library: the tile trials
(`f_lite_tpu_torch/tools/forward_tiles.py`, `backward_tiles.py`) build
their tile sizes and an earlier commit's kernels so; the package's own
libraries take neither.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_variants", "int8_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines=(), csrc: Path = CSRC) -> Path:
    src = (csrc / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES, defines=(), csrc: Path = CSRC) -> None:
    """Build every library of `names` that is not built yet: one nvcc
    process per source, started together; raises if any fails."""
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name, defines, csrc)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc_path(), *_flags(defines), "-o", str(tmp),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []

    def finish(proc):  # the report and the wall time at its end
        return proc.communicate()[0], time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(max(1, len(procs))) as pool:
        reports = dict(zip(procs, pool.map(finish, (p[2] for p in procs.values()))))
    for name, (out, tmp, proc) in procs.items():
        report, seconds = reports[name]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu:\n{report}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(f"{report}nvcc seconds: {seconds:.1f}\n")
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, defines=(), csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library for `<csrc>/<name>.cu` (with `defines`), built
    first if needed."""
    key = (name, tuple(defines), Path(csrc).resolve())
    lib = _libs.get(key)
    if lib is not None:
        return lib
    build([name], defines, Path(csrc))
    lib = _libs[key] = ctypes.CDLL(str(library_path(name, defines, Path(csrc))))
    return lib
