"""Build and load the port's CUDA kernels.

`csrc/*.cu` is compiled with nvcc for Hopper (`sm_90a`) into a shared
library with a plain C interface, loaded with ctypes. The build happens at
first use, into `_build/` beside this file (git-ignored), under a name that
carries a hash of the source and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "mas.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the MAS kernels are built "
        "from mb_istft_vits_torch/csrc with nvcc for sm_90a")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmas-{digest.hexdigest()[:12]}.so")


def build() -> List[str]:
    """Compile the kernels unless the current build exists. Returns the
    compiler's report (registers, shared memory, spills per kernel), kept
    beside the library so that a cached build returns it too."""
    out = library_path()
    report = out + ".ptxas.txt"
    if os.path.exists(out) and os.path.exists(report):
        with open(report, encoding="utf-8") as f:
            return f.read().splitlines()
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        with open(report, "w", encoding="utf-8") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return (proc.stdout + proc.stderr).splitlines()


def ptxas_spills(report: List[str]) -> Dict[str, Tuple[int, int]]:
    """{function: (spill store bytes, spill load bytes)} from the report of
    `nvcc -Xptxas -v` (function names as ptxas prints them, mangled)."""
    spills, name = {}, None
    for line in report:
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found and name is not None:
            spills[name] = (int(found.group(1)), int(found.group(2)))
            name = None
    return spills


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Raises when it cannot
    be built; callers never fall back to another implementation."""
    build()
    lib = ctypes.CDLL(library_path())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mas_fused", "mas_fwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
        fn.restype = i32
    lib.mas_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.mas_bwd.restype = i32
    for name in ("mas_max_shared_bytes", "mas_bwd_owns_sm"):
        fn = getattr(lib, name)
        fn.argtypes = [i32]
        fn.restype = i32
    lib.mas_fused_shared_bytes.argtypes = [i32, i32]
    lib.mas_fused_shared_bytes.restype = ctypes.c_longlong
    lib.mas_max_columns.argtypes = []
    lib.mas_max_columns.restype = i32
    lib.mas_error_string.argtypes = [i32]
    lib.mas_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if code != 0:
        msg = library().mas_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
