"""g++ build of the port's host C++ (`csrc/audio.cpp`) into a shared
library for ctypes (the port's copy of `mb_istft_vits_tpu/utils/
native_build.py`).

Several processes on one checkout (loader tests beside a training run, a
child CLI) may race the build. Compiling straight to the target path could
leave a half-written library whose mtime passes the freshness check for
good, silently disabling the native path; so each builder compiles to a
temp name of its own pid and `os.replace`s it in: every builder produces a
whole library and the last rename wins.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def gxx_version() -> str:
    """`g++ --version`; raises OSError without a g++."""
    return subprocess.run(["g++", "--version"], capture_output=True,
                          text=True, check=True).stdout


def library_path(src: str, name: str) -> str:
    """`_build/lib{name}-{hash}.so`: the hash covers the source, the flags
    and the compiler's version text, so an edited source or another g++
    builds anew."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(GXX_FLAGS).encode()
                              + gxx_version().encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_shared_lib(src: str, so: str) -> str:
    """Compile `src` to `so` with `g++ -O3 -fopenmp -shared -fPIC` unless
    `so` exists and is newer than `src`; atomic under concurrent builders.
    Raises CalledProcessError (its stderr holds g++'s message) or OSError
    when the toolchain fails; the caller decides what to fall back to."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    try:
        subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so
