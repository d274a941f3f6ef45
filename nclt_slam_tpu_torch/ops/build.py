"""Build a hand-written CUDA source into a shared library with ``nvcc``.

Each kernel of the port is a ``csrc/*.cu`` file with a plain C entry point,
compiled on first use into ``build/kernels/`` (git-ignored) and loaded with
ctypes.  The library is named by a hash of the source and the flags, so an
edit rebuilds.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from source on first use")
    return found


def build_library(source: Path, flags=BASE_FLAGS) -> Path:
    """Compile ``source`` into ``build/kernels/lib<stem>_<hash>.so`` and
    return its path (an existing build of the same source is reused)."""
    src = source.read_bytes()
    tag = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc(), *flags, "-o", tmp, str(source)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed building {source}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
