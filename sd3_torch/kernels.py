"""Build and bind the port's hand-written CUDA kernels.

Every source `csrc/<name>.cu` exposes a plain C interface; the headers
`csrc/*.cuh` hold what sources share. Each source compiles with nvcc for
`sm_90a` into its own shared library, `_build/<name>-<hash>.so`, keyed by
the content of the source, the headers and the flags, and is loaded with
ctypes.
A build happens at first use of a kernel, or for all of them at once through
`build_all()`, which starts one nvcc per source and waits for all of them.
Importing this module builds, loads and starts nothing.

Each `Kernel` carries a plain-integer launch count. Its wrapper adds one
where it launches the kernel and nowhere else, so a run can show which
kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source beyond NVCC_FLAGS. --split-compile=0 optimizes the
# int8 attention source's kernels in parallel on every core: 44 s against
# 97 s on an 8-core H100 host, the longest build of the port. It changes
# the SASS of some kernels (utils/flag_diag.py), so no other source takes
# it.
SOURCE_FLAGS = {"attention_int8_sm90.cu": ("--split-compile=0",)}

REGISTRY: list["Kernel"] = []


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of sd3_torch build only where it is")


def _flags(source: str) -> tuple:
    """nvcc's flags for `source`."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


def _library_path(source: str) -> Path:
    """The library of `source`, keyed by its flags, the source and every
    header under csrc/ (which any source may include)."""
    h = hashlib.sha256(" ".join(_flags(source)).encode())
    for path in [CSRC_DIR / source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources) -> dict[str, str]:
    """Compile each source in `sources` that has no current library yet, one
    nvcc process per source, all started together. Returns {source: the
    compiler's report} for the sources compiled now (ptxas register and
    shared-memory use); raises RuntimeError naming every failed source."""
    todo = [s for s in dict.fromkeys(sources) if not _library_path(s).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for s in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_flags(s), "-o", tmp, str(CSRC_DIR / s)]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for s, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[s] = out
        if proc.returncode == 0:
            os.replace(tmp, _library_path(s))  # atomic: no half-written .so
        else:
            os.unlink(tmp)
            failed.append(f"{s} (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def build_all() -> dict[str, str]:
    """Build every registered kernel's source (see `build`)."""
    return build([k.source for k in REGISTRY])


class Kernel:
    """One C entry point of one CUDA source: built and bound at first call,
    with the count of launches its wrapper made."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source          # file name under csrc/
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None
        REGISTRY.append(self)

    def function(self):
        """The ctypes function; builds the library first if needed. It
        returns the CUDA error code of its launches (0 on success)."""
        if self._fn is None:
            build([self.source])
            self._lib = ctypes.CDLL(str(_library_path(self.source)))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


def check(kernel: Kernel, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error "
                           f"code {err}")
