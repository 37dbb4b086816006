"""Whether nvcc's --split-compile=0 (kernels.SOURCE_FLAGS) changes the
code of the port's kernels, on a machine with nvcc. From the root of the
repository:

    python3 -m sd3_torch.utils.flag_diag [source.cu ...]

builds each source under sd3_torch/csrc/ (all of them by default) twice,
with kernels.NVCC_FLAGS and with the flag added to them, all builds
started together, and compares the SASS of every kernel of the two
libraries (cuobjdump -sass, instructions and their encodings). One JSON
line per source: the seconds of each build (all of them sharing the
machine's cores), its number of kernels, how many have the same SASS both
ways, and the names of those that do not.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time


def _sass(cuobjdump: str, lib: str) -> dict[str, str]:
    """{kernel: its SASS} of a library."""
    txt = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    return {fn.split("\n", 1)[0].strip(): fn.split("\n", 1)[1]
            for fn in txt.split("Function : ")[1:]}


def main(argv=None) -> int:
    from sd3_torch import kernels

    flag = "--split-compile=0"
    sources = (sys.argv[1:] if argv is None else argv) or sorted(
        p.name for p in kernels.CSRC_DIR.glob("*.cu"))
    nvcc = kernels.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = {"without": kernels.NVCC_FLAGS,
             "with": kernels.NVCC_FLAGS + (flag,)}
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as logs:
        procs, seconds, t0 = {}, {}, time.time()
        try:
            for s in sources:
                for way, fl in flags.items():
                    lib = os.path.join(tmp, f"{way}-{s}.so")
                    log = logs.enter_context(
                        open(os.path.join(tmp, f"{way}-{s}.log"), "w"))
                    cmd = [nvcc, *fl, "-o", lib, str(kernels.CSRC_DIR / s)]
                    procs[s, way] = (lib, log, subprocess.Popen(
                        cmd, stdout=log, stderr=subprocess.STDOUT,
                        start_new_session=True))
            while len(seconds) < len(procs):
                for key, (_, log, proc) in procs.items():
                    if key in seconds or proc.poll() is None:
                        continue
                    seconds[key] = time.time() - t0
                    if proc.returncode != 0:
                        log.flush()
                        with open(log.name) as f:
                            raise RuntimeError(f"nvcc failed on {key}:\n"
                                               + f.read())
                time.sleep(0.1)
        finally:  # on a failed build, stop the others and their children
            for _, _, proc in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        for s in sources:
            a, b = (_sass(cuobjdump, procs[s, w][0]) for w in flags)
            names = a.keys() | b.keys()
            differ = sorted(k for k in names if a.get(k) != b.get(k))
            print(json.dumps(dict(
                source=s, flag=flag,
                build_s={w: round(seconds[s, w], 1) for w in flags},
                kernels=len(names), same_sass=len(names) - len(differ),
                differ=differ)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
