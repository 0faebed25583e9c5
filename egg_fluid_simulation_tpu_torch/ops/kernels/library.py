"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects are
linked into ONE shared library with a plain C interface, which is loaded
with ``ctypes``. The build happens at first use, when a CUDA tensor first reaches
a kernel, into ``egg_fluid_simulation_tpu_torch/_build/`` (git-ignored); the
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. Nothing here is imported or
run for CPU tensors, so the package imports on machines without ``nvcc``.

There is no fallback: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from ...utils.profiling import span

__all__ = ["load", "build", "open_build", "use", "kernel_resources", "check",
           "stream_handle", "ptr", "load_seconds"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Route (b) of a hand-built Hopper library. --fmad=false keeps every multiply
# and add rounded on its own, as the plain PyTorch versions' separate
# elementwise ops are; --use_fast_math is deliberately absent (expf, rsqrtf
# and '/' stay the accurate ones). -Xptxas -v makes the build log carry each
# kernel's registers and spills (kernel_resources()).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

_C_INT = ctypes.c_int
_C_PTR = ctypes.c_void_p
_SIGNATURES = {
    "egg_place_planes": [_C_PTR] * 5 + [_C_INT] * 6 + [_C_PTR],
    "egg_substep_pass": [_C_PTR] * 9 + [_C_INT] * 7 + [_C_PTR],
    "egg_splat": [_C_PTR] * 4 + [_C_INT] * 12 + [_C_PTR],
    "egg_sweep_planes": [_C_PTR] * 4 + [_C_INT] * 7 + [_C_PTR],
    "egg_sweep_planes_sym": [_C_PTR] * 4 + [_C_INT] * 7 + [_C_PTR],
    "egg_count_planes": [_C_PTR] * 2 + [_C_INT] * 3 + [_C_PTR],
    "egg_splat_tiles": [_C_PTR] * 3 + [_C_INT] * 6 + [_C_PTR],
    "egg_gather_front": [_C_PTR] * 8 + [_C_INT] * 2 + [_C_PTR],
    "egg_gather_count": [_C_PTR] * 3 + [_C_INT] * 3 + [_C_PTR] * 2,
    "egg_gather_sweep": [_C_PTR] * 10 + [_C_INT] * 5 + [_C_PTR] * 2,
    "egg_empty": [_C_PTR],
    "egg_if_node": [_C_PTR] * 3,
    "egg_composite": [_C_PTR] * 3 + [_C_INT] * 5 + [_C_PTR],
    "egg_upsample": [_C_PTR] * 2 + [_C_INT] * 3 + [_C_PTR],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
load_seconds = 0.0            # host seconds of load()'s builds and opens
last_build_log: dict = {}     # source name -> nvcc / ptxas output of its build


def _sources(csrc: Path):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "egg_fluid_simulation_tpu_torch cannot be built")
    return found


def build(csrc: Optional[Path] = None, extra_flags=()) -> Path:
    """Compile the library if this exact source set is not built yet.

    ``csrc`` (default: the package's ``csrc/``) and ``extra_flags`` (added to
    ``NVCC_FLAGS``) let a measurement script build another source tree or a
    ``-D`` variant beside the package's own library."""
    csrc = CSRC if csrc is None else Path(csrc)
    flags = [*NVCC_FLAGS, *extra_flags]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libegg_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in _sources(csrc):
            if src.suffix != ".cu":
                continue
            obj = os.path.join(work, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *flags, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, proc in procs:
            log_text, _ = proc.communicate()
            last_build_log[src.name] = log_text
            if proc.returncode != 0:
                errors.append(f"{src.name} (exit {proc.returncode}):\n"
                              f"{log_text}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed (exit %d):\n%s\n%s"
                               % (link.returncode, link.stdout, link.stderr))
        os.replace(tmp, out)
    return out


def kernel_resources() -> dict:
    """Per kernel of the last build, what ``ptxas -v`` reported:
    ``{kernel: {"registers": n, "spill_bytes": n, "static_smem_bytes": n}}``,
    a template instance under ``kernel<arguments>``
    (empty when the library was already built and nothing was compiled)."""
    out = {}
    # the mangled name: ...<len><name>_kernel, then for a template instance
    # its integer arguments as I(L<type><value>E)+E, then E
    entry = re.compile(
        r"Function properties for \w*?\d+([a-z_]+_kernel)"
        r"((?:I(?:L[a-z]\d+E)+E)?)E.*?"
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers(?:[^\n]*?(\d+) bytes smem)?", re.S)
    for text in last_build_log.values():
        for name, targs, st, ld, regs, smem in entry.findall(text):
            if targs:
                name += "<%s>" % ",".join(re.findall(r"L[a-z](\d+)E", targs))
            out[name] = dict(registers=int(regs),
                             spill_bytes=int(st) + int(ld),
                             static_smem_bytes=int(smem or 0))
    return out


def open_build(csrc: Optional[Path] = None, extra_flags=(),
               optional=()) -> ctypes.CDLL:
    """Build (see :func:`build`) and open a library, its entry points typed;
    an entry point named in ``optional`` may be missing (another commit's
    sources), any other missing one raises."""
    lib = ctypes.CDLL(str(build(csrc, extra_flags)))
    for name, argtypes in _SIGNATURES.items():
        if name in optional and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _C_INT
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Its build or load is
    the span ``egg.library.load`` and adds its host seconds to
    ``load_seconds``."""
    global _lib, load_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            with span("egg.library.load"):
                _lib = open_build()
            load_seconds += time.perf_counter() - t0
    return _lib


def use(lib: ctypes.CDLL) -> None:
    """Make ``lib`` (from :func:`open_build`) the library the wrappers call:
    how a measurement script times two builds in turns in one process."""
    global _lib
    with _lock:
        _lib = lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (launch refused etc.)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
