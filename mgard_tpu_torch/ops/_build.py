"""Build and load the port's CUDA kernels.

All kernel sources (``mgard_tpu_torch/csrc/*.cu``) have a plain
``extern "C"`` interface, so ``nvcc`` compiles them, one process per
source, all started at once, and links them into one shared library,
loaded with :mod:`ctypes`.  No PyTorch headers, no
``torch.utils.cpp_extension``, no ``ninja``: the build takes seconds.
The host codecs of ``native/`` (Huffman, LZ4) are built the same way,
one ``g++`` call each (:func:`host_library`).

The library goes into ``mgard_tpu_torch/_build/`` (git-ignored) at first
use and is rebuilt whenever a source is newer than it.  A failed build
raises.  Each kernel module registers its wrappers here with
:func:`counted`, so that one place resets and reads every launch count.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libmgard_tpu_torch.so"
NATIVE = _PKG.parent / "native"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lib = None
_lock = threading.Lock()
build_seconds = None   # wall time of this process's build, None if reused
_wrappers = []         # every kernel wrapper, in the order registered

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of every launcher; each returns cudaError_t (an int)
_SIGNATURES = {
    "mgard_extract_coarse_3d": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "mgard_bp_quant_max_segments": (_P, _P, _P, _I, _I, _F, _P, _P, _P),
    "mgard_bp_quant_condense": (_P, _LL, _I, _I, _F, _P, _P, _P, _P),
    "mgard_bp_decode_condense_f32": (_P, _I, _I, _P, _P, _F, _P, _LL, _P),
    "mgard_bp_encode_condense": (_P, _I, _I, _P, _P, _P, _P),
    "mgard_bp_decode_condense": (_P, _I, _I, _P, _P, _P, _LL, _P),
    "mgard_gpk_detail": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "mgard_gpk_prolong_add": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _P),
    "mgard_b20": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "mgard_b1sub": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "mgard_dec_b20": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mgard_dec_b1add": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mgard_rm_dim0": (_P, _P, _P, _I, _I, _LL, _P),
    "mgard_bp_quant_zigzag": (_P, _LL, _I, _I, _F, _P, _P, _P, _P),
    "mgard_bp_condense_into": (_P, _I, _I, _P, _P, _P, _P),
    "mgard_bp_encode_core": (_P, _I, _P, _P, _P, _P),
    "mgard_bp_decode_core": (_P, _P, _I, _P, _P),
    "mgard_mass_solve": (_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL,
                         _LL, _LL, _LL, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of mgard_tpu_torch "
                       "are built on the machine that runs them")


def sources():
    return sorted(CSRC.glob("*.cu"))


def compile_command(src: Path, obj: Path):
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
            "-fPIC", "-c", "-o", str(obj), str(src)]


def link_command(out: Path, objs):
    return [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(out),
            *(str(o) for o in objs)]


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built
               for s in (*sources(), *CSRC.glob("*.cuh")))


def _run_all(commands) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in commands]
    failed = []
    for cmd, proc in zip(commands, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}\n"
                          f"{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile every source at once (one ``nvcc -c`` each), then link them
    into a temporary name that is renamed, so that a concurrent reader
    never sees half a library."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    tmp = BUILD_DIR / f".libmgard_tpu_torch.{pid}.so"
    objs = [BUILD_DIR / f".{s.stem}.{pid}.o" for s in sources()]
    t0 = time.perf_counter()
    try:
        _run_all([compile_command(s, o) for s, o in zip(sources(), objs)])
        _run_all([link_command(tmp, objs)])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, LIB_PATH)
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def host_library(name: str) -> Path:
    """``native/<name>.cpp`` built with one ``g++ -O3 -shared`` call into
    ``_build/lib<name>.so`` when that is missing or older than the
    source; a failed build raises.  ``native/*.so`` is neither read nor
    written."""
    src = NATIVE / f"{name}.cpp"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o",
           str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            handle = ctypes.CDLL(str(LIB_PATH))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def device_of(name: str, *tensors):
    """The one CUDA device that ``tensors`` lie on; raise if they lie on
    several, or off CUDA."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        found = ", ".join(sorted(map(str, devices)))
        raise ValueError(f"{name}: the tensors must lie on one CUDA device; "
                         f"they lie on {found}")
    return devices.pop()


def launch(name: str, *args, device) -> None:
    """Call one launcher under ``device`` (the device of the tensors it
    reads and writes), on that device's current stream, and raise on any
    launch error (a refused launch never runs, and a later synchronize
    would not report it)."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def counted(fn):
    """Register a kernel wrapper.  It adds one to ``fn.launches`` where it
    launches its kernel, and nowhere else."""
    fn.launches = 0
    _wrappers.append(fn)
    return fn


def reset_launches() -> None:
    """Set the launch count of every registered wrapper to 0."""
    for fn in _wrappers:
        fn.launches = 0


def launch_counts() -> dict:
    """The launch count of every registered wrapper, by its name."""
    return {fn.__name__: fn.launches for fn in _wrappers}
