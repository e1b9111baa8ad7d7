"""Build and load the port's CUDA kernels.

All kernel sources (``mgard_tpu_torch/csrc/*.cu``) have a plain
``extern "C"`` interface, so ``nvcc`` compiles them, one process per
source, all started at once, and links them into one shared library,
loaded with :mod:`ctypes`.  No PyTorch headers, no
``torch.utils.cpp_extension``, no ``ninja``: the build takes seconds.
The host codecs of ``native/`` (Huffman, LZ4) are built the same way,
one ``g++`` call each (:func:`host_library`).

The libraries go into ``BUILD_DIR``, which :func:`set_build_dir`
chooses (its argument, else ``MGARD_TPU_CACHE_DIR``, else
``mgard_tpu_torch/_build/``, git-ignored; the empty string gives a
temporary directory of the process) at the first build, never at
import; ``utils/cache.enable_persistent_cache`` is its public name.
Each library's file name carries a hash of its sources, its flags and
its compiler (:func:`library_path`, :func:`host_library_path`): a
library whose name is there is loaded, any other is built.  A failed
build raises.
Each kernel module registers its wrappers here with :func:`counted`, so
that one place resets and reads every launch count.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ..utils import debug

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
# the directory in use: set by set_build_dir, which the first build calls
# while it is None
BUILD_DIR = None
NATIVE = _PKG.parent / "native"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-shared",)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.RLock()
_private = None        # this process's build directory while the cache is off
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
                         _LL, _LL, _LL, _LL, _LL, _I, _P),
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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host codecs of mgard_tpu_torch "
                       "are built on the machine that runs them")


@functools.lru_cache(maxsize=None)
def _compiler_id(program: str) -> str:
    """A compiler's resolved path and what its ``--version`` prints (read
    once a process for each path), so that a library another toolkit
    built has another name."""
    real = os.path.realpath(program)
    try:
        proc = subprocess.run([real, "--version"], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"{program} --version failed: {exc}") from exc
    return f"{real}\0{proc.returncode}\0{proc.stdout}"


def sources():
    return sorted(CSRC.glob("*.cu"))


def compile_command(src: Path, obj: Path):
    return [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(obj),
            str(src)]


def link_command(out: Path, objs):
    return [_nvcc(), *ARCH_FLAGS, *LINK_FLAGS, "-o", str(out),
            *(str(o) for o in objs)]


def _private_dir() -> Path:
    """A temporary directory for this process alone, removed at exit
    (made once; later calls return it)."""
    global _private
    if _private is None:
        _private = Path(tempfile.mkdtemp(prefix="mgard_tpu_torch_build_"))
        atexit.register(shutil.rmtree, _private, ignore_errors=True)
    return _private


def set_build_dir(path: str | None = None) -> str | None:
    """Point the library builds at ``path`` (default:
    ``MGARD_TPU_CACHE_DIR``, else :data:`DEFAULT_BUILD_DIR`) and set
    ``BUILD_DIR`` to it.  Returns the directory used, or None when the
    cache is disabled (the empty string) or the directory cannot be made;
    builds then go to a temporary directory of this process.
    Idempotent."""
    global BUILD_DIR
    if path is None:
        path = os.environ.get("MGARD_TPU_CACHE_DIR", str(DEFAULT_BUILD_DIR))
    if path:
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            path = ""
    with _lock:
        if not path:
            BUILD_DIR = _private_dir()
            return None
        BUILD_DIR = Path(path)
        return path


def build_dir() -> Path:
    """``BUILD_DIR``, chosen by :func:`set_build_dir` from the setting at
    the first call while it is None."""
    if BUILD_DIR is None:
        with _lock:
            if BUILD_DIR is None:
                set_build_dir()
    return BUILD_DIR


def _digest(compiler, flags, files) -> str:
    """16 hex digits of a hash of the compiler (:func:`_compiler_id`), the
    flags and each file's name and bytes (not its time)."""
    h = hashlib.sha256(_compiler_id(compiler).encode())
    h.update(repr(tuple(flags)).encode())
    for f in files:
        data = f.read_bytes()
        h.update(f"\0{f.name}\0{len(data)}\0".encode())
        h.update(data)
    return h.hexdigest()[:16]


def library_path() -> Path:
    """The kernel library's path in ``BUILD_DIR``, named by a hash of the
    sources (``*.cu``, ``*.cuh``), the compiler that
    :func:`compile_command` runs, the nvcc flags and ``ARCH_FLAGS``."""
    compiler = compile_command(CSRC / "x.cu", CSRC / "x.o")[0]
    key = _digest(compiler, (*ARCH_FLAGS, *NVCC_FLAGS, *LINK_FLAGS),
                  [*sources(), *sorted(CSRC.glob("*.cuh"))])
    return build_dir() / f"libmgard_tpu_torch-{key}.so"


def host_library_path(name: str) -> Path:
    """``native/<name>.cpp``'s library path in ``BUILD_DIR``, named by a
    hash of the source, ``g++`` and its flags."""
    key = _digest(_gxx(), GXX_FLAGS, [NATIVE / f"{name}.cpp"])
    return build_dir() / f"lib{name}-{key}.so"


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
    into a temporary name that is renamed to :func:`library_path`, so
    that a concurrent reader never sees half a library."""
    global build_seconds
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    tmp = out.parent / f".libmgard_tpu_torch.{pid}.so"
    objs = [out.parent / f".{s.stem}.{pid}.o" for s in sources()]
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
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def host_library(name: str) -> Path:
    """``native/<name>.cpp`` built with one ``g++ -O3 -shared`` call into
    :func:`host_library_path` unless a library of that name is there; a
    failed build raises.  ``native/*.so`` is neither read nor written."""
    src = NATIVE / f"{name}.cpp"
    out = host_library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f".lib{name}.{os.getpid()}.so"
    cmd = [_gxx(), *GXX_FLAGS, str(src), "-o", str(tmp)]
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
            path = library_path()
            if not path.exists():
                build()
            handle = ctypes.CDLL(str(path))
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
    would not report it); in debug mode (``utils/debug.py``) also wait
    for the kernel and raise, naming it, if it failed."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    if debug.enabled():
        # debug mode: wait for the kernel and raise at its fault
        try:
            torch.cuda.synchronize(device)
        except RuntimeError as exc:
            raise RuntimeError(f"{name}: the kernel failed on {device}: "
                               f"{exc}") from exc


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
