"""Build the CUDA sources with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/ksim_tpu_torch/<name>-<hash>.so``
(a plain C interface, no PyTorch headers), where the hash covers the
sources, the shared headers and the flags: an edited source builds
anew, an unchanged one loads the library already built.  ``build()``
starts one nvcc per source, all at once.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ksim_tpu_torch.kernels.chain import ChainParams

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ksim_tpu_torch"
SOURCES = ("schedule_scan", "schedule_sampled", "batch_eval", "replay_segment", "chain_stages")
# --fmad=false: no a*b+c contracted into an FMA where the reference
# rounds twice (the chain's float paths must match it bit for bit).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per source: kernel D's file holds four large kernel instantiations, which
# nvcc compiles one after another (about 150-240 s on the H100 machines);
# --split-compile optimizes and assembles them on up to 4 threads (about
# 100 s there; the same registers, stack and shared memory per kernel).
EXTRA_FLAGS = {"replay_segment": ("--split-compile=4",)}

# The entry points' C signatures: (params, stream), and for the cluster
# launches (kernels A, C and D) also (cluster size, threads, stats, info);
# kernel D's takes its lanes' device params and their count before the
# stream.
_ENTRY_ARGS = (ctypes.c_void_p, ctypes.c_void_p)
_CLUSTER = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong))
_CLUSTER_ARGS = _ENTRY_ARGS + _CLUSTER
ARGTYPES = {
    "schedule_scan": _CLUSTER_ARGS,
    "schedule_sampled": _CLUSTER_ARGS,
    "replay_segment": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p) + _CLUSTER,
    # Kernel B: (params, summary params, stream, grid).
    "batch_eval": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong),
    # Kernel E: (stage, params, stage params, stream, grid, then the
    # stage's cluster size and info).
    "chain_stages": (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build time (0.0 when already built), "ptxas": [lines]}
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every source in ``names`` whose library is missing, one
    nvcc process each, all started together; raises with nvcc's output
    when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    procs = {}
    start = time.perf_counter()
    for name, out in targets.items():
        if out.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": []})
            continue
        tmp = out.with_suffix(".tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - start,
            "ptxas": [ln for ln in log.splitlines() if "ptxas" in ln],
        }
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            tmp.replace(targets[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def load_built(names=SOURCES) -> int:
    """Load, never build, each source in ``names`` whose hashed library
    already exists (a warm start from an earlier process's builds);
    returns how many are loaded now.  A library that will not load here
    (no CUDA runtime, a foreign or damaged file) is skipped, not removed:
    the launch that needs it builds or fails on its own."""
    n = 0
    for name in names:
        if name not in _LIBS and not _target(name).exists():
            continue
        try:
            load(name)
        except (OSError, RuntimeError):
            continue
        n += 1
    return n


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            entry = getattr(lib, f"ksim_{name}")
            entry.argtypes = list(ARGTYPES.get(name, _ENTRY_ARGS))
            entry.restype = ctypes.c_int
            lib.ksim_error_string.argtypes = [ctypes.c_int]
            lib.ksim_error_string.restype = ctypes.c_char_p
            lib.ksim_params_size.restype = ctypes.c_longlong
            if lib.ksim_params_size() != ctypes.sizeof(ChainParams):
                raise RuntimeError("ChainParams differs between csrc/plugin_chain.cuh and kernels/chain.py")
            _LIBS[name] = lib
        return lib
