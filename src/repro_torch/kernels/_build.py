"""Build and load the port's CUDA kernels.

The ``csrc/*.cu`` sources are compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds).  Each source compiles in its
own ``nvcc`` process, all started together, then one link.  The build runs
at first use, writes under ``build/kernels/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``), and is keyed by a hash of the sources and
flags, so an unchanged tree reuses its library.

``-Xptxas -v`` is always on; :data:`BUILD_LOG` keeps ptxas' register,
shared-memory and spill lines of the last build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS]

# element-type codes of csrc/common.cuh
DT_F32, DT_BF16, DT_I8 = 0, 1, 2

BUILD_LOG: str = ""
_LIB = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C entry points and their argument types; every one returns a cudaError_t
SIGNATURES = {
    "flash_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I64, _I64, _I64, _I64, _F, _I, _I, _P, _I, _I,
                            _P, _P, _I, _P],
    "fused_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I,
                            _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                            _I64, _I64, _I64, _I64, _F, _I, _I, _P, _I, _I,
                            _P, _P, _I, _P],
    "adapter_quant_launch": [_P, _I, _P, _P, _I64, _I, _I, _I, _F, _P],
    "adapter_dequant_group_launch": [_P, _I, _I, _P],
    "sgmv_shrink_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "sgmv_expand_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "sigma_bmm_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _P],
    "jd_shrink_scale_launch": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I,
                               _I, _P],
    "kv_quant_launch": [_P, _I, _P, _P, _I, _I, _I, _P],
    "kv_dequant_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(env) if env else REPO_ROOT / "build" / "kernels"


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernels (unless a library for these sources exists) and
    return the library's path."""
    global BUILD_LOG
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.exists() and not force:
        return lib_path
    nvcc = nvcc_path()
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in cus:
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def lib():
    """The loaded kernel library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def refuse_meta(name: str, *tensors) -> None:
    """Raise ``ValueError`` naming the wrapper ``name`` where one of
    ``tensors`` is on ``meta``: a dry run reaches ``flash_decode``'s meta
    branch only, and no meta pointer reaches a launch."""
    if any(t is not None and t.device.type == "meta" for t in tensors):
        raise ValueError(f"{name}: a meta tensor; the dry run has no "
                         f"counterpart of this kernel")


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    import torch
    codes = {torch.float32: DT_F32, torch.bfloat16: DT_BF16,
             torch.int8: DT_I8}
    if dtype not in codes:
        raise TypeError(f"kernels take f32, bf16 or int8, not {dtype}")
    return codes[dtype]
