"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` source is compiled with ``nvcc`` for ``sm_90a``
into a shared library of its own, ``<name>``, with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a source builds in
seconds).  A library is built at first use, so a path builds only the
sources whose kernels it launches (a prefill only ``jd_delta.cu``, not
the minutes that ``decode_attention.cu`` takes); :func:`build` builds
several at once, one ``nvcc`` process a source, all started together.
Libraries are written under ``build/kernels/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``), each keyed by a hash of its source, the
headers and the flags, so an unchanged source reuses its library.

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
from typing import Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS]

# element-type codes of csrc/common.cuh
DT_F32, DT_BF16, DT_I8 = 0, 1, 2

BUILD_LOG: str = ""
_LIBS = {}
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C entry points by library (csrc/<library>.cu) and their argument types;
# every one returns a cudaError_t
SIGNATURES = {
    "decode_attention": {
        "flash_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I64, _I64, _I64, _I64, _F, _I, _I, _P,
                                _I, _I, _P, _P, _I, _P],
        "fused_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P,
                                _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                                _I, _I, _I64, _I64, _I64, _I64, _F, _I, _I,
                                _P, _I, _I, _P, _P, _I, _P]},
    "adapter_quant": {
        "adapter_quant_launch": [_P, _I, _P, _P, _I64, _I, _I, _I, _F, _P],
        "adapter_dequant_group_launch": [_P, _I, _I, _P]},
    "sgmv": {
        "sgmv_shrink_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P],
        "sgmv_expand_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P],
        "sigma_bmm_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _P]},
    "jd_apply": {
        "jd_shrink_scale_launch": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _I,
                                   _I, _I, _P]},
    "kv_quant": {
        "kv_quant_launch": [_P, _I, _P, _P, _I, _I, _I, _P],
        "kv_dequant_launch": [_P, _P, _P, _I, _I, _I, _I, _P]},
    "jd_delta": {
        "jd_delta_launch": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _F,
                            _P]},
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


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False, names: Optional[Sequence[str]] = None
          ) -> Dict[str, pathlib.Path]:
    """Compile the libraries ``names`` (every one by default) that have no
    library for their sources yet, all at once, and return each one's
    path."""
    global BUILD_LOG
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: out_dir / f"librepro_torch_{n}_{_digest(n)}.so"
             for n in (names or SIGNATURES)}
    todo = [n for n, p in paths.items() if force or not p.exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = {}
        for n in todo:
            obj = pathlib.Path(tmp) / f"{n}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / f"{n}.cu"), "-o",
                   str(obj)]
            procs[n] = (obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = [], []
        for n, (_, p) in procs.items():
            out, _ = p.communicate()
            logs.append(f"== {n}.cu\n{out}")
            if p.returncode != 0:
                failed.append(f"{n}.cu")
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        for n, (obj, _) in procs.items():
            tmp_lib = pathlib.Path(tmp) / paths[n].name
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link of {n} failed:\n"
                                   f"{link.stdout}")
            os.replace(tmp_lib, paths[n])
    return paths


def lib(name: str):
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    handle = _LIBS.get(name)
    if handle is not None:
        return handle
    with _LOCK:
        if name not in _LIBS:
            handle = ctypes.CDLL(str(build(names=[name])[name]))
            for entry, argtypes in SIGNATURES[name].items():
                fn = getattr(handle, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = handle
    return _LIBS[name]


def refuse(name: str, *args, meta: bool = True) -> None:
    """Raise naming the wrapper ``name`` where one of ``args`` is a
    DTensor (``TypeError``: a kernel takes a rank's own block, which the
    sharded step passes from its per-rank islands,
    ``distributed/sharding.py``; no wrapper assembles a whole tensor) or,
    with ``meta``, a tensor on ``meta`` (``ValueError``: a dry run reaches
    ``flash_decode``'s meta branch only, and no meta pointer reaches a
    launch)."""
    for a in args:
        if isinstance(a, DTensor):
            raise TypeError(f"{name}: a DTensor; pass this rank's block "
                            f"(to_local() inside a per-rank island)")
    if meta and any(isinstance(a, torch.Tensor) and a.device.type == "meta"
                    for a in args):
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
