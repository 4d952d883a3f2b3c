"""Builds the port's CUDA kernels and binds them with ctypes.

At first use, `nvcc` compiles every `construction_clip_tpu_torch/csrc/*.cu` for
Hopper (sm_90a) into one shared library with a plain C interface, under
`build/torch_kernels/` at the root of the checkout. The file name carries a hash
of the sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing prebuilt is committed.

Each C entry returns a `cudaError_t`; `check` raises on a nonzero one (a launch
the CUDA runtime refused never runs, and a later synchronise would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC_DIR.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # dtype, x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, qkv, merged, out,
    # b, t, d, h, causal, eps, scale, stream
    "cct_attention_block_fwd": [_I] + [_P] * 10 + [_I] * 5 + [_F, _F, _P],
    # dtype, q, ck, cv, ancestry, out, rows, heads, t_max, dh, layer, cache_len,
    # scale, stream
    "cct_decode_attention": [_I] + [_P] * 5 + [_I] * 6 + [_F, _P],
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the port's CUDA kernels are built at first use")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def library_path() -> Path:
    return BUILD_DIR / f"libcct_kernels_{source_hash()}.so"


def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if this source hash has no build yet."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                proc = subprocess.run(nvcc_command(find_nvcc(), tmp),
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cct_error_string.argtypes = [ctypes.c_int]
            lib.cct_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().cct_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(dtype) -> int:
    """The C entries' dtype argument (csrc/common.cuh: DType)."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]
