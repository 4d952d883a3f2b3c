"""Builds the port's CUDA kernels and binds them with ctypes.

At first use, `nvcc` compiles each `construction_clip_tpu_torch/csrc/*.cu` for
Hopper (sm_90a) into its own shared library with a plain C interface, under
`build/torch_kernels/` at the root of the checkout; the compilers run in
parallel, one process per source. A library's file name carries a hash of its
source, the shared headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing prebuilt is committed.

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
import types
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC_DIR.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry -> (argtypes, restype); every entry returning int returns a cudaError_t
SIGNATURES = {
    # dtype, x, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, qkv, merged, out,
    # b, t, d, h, causal, eps, scale, stream (SIMT and tensor-core routes)
    "cct_attention_block_fwd": ([_I] + [_P] * 10 + [_I] * 5 + [_F, _F, _P], _I),
    "cct_attention_block_fwd_tc": ([_I] + [_P] * 10 + [_I] * 5 + [_F, _F, _P], _I),
    # dtype, x, g, ln_s, ln_b, w_qkv, b_qkv, w_out, work_t, work_f, dx, dqkv, merged,
    # dln_s, dln_b, b, t, d, h, causal, eps, scale, stream
    # (SIMT and tensor-core routes)
    "cct_attention_block_bwd": ([_I] + [_P] * 14 + [_I] * 5 + [_F, _F, _P], _I),
    "cct_attention_block_bwd_tc": ([_I] + [_P] * 14 + [_I] * 5 + [_F, _F, _P], _I),
    "cct_attention_block_bwd_work_floats": ([_I] * 4, _L),
    # dtype, x, ln_s, ln_b, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, q8, rs, qkv,
    # merged, out, b, t, d, h, causal, eps, scale, stream (SIMT and tensor-core
    # attention routes)
    "cct_attention_block_int8": ([_I] + [_P] * 14 + [_I] * 5 + [_F, _F, _P], _I),
    "cct_attention_block_int8_tc": ([_I] + [_P] * 14 + [_I] * 5 + [_F, _F, _P], _I),
    # dtype, q, ck, cv, ancestry, out, rows, heads, t_max, dh, layer, cache_len, chunks,
    # scale, stream
    "cct_decode_attention": ([_I] + [_P] * 5 + [_I] * 7 + [_F, _P], _I),
    # dtype, q, k, v, o, b, h, t, dh, causal, scale, stream (SIMT and tensor-core routes)
    "cct_flash_attention_fwd": ([_I] + [_P] * 4 + [_I] * 5 + [_F, _P], _I),
    "cct_flash_attention_fwd_tc": ([_I] + [_P] * 4 + [_I] * 5 + [_F, _P], _I),
    # dtype, q, k, v, g, work, dq, dk, dv, b, h, t, dh, causal, scale, stream
    "cct_flash_attention_bwd": ([_I] + [_P] * 8 + [_I] * 5 + [_F, _P], _I),
    "cct_flash_attention_bwd_tc": ([_I] + [_P] * 8 + [_I] * 5 + [_F, _P], _I),
    # table_dtype, x, table, scale, out, rows, d, v, stream
    "cct_vocab_head": ([_I] + [_P] * 4 + [_I] * 3 + [_P], _I),
    # dtype, x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, hidden, out, rows, d, h, eps,
    # stream (SIMT and tensor-core routes)
    "cct_mlp_residual": ([_I] + [_P] * 9 + [_I] * 3 + [_F, _P], _I),
    "cct_mlp_residual_tc": ([_I] + [_P] * 9 + [_I] * 3 + [_F, _P], _I),
    # out_dtype, in, out, n, scale, mean[3], inv_std[3], stream
    "cct_normalize_u8": ([_I, _P, _P, _L] + [_F] * 7 + [_P], _I),
    # id_type, ids, keys, n, v, stream
    "cct_embedding_keys": ([_I, _P, _P, _L, _I, _P], _I),
    # dtype, sorted keys, rows, grad, dw, work, n, d, v, stream
    "cct_embedding_bwd": ([_I] + [_P] * 5 + [_L, _I, _I, _P], _I),
    "cct_embedding_bwd_work_bytes": ([_L, _I, _I], _L),
    # K10's staging buffers: bytes, &ptr / ptr / ptr, handle[64] / handle[64], &ptr /
    # ptr
    "cct_peer_alloc": ([_L, ctypes.POINTER(_P)], _I),
    "cct_peer_free": ([_P], _I),
    "cct_peer_handle": ([_P, _P], _I),
    "cct_peer_open": ([_P, ctypes.POINTER(_P)], _I),
    "cct_peer_close": ([_P], _I),
    # bases, slot_offset, pad_offset, x, chunk_bytes, ranks, me, generation, stream
    "cct_all_gather_put": ([_P, _L, _L, _P, _L, _I, _I, ctypes.c_ulonglong, _P], _I),
    # bases, host_bases, slot_offset, pad_offset, x, out, chunk_bytes, ranks, me,
    # generation, stream
    "cct_all_gather_gather": ([_P, _P, _L, _L, _P, _P, _L, _I, _I, ctypes.c_ulonglong, _P], _I),
    # pad, ranks, me, stream
    "cct_all_gather_poison": ([_P, _I, _I, _P], _I),
    # &eager
    "cct_all_gather_load": ([ctypes.POINTER(_I)], _I),
    "cct_error_string": ([_I], ctypes.c_char_p),
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


def source_hash(source: Path | None = None) -> str:
    """Hash of the flags, the shared headers and `source` (every source when
    None)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = sorted(CSRC_DIR.glob("*.cuh")) + ([source] if source else sources())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_command(nvcc: str, out: Path, source: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source)]


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"libcct_{source.stem}_{source_hash(source)}.so"


def build_all() -> list[Path]:
    """Builds every source without a library for its hash, all compilers
    started together; returns the libraries."""
    libs = [library_path(src) for src in sources()]
    missing = [(src, so) for src, so in zip(sources(), libs) if not so.exists()]
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = []
        for src, so in missing:
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs.append((src, so, tmp, subprocess.Popen(
                nvcc_command(nvcc, tmp, src), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        failures = []
        for src, so, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name} ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, so)
        if failures:
            raise RuntimeError("nvcc failed: " + "\n".join(failures))
    return libs


def load_library() -> types.SimpleNamespace:
    """The kernels' C entries (built first where a source hash has no build
    yet), as attributes of one namespace."""
    global _lib
    with _lock:
        if _lib is None:
            entries = {}
            for so in build_all():
                lib = ctypes.CDLL(str(so))
                for name, (argtypes, restype) in SIGNATURES.items():
                    if name not in entries and hasattr(lib, name):
                        fn = getattr(lib, name)
                        fn.argtypes, fn.restype = argtypes, restype
                        entries[name] = fn
            missing = sorted(set(SIGNATURES) - set(entries))
            if missing:
                raise RuntimeError(f"kernel libraries lack the C entries {missing}")
            _lib = types.SimpleNamespace(**entries)
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().cct_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def on_cpu(x, what: str) -> bool:
    """True for a CPU tensor (the wrapper runs its plain version), False for a
    CUDA one (it launches its kernel); any other device is an error."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return x.device.type == "cpu"


def dtype_code(dtype) -> int:
    """The C entries' dtype argument (csrc/common.cuh: DType)."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]
