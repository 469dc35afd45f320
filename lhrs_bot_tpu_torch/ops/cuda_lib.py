"""Build and load the hand-written CUDA kernels of `lhrs_bot_tpu_torch/csrc`.

At first use every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a`, one
`nvcc` per source, all started together, and the objects are linked into
one shared library with a plain C interface, which is loaded with `ctypes`
(no PyTorch headers, so a build takes seconds, not minutes). The wgmma
kernels and the split decode kernels share `csrc/sm90.cuh`, which fetches
the TMA tensor-map encoder (cuTensorMapEncodeTiled) through the runtime,
so nothing links against libcuda; the split decode kernels (contiguous and
paged) share `csrc/decode_split.cuh`. The library goes to
`build/kernels/<hash of the sources, headers and flags>/` beside the
package, so an edited source or header is
rebuilt and an unchanged one is reused. Nothing here runs at import time:
the CPU tests import every module on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (each returns its cudaError_t as int)
_ENTRIES = {
    # q, k, v, kv_mask, seg, o, lse, B, H, Sq, Skv, D, causal, sm_scale,
    # strides (12 int64: batch/head/row of q, k, v, o), out_f32, normalize,
    # fault, stream
    "lhrs_flash_fwd": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P, _I, _I, _I,
                                             _P],
    # q, k, v, dout, lse, delta, kv_mask, seg, runs, dq, B, H, Sq, Skv, D,
    # causal, sm_scale, stream
    "lhrs_flash_bwd_dq": [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P],
    # the same with dk, dv in place of dq
    "lhrs_flash_bwd_dkv": [_P] * 11 + [_I] * 6 + [ctypes.c_float, _P],
    # q, k_new, v_new, k_cache, v_cache, lengths, out, layer, L, B, H, S, D,
    # sm_scale, splits, fault, stream
    "lhrs_fused_decode_bf16": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _I,
                                                     _P],
    # D, splits, count (int*)
    "lhrs_fused_decode_bf16_max_clusters": [_I, _I, _P],
    # q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache, k_scale,
    # v_scale, lengths, out, layer, L, B, H, S, D, sm_scale, splits, fault,
    # stream
    "lhrs_fused_decode_q": [_P] * 11 + [_I] * 6 + [ctypes.c_float, _I, _I,
                                                   _P],
    # D, splits, count (int*)
    "lhrs_fused_decode_q_max_clusters": [_I, _I, _P],
    # q .. sm_scale as lhrs_fused_decode_q, then block_s, splits, fault,
    # stream
    "lhrs_fused_decode_q_int8dots": [_P] * 11 + [_I] * 6 + [ctypes.c_float,
                                                            _I, _I, _I, _P],
    # D, block_s, splits, count (int*)
    "lhrs_fused_decode_q_int8dots_max_clusters": [_I, _I, _I, _P],
    # cache, new_vals, lengths, B, H, S, row bytes, stream
    "lhrs_cache_row_update": [_P] * 3 + [_I] * 4 + [_P],
    # blocks, stream: a kernel that does nothing (the launch floor)
    "lhrs_empty_kernel": [_I, _P],
    # x, y (or null), n16 (16-byte words of each), bf16, unroll, ctas,
    # partial (2 floats a CTA), out, stream
    "lhrs_hbm_read": [_P, _P, _L, _I, _I, _I, _P, _P, _P],
    # x, w, win, sums, g, M, N, K bytes, ndots, requant, trans, bf16,
    # stream
    "lhrs_int8_chain": [_P] * 4 + [_I] * 8 + [_P],
    # q, k_new, v_new, k_pages, v_pages, table, lengths, out, layer, L, N,
    # B, H, page, P, D, sm_scale, stream
    "lhrs_paged_decode_bf16": [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P],
    # q, k_new, k_new_scale, v_new, v_new_scale, k_pages, v_pages, k_scale,
    # v_scale, table, lengths, out, layer, L, N, B, H, page, P, D, sm_scale,
    # splits, fault, stream (csrc/paged_decode_q.cu)
    "lhrs_paged_decode_q": [_P] * 12 + [_I] * 8 + [ctypes.c_float, _I, _I,
                                                   _P],
    # D, splits, count (int*)
    "lhrs_paged_decode_q_max_clusters": [_I, _I, _P],
    # xq_lo, xq_hi, x_scale, w (layer slice), w_scale (layer slice), out,
    # B, K2, N, x_stride, cluster, chunk, out_f32, fault, stream
    "lhrs_w4a8_matmul": [_P] * 6 + [_I] * 8 + [_P],
    # x, x_f32, w, w_scale, out, B, K2, N, x_stride, cluster, chunk,
    # out_f32, fault, stream
    "lhrs_w4a8_project": [_P, _I, _P, _P, _P] + [_I] * 8 + [_P],
    # fused, x_f32, B, K2, N, cluster, chunk, count (int*)
    "lhrs_w4a8_max_clusters": [_I] * 7 + [_P],
    # x, x_f32, x_stride, gamma, beta, q, s, M, W, lanes, chunks, eps, stream
    "lhrs_ln_quant": [_P, _I, _L, _P, _P, _P, _P, _I, _I, _I, _I,
                      ctypes.c_float, _P],
    # A, lda, Wt, x_scale, w_scale, bias, residual, res_f32, ws_first,
    # q_fold, n_fold, round_mid, out_mult, act, out_kind, out, M, N, K,
    # stream
    "lhrs_int8_gemm": [_P, _L, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float,
                       _I, _I, ctypes.c_float, _I, _I, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "lhrs_bot_tpu_torch are built on the machine with "
                       "the card, from the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library of the current sources goes: a directory named by
    the hash of the flags and of every source and header, so that editing
    any of them (a header included by several sources too) rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "liblhrs_kernels.so"


def build() -> Path:
    """Compile the sources if their library is missing; returns its path.
    The compiler's output, register and shared-memory use included, is kept
    in `build.log` beside the library."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log, procs, objs = [], [], []
    for src in _sources():
        objs.append(str(so.parent / (src.stem + ".o")))
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{out}")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
    (so.parent / "build.log").write_text("".join(log))
    if failed:
        os.unlink(tmp)
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entries."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
