"""Build and load the port's CUDA kernels.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc -c`` per source, all started together) and linked into ONE
shared library with a plain C interface under ``build/repro_torch/`` at
the repository root.  Headers they share (``kernels/csrc/*.cuh``) are
included, not compiled.  The file name carries a hash of the flags and
of every ``.cu`` and ``.cuh`` under the kernels, so a stale build (after
an edit to a source or to a header) is never loaded.  The build runs at
first use (``library()``), never at import: the CPU tests import every
module on machines without ``nvcc``.

Each C entry point takes device pointers as ``void*``, ints, and the
stream from ``torch.cuda.current_stream().cuda_stream``, and returns
``cudaGetLastError()``; ``check()`` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every entry point: name -> argtypes (restype is int)
SIGNATURES = {
    # buf, ids, out, m, row_bytes, n_rows, bad, stream
    "gather_blocks_launch": [_P, _P, _P, _L, _L, _L, _P, _P],
    # q, codes, scales, part_d, part_i, out_d, out_i,
    # B, D, group, n_valid, k, n_chunks, stream
    "quant_topk_launch": [_P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P],
    # q, x, part_d, part_i, out_d, out_i, B, D, n_valid, k, n_chunks, stream
    "distance_topk_launch": [_P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
    # q, k, v, pos, part_ml, part_acc, out,
    # B, S, K, G, hd, n_split, split_len, bf16, stream
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def sources(kernels_dir: Path = KERNELS_DIR) -> list[Path]:
    """Every CUDA source the library is built from, in a fixed order."""
    return sorted(kernels_dir.glob("*/csrc/*.cu"))


def hashed_files(kernels_dir: Path = KERNELS_DIR) -> list[Path]:
    """Every file the library depends on: the sources and the headers
    they include, in a fixed order."""
    return sorted(p for p in kernels_dir.rglob("*")
                  if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    return found


def library_path(kernels_dir: Path = KERNELS_DIR) -> Path:
    """Where the library for the current sources and headers lives (built
    or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in hashed_files(kernels_dir):
        h.update(src.relative_to(kernels_dir).as_posix().encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link the library, unless the
    library for these exact sources exists.  Raises on any failure; the
    compiler's output is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if not failed:
            so = Path(tmp) / out.name
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(so),
                 *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        out.with_suffix(".log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        os.replace(so, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
