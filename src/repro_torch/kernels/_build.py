"""Build and load the port's hand-written CUDA kernels.

Each source ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface
and becomes its own shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

The library is built at first use into ``build/repro_torch/`` at the root of
the checkout (listed in ``.gitignore``), keyed by a hash of the source, every
local header it includes (``#include "x.cuh"``, followed recursively) and the
flags, so a stale library is never loaded; it is loaded with `ctypes`
(pointers and the stream as ``c_void_p``).  No PyTorch header is compiled,
so a build takes seconds.
`build_all` compiles every source in parallel — one nvcc per source, all
started together — and returns each compiler's ``-Xptxas -v`` report.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
ptxas_reports: Dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the exported entry points (see the .cu files)
_SIGNATURES = {
    "flash_prefill": {
        "repro_flash_prefill": (
            [_P] * 5 + [_I] + [_P] * 6 + [_I] * 9 + [_F, _F, _I, _P]
        ),
        "repro_flash_prefill_error_string": [_I],
    },
    "paged_decode": {
        "repro_paged_decode": [_P] * 11 + [_I] * 12 + [_F, _F, _P],
        "repro_paged_decode_merge": [_P] * 4 + [_I] * 4 + [_P],
        "repro_paged_decode_error_string": [_I],
    },
    "striped_attention": {
        "repro_striped_attention": [_P] * 6 + [_I] * 9 + [_F, _F, _P],
        "repro_striped_attention_error_string": [_I],
    },
    "flash_decode": {
        "repro_flash_decode": [_P] * 8 + [_I] * 12 + [_F, _F, _P],
        "repro_flash_decode_merge": [_P] * 4 + [_I] * 4 + [_P],
        "repro_flash_decode_error_string": [_I],
    },
}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_files(src: Path) -> List[Path]:
    """`src` and every local header it reaches through quoted includes
    (resolved next to the including file, as nvcc does), sorted."""
    seen, todo = set(), [src.resolve()]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for inc in _INCLUDE.findall(p.read_bytes()):
            cand = (p.parent / inc.decode()).resolve()
            if cand.is_file():
                todo.append(cand)
    return sorted(seen)


def source_key(src: Path) -> str:
    """Build key of one source: a hash of its text, the text of every local
    header it includes, and the flags."""
    h = hashlib.sha256()
    for p in source_files(src):
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_key(CSRC / f'{name}.cu')}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    report, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{report}")
    os.replace(tmp, out)  # atomic: a half-written library is never loaded
    ptxas_reports[name] = report


def build_all() -> Dict[str, str]:
    """Compile every csrc/*.cu in parallel (skipping ones already built) and
    load them; returns {name: ptxas report} for the sources built now."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    for n in names:
        load_library(n)
    return {n: ptxas_reports.get(n, "(already built)") for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    started = _start(name)
    if started is not None:
        _finish(name, started)
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_char_p if fn.endswith("error_string") else ctypes.c_int
    _LIBS[name] = lib
    return lib


def ptr(t) -> int | None:
    """Device pointer of a tensor for a c_void_p argument (None = NULL)."""
    return None if t is None else t.data_ptr()


def check(lib: ctypes.CDLL, fn: str, err: int, stage: str = "") -> None:
    """Raise on a nonzero cudaError_t returned by an entry point of
    csrc/<fn>.cu (``stage`` names which, where it has several): a refused
    launch never runs, and a later synchronize would not report it."""
    if err != 0:
        msg = getattr(lib, f"repro_{fn}_error_string")(err).decode()
        what = f"{fn} {stage}" if stage else fn
        raise RuntimeError(f"CUDA kernel {what}: error {err} ({msg})")

