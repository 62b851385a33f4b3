"""Device resolution, kernel build/load and launch counters.

Counterpart of ``repro/kernels/runtime.py``. The reference resolves whether
a Pallas kernel runs in interpret mode and probes interpret-mode DMA
support; here the questions are which device an entry point runs on and
whether the hand-written CUDA kernels are built.

* ``resolve_device`` — entry points default to ``"cuda"``; without a card
  that raises. Nothing drops to the CPU on its own: the CPU runs only when
  the caller asks for it (``device="cpu"``, as the tests do).
* ``build`` / ``load`` — each ``csrc/*.cu`` source is compiled by ``nvcc``
  for ``sm_90a`` into its own shared library with a plain C interface,
  loaded with ``ctypes``. The library is named by a hash of the sources
  and flags, so a stale build is never loaded. ``build`` starts one
  ``nvcc`` per source, all at once.
* ``LAUNCHES`` — one counter per kernel, and one per branch that runs
  its own instantiation (``BRANCHES``: the quantized tier's). A wrapper
  adds one where it launches its kernel and nowhere else; a launch of a
  branch counts for the branch and for its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# kernel name -> source file under csrc/ (headers in csrc/ are hashed too)
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "chunked_prefill": "chunked_prefill.cu",
    "farview_summarize": "farview_summarize.cu",
    "prefill_flash": "prefill_flash.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel branches counted on their own (each also counts as its kernel)
BRANCHES = ("paged_decode_quant", "chunked_prefill_quant")

LAUNCHES: Dict[str, int] = {name: 0 for name in (*SOURCES, *BRANCHES)}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=None) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns name -> compiler
    log (``-Xptxas -v`` prints registers, shared memory and spills)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        log.write_text(text)
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check_status(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
