"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/<name>-<hash>.so`` at
the repository root, keyed by a hash of the source and the shared
headers (``csrc/*.cuh``), and loaded with
``ctypes``.  The build happens at first use (:func:`load`) or for all
kernels at once, one ``nvcc`` per source started together
(:func:`build_all`); :func:`start_all` starts those ``nvcc`` runs and
returns at once, so a caller works on while they compile, and the next
:func:`build_all` or :func:`load` waits for them (:func:`stop_all` ends
the ones a failed caller leaves).  A failed build raises
:class:`KernelError`; nothing falls back.
:func:`sass_counts` counts instructions in a built library's machine
code, which shows whether a kernel reached the tensor cores.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import signal
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("quant_matmul", "paged_attention", "block_sparse", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_RUNNING: Dict[str, tuple] = {}      # nvcc runs started by start_all, not yet waited for
_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch, or its
    wrapper refused its inputs.  Callers that serve around other faults
    (the scheduler's quarantine) let this one through."""


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(f"{name} not found: the CUDA kernels build only where the "
                      "CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built;
    returns (target, temp path, process) or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    # the log goes to a file: a pipe nobody reads while nvcc runs could fill
    with open(target.with_suffix(".log"), "w") as log:
        # a session of its own: stop_all ends nvcc with the cicc and ptxas it runs
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return target, tmp, proc


def _finish(name: str, started) -> str:
    """Wait for a build started by :func:`_start`; returns nvcc's log."""
    log_path = _target(name).with_suffix(".log")
    if started is None:
        return log_path.read_text() if log_path.exists() else ""
    target, tmp, proc = started
    proc.wait()
    log = log_path.read_text()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, target)
    return log


def _wait(name: str) -> str:
    """Finish ``name``'s build, started by :func:`start_all` or now (the
    caller holds ``_LOCK``); returns nvcc's log."""
    started = _RUNNING.pop(name, None)
    return _finish(name, started if started is not None else _start(name))


def start_all(names: List[str] = KERNELS) -> None:
    """Start one nvcc per source not built yet, all together, and return
    at once; :func:`build_all` or :func:`load` waits for them."""
    with _LOCK:
        for n in names:
            if n not in _RUNNING and n not in _LIBS:
                started = _start(n)
                if started is not None:
                    _RUNNING[n] = started


def stop_all() -> None:
    """Kill the nvcc runs :func:`start_all` started that nobody waited for."""
    with _LOCK:
        for _, tmp, proc in _RUNNING.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            tmp.unlink(missing_ok=True)
        _RUNNING.clear()


def build_all(names: List[str] = KERNELS) -> Dict[str, str]:
    """Build every kernel, one nvcc per source, all started together;
    returns {name: compiler log (registers, shared memory, spills)}."""
    start_all(names)
    with _LOCK:
        return {n: _wait(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _wait(name)
            try:
                lib = ctypes.CDLL(str(_target(name)))
            except OSError as e:
                raise KernelError(f"{name}: cannot load {_target(name)}: {e}") from e
            _LIBS[name] = lib
        return lib


def sass_counts(name: str, opcodes=("HGMMA", "HMMA")) -> Dict[str, int]:
    """How many instructions of each opcode the built library of kernel
    ``name`` holds, from ``cuobjdump -sass`` (HGMMA: wgmma, HMMA: mma.sync
    on the tensor cores)."""
    load(name)
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(_target(name))], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}
