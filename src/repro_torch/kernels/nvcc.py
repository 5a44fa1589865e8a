"""Build and bind the hand-written CUDA kernels of every wrapper.

At first use ``nvcc`` compiles a source in this checkout for
``sm_90a`` into a shared library with a plain C interface under
``build/repro_torch/`` (named by the source's hash, so an edited source
is rebuilt), and ``ctypes`` binds it.  Nothing is compiled when a module
is imported.  The C interface of ``csrc/<stem>.cu`` exports
``<stem>_error_string``; each entry point takes pointers, then ints,
then the stream, and returns a CUDA error code; a lean entry takes one
pointer to a structure of them (:func:`_entry_struct`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class Library:
    """One loaded kernel library and what its build printed.  The C
    interface of ``csrc/<stem>.cu`` exports ``<stem>_error_string``."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str,
                 seconds: float, stem: str):
        self.lib, self.path, self.log, self.seconds = lib, path, log, seconds
        self._error_string = getattr(lib, f"{stem}_error_string")
        self._error_string.argtypes = [ctypes.c_int]
        self._error_string.restype = ctypes.c_char_p
        self._bound: dict[str, object] = {}

    def bind(self, name: str, n_pointers: int, n_ints: int):
        """The C function ``name`` taking ``n_pointers`` pointers, then
        ``n_ints`` ints, then the stream, and returning a CUDA error
        code."""
        if name not in self._bound:
            fn = getattr(self.lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_pointers
                           + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._bound[name] = fn
        return self._bound[name]

    def bind_struct(self, name: str, struct: type):
        """The C function ``name`` taking a pointer to one ``struct``
        (a ``ctypes.Structure``) and returning a CUDA error code."""
        if name not in self._bound:
            fn = getattr(self.lib, name)
            fn.argtypes = [ctypes.POINTER(struct)]
            fn.restype = ctypes.c_int
            self._bound[name] = fn
        return self._bound[name]

    def error_string(self, code: int) -> str:
        return self._error_string(code).decode()


_LIBRARIES: dict[Path, Library] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "their csrc/*.cu sources at first use and "
                           "need the CUDA toolkit")
    return found


def cuobjdump() -> str:
    """The ``cuobjdump`` of the toolkit whose ``nvcc`` builds the
    kernels; raises where that toolkit has none."""
    found = os.path.join(os.path.dirname(os.path.realpath(_nvcc())),
                         "cuobjdump")
    if not os.path.exists(found):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({found})")
    return found


def parse_resource_usage(text: str) -> dict[str, dict[str, int]]:
    """``cuobjdump --dump-resource-usage``'s report as ``{function:
    {"REG": n, "STACK": n, "SHARED": n, "LOCAL": n, ...}}``."""
    usage: dict[str, dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        head = re.match(r"\s*Function (\S+?):?\s*$", line)
        if head:
            name = head.group(1)
        elif name is not None and "REG:" in line:
            usage[name] = {k: int(v) for k, v in
                           re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line)}
            name = None
    return usage


def parse_ptxas_spills(log: str) -> dict[str, dict[str, int]]:
    """``ptxas -v``'s function properties in a build log as ``{function:
    {"stack": bytes, "spill_stores": bytes, "spill_loads": bytes}}``."""
    spills: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        head = re.search(r"Function properties for (\S+)", line)
        if head:
            name = head.group(1)
            continue
        props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if name is not None and props:
            spills[name] = dict(zip(("stack", "spill_stores",
                                     "spill_loads"),
                                    map(int, props.groups())))
            name = None
    return spills


def resource_usage(lib: Library) -> dict[str, dict[str, int]]:
    """Each kernel's registers, shared memory (static) and local memory
    (spills) in a built library, read by :func:`cuobjdump`."""
    proc = subprocess.run([cuobjdump(), "--dump-resource-usage",
                           str(lib.path)], capture_output=True, text=True,
                          check=True)
    return parse_resource_usage(proc.stdout)


def build_many(sources) -> list[Library]:
    """Compile (once per process and source) and load kernel libraries,
    one ``nvcc`` per source, all started together; raises with the
    compiler's output if a build fails."""
    todo = {}
    for source in sources:
        source = Path(source)
        if source in _LIBRARIES or source in todo:
            continue
        src = source.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                 str(source)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo[source] = (proc, tmp,
                        BUILD_DIR / f"{source.stem}-{digest}.so",
                        time.perf_counter())
    # wait for every compiler before loading or raising
    logs = {source: job[0].communicate()[0] for source, job in todo.items()}
    failed = []
    for source, (proc, tmp, target, t0) in todo.items():
        log = logs[source]
        try:
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on "
                              f"{source}:\n{log}")
                continue
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _LIBRARIES[source] = Library(ctypes.CDLL(str(target)), target, log,
                                     time.perf_counter() - t0, source.stem)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_LIBRARIES[Path(s)] for s in sources]


def build(source: Path) -> Library:
    """Compile (once per process) and load one kernel library."""
    return build_many([source])[0]


@lru_cache(maxsize=None)
def _entry(source: Path, name: str, n_pointers: int, n_ints: int):
    """``(library, bound C function)``, built and bound once per
    process: a launch then spends no host time on either."""
    lib = build(source)
    return lib, lib.bind(name, n_pointers, n_ints)


@lru_cache(maxsize=None)
def _entry_struct(source: Path, name: str, struct: type):
    """``(library, bound C function)`` of a lean entry, built and bound
    once per process."""
    lib = build(source)
    return lib, lib.bind_struct(name, struct)
